"""YOLOX's PAFPN: CSP top-down and bottom-up path aggregation, SiLU.

Counterpart of ``torch_detection_tpu/models/necks/yolox_pafpn.py``. Top
down, coarse to fine: a 1 x 1 ``reduce{i}``, a nearest 2x upsample, the
concat ``[upsampled, finer]`` and a ``CSPLayer`` without shortcuts
(``td_csp{i - 1}``); bottom up: a 3 x 3 stride-2 ``down{i}``, the concat
``[down, reduced coarse]`` and ``bu_csp{i}``; then a 1 x 1 ``out{i}`` on
every level. The concat orders decide which input channels each converted
kernel sees. Outputs one map a level at the input strides, all
``out_channels`` wide. NHWC in and out; NCHW channels_last inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import NECKS
from ..backbones.csp_darknet import CSPLayer
from ..layers import ConvModule, resize_nearest_2x


@NECKS.register_module
class YOLOXPAFPN(nn.Module):
    """Backbone maps fine to coarse (C3, C4, C5) in, as many out."""

    def __init__(
        self,
        in_channels: Sequence[int] = (128, 256, 512),  # fine -> coarse
        out_channels: int = 128,
        num_csp_blocks: int = 1,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.in_channels = tuple(in_channels)
        n, ch = len(self.in_channels), out_channels
        kw = dict(norm_cfg=dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}, dtype=dtype,
                  device=device)
        for i in range(n - 1, 0, -1):
            # the coarsest level is reduced from the backbone, the others from td_csp{i}
            cin = self.in_channels[i] if i == n - 1 else ch
            self.add_module(f"reduce{i}", ConvModule(cin, ch, 1, act="silu", **kw))
            self.add_module(f"td_csp{i - 1}", CSPLayer(ch + self.in_channels[i - 1], ch,
                                                       num_blocks=num_csp_blocks, shortcut=False,
                                                       **kw))
        for i in range(n - 1):
            self.add_module(f"down{i}", ConvModule(ch, ch, 3, stride=2, padding=1, act="silu",
                                                   **kw))
            self.add_module(f"bu_csp{i}", CSPLayer(2 * ch, ch, num_blocks=num_csp_blocks,
                                                   shortcut=False, **kw))
        for i in range(n):
            self.add_module(f"out{i}", ConvModule(ch, ch, 1, act="silu", **kw))

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        n = len(self.in_channels)
        if len(feats) != n:
            raise ValueError(f"{len(feats)} inputs for {n} levels")
        inner = [f.permute(0, 3, 1, 2) for f in feats]
        for i in range(n - 1, 0, -1):
            inner[i] = getattr(self, f"reduce{i}")(inner[i])
            inner[i - 1] = getattr(self, f"td_csp{i - 1}")(
                torch.cat([resize_nearest_2x(inner[i]), inner[i - 1]], dim=1))
        outs = [inner[0]]
        for i in range(n - 1):
            down = getattr(self, f"down{i}")(outs[-1])
            outs.append(getattr(self, f"bu_csp{i}")(torch.cat([down, inner[i + 1]], dim=1)))
        return tuple(getattr(self, f"out{i}")(o).permute(0, 2, 3, 1) for i, o in enumerate(outs))
