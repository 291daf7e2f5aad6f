"""Feature Pyramid Network and Path-Aggregation FPN.

Counterpart of ``torch_detection_tpu/models/necks/fpn.py``: ``FPN``'s
lateral 1x1 per level, top-down nearest upsample and add, 3x3 smoothing,
and extra levels by stride-2 subsampling (Faster R-CNN) or stride-2 convs
(RetinaNet); ``PAFPN`` adds a bottom-up pass between the smoothing and the
extra levels. Submodules are named ``lateral{i}``, ``fpn{i}``,
``pa_down{i}``, ``pa_out{i}``, ``extra{k}`` as in the reference. NHWC in
and out; NCHW channels_last inside.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import NECKS
from ..layers import ConvModule, max_pool_same_torch, resize_nearest


@NECKS.register_module
class FPN(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: int = 256,
        num_outs: int = 5,
        start_level: int = 0,
        end_level: int = -1,
        add_extra_convs: bool = False,
        extra_convs_on_inputs: bool = True,
        relu_before_extra_convs: bool = False,
        norm_cfg: Optional[dict] = None,
        act: Optional[str] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.in_channels = tuple(in_channels)
        end = len(self.in_channels) if end_level == -1 else end_level
        self.used = list(range(start_level, end))
        if num_outs < len(self.used):
            raise ValueError(f"num_outs {num_outs} < {len(self.used)} used levels")
        self.num_outs = num_outs
        self.add_extra_convs = add_extra_convs
        self.extra_convs_on_inputs = extra_convs_on_inputs
        self.relu_before_extra_convs = relu_before_extra_convs
        kw = dict(norm_cfg=norm_cfg, act=act, dtype=dtype, device=device)
        for i in self.used:
            self.add_module(f"lateral{i}", ConvModule(self.in_channels[i], out_channels, 1, **kw))
        for i in range(len(self.used)):
            self.add_module(f"fpn{i}", ConvModule(out_channels, out_channels, 3, padding=1, **kw))
        if add_extra_convs:
            for k in range(num_outs - len(self.used)):
                cin = (
                    self.in_channels[self.used[-1]]
                    if k == 0 and extra_convs_on_inputs else out_channels
                )
                self.add_module(
                    f"extra{k}", ConvModule(cin, out_channels, 3, stride=2, padding=1, **kw)
                )

    def _pyramid(self, nchw: Sequence[Tensor]) -> List[Tensor]:
        """The laterals, the top-down pass and the 3x3 smoothing."""
        laterals = [getattr(self, f"lateral{i}")(nchw[i]) for i in self.used]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i], laterals[i - 1].shape[2:])
        return [getattr(self, f"fpn{i}")(lat) for i, lat in enumerate(laterals)]

    def _with_extra_levels(self, nchw: Sequence[Tensor], outs: List[Tensor]) -> Tuple[Tensor, ...]:
        """``outs`` and the extra levels up to ``num_outs``, NHWC; the first
        extra conv reads the last used input where ``extra_convs_on_inputs``,
        else the last of ``outs``."""
        extra = self.num_outs - len(outs)
        if extra > 0 and not self.add_extra_convs:
            for _ in range(extra):
                outs.append(max_pool_same_torch(outs[-1], window=1, stride=2, padding=0))
        elif extra > 0:
            source = nchw[self.used[-1]] if self.extra_convs_on_inputs else outs[-1]
            for k in range(extra):
                if k > 0:
                    source = F.relu(outs[-1]) if self.relu_before_extra_convs else outs[-1]
                outs.append(getattr(self, f"extra{k}")(source))
        return tuple(o.permute(0, 2, 3, 1) for o in outs)

    def _nchw(self, inputs: Sequence[Tensor]) -> List[Tensor]:
        if len(inputs) != len(self.in_channels):
            raise ValueError(f"{len(inputs)} inputs for {len(self.in_channels)} levels")
        return [x.permute(0, 3, 1, 2) for x in inputs]

    def forward(self, inputs: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        """NHWC inputs per level -> ``num_outs`` NHWC outputs."""
        nchw = self._nchw(inputs)
        return self._with_extra_levels(nchw, self._pyramid(nchw))


@NECKS.register_module
class PAFPN(FPN):
    """Path-Aggregation FPN: after ``FPN``'s smoothing, a bottom-up pass
    ``N_0 = P_0``, ``N_i = pa_out{i}(P_i + pa_down{i}(N_{i-1}))`` (3x3
    stride 2, then 3x3), then the extra levels as ``FPN``'s, from the input
    or from ``N_last``."""

    def __init__(self, in_channels: Sequence[int], out_channels: int = 256, **kwargs):
        super().__init__(in_channels, out_channels, **kwargs)
        kw = dict(norm_cfg=kwargs.get("norm_cfg"), act=kwargs.get("act"),
                  dtype=kwargs.get("dtype"), device=kwargs.get("device"))
        for i in range(1, len(self.used)):
            self.add_module(f"pa_down{i}", ConvModule(out_channels, out_channels, 3, stride=2,
                                                      padding=1, **kw))
            self.add_module(f"pa_out{i}", ConvModule(out_channels, out_channels, 3, padding=1,
                                                     **kw))

    def forward(self, inputs: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        nchw = self._nchw(inputs)
        fpn_outs = self._pyramid(nchw)
        outs = fpn_outs[:1]
        for i in range(1, len(fpn_outs)):
            down = getattr(self, f"pa_down{i}")(outs[-1])
            outs.append(getattr(self, f"pa_out{i}")(fpn_outs[i] + down))
        return self._with_extra_levels(nchw, outs)
