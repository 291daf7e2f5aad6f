"""CenterNet's deconvolution neck: C5 to one stride-4 map.

Counterpart of ``torch_detection_tpu/models/necks/ct_neck.py``: for each
of ``num_deconv_filters`` a 3 x 3 ``ConvModule`` (``reduce{i}``, FrozenBN,
ReLU), a 4 x 4 stride-2 transposed conv without bias (``up{i}``), its
FrozenBN (``up_norm{i}``) and a ReLU. flax's ``ConvTranspose(padding=
"SAME")`` at stride 2 is ``ConvTranspose2d(..., stride=2, padding=1)`` on
the spatially flipped kernel, which ``models/convert.py`` flips. Returns a
1-tuple, the detectors' sequence of levels. NHWC in and out; NCHW
channels_last inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import NECKS
from ..layers import ConvModule, build_norm


@NECKS.register_module
class CTResNetNeck(nn.Module):
    """The backbone's last map in, (B, 8H, 8W, num_deconv_filters[-1]) out."""

    def __init__(
        self,
        in_channels: int = 512,
        num_deconv_filters: Sequence[int] = (256, 128, 64),
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        norm = dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}
        self.num_stages = len(num_deconv_filters)
        cin = in_channels
        for i, ch in enumerate(num_deconv_filters):
            self.add_module(f"reduce{i}", ConvModule(cin, ch, 3, padding=1, norm_cfg=norm,
                                                     act="relu", dtype=dtype, device=device))
            self.add_module(f"up{i}", nn.ConvTranspose2d(ch, ch, 4, stride=2, padding=1,
                                                         bias=False, dtype=dtype, device=device))
            self.add_module(f"up_norm{i}", build_norm(norm, ch, device))
            cin = ch

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor]:
        x = feats[-1].permute(0, 3, 1, 2)
        for i in range(self.num_stages):
            x = getattr(self, f"up{i}")(getattr(self, f"reduce{i}")(x))
            x = F.relu(getattr(self, f"up_norm{i}")(x))
        return (x.permute(0, 2, 3, 1),)
