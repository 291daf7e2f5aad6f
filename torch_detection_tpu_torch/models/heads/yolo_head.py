"""YOLOv3's head.

Counterpart of ``torch_detection_tpu/models/heads/yolo_head.py``: for each
neck map (coarse to fine) a 3 x 3 ``bridge{l}`` ``ConvModule`` (norm,
LeakyReLU) and a biased 1 x 1 ``pred{l}`` to A * (5 + C) channels, per
anchor [tx, ty, tw, th, objectness, C class logits]. The seeded init gives
each objectness bias the 0.01 prior (``bias_init_with_prob``) and every
other bias 0. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import HEADS
from ..inits import bias_init_with_prob
from ..layers import ConvModule


@HEADS.register_module
class YOLOV3Head(nn.Module):
    """Per level: (B, H, W, A * (5 + C)) raw prediction maps."""

    def __init__(
        self,
        num_classes: int = 80,
        in_channels: Sequence[int] = (512, 256, 128),
        out_channels: Sequence[int] = (1024, 512, 256),
        anchors_per_level: int = 3,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        norm = dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}
        self.num_levels = len(in_channels)
        c5 = 5 + num_classes
        # the objectness channel of each anchor's 5 + C slot has the prior
        prior = torch.zeros(anchors_per_level * c5)
        prior[4::c5] = bias_init_with_prob(0.01)
        for lvl, (cin, mid) in enumerate(zip(in_channels, out_channels)):
            self.add_module(f"bridge{lvl}", ConvModule(cin, mid, 3, padding=1, norm_cfg=norm,
                                                       act="leaky_relu", dtype=dtype,
                                                       device=device))
            pred = nn.Conv2d(mid, anchors_per_level * c5, 1, dtype=dtype, device=device)
            pred.init_bias = prior
            self.add_module(f"pred{lvl}", pred)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        if len(feats) != self.num_levels:
            raise ValueError(f"{len(feats)} maps for {self.num_levels} levels")
        return tuple(getattr(self, f"pred{lvl}")(getattr(self, f"bridge{lvl}")(
            f.permute(0, 3, 1, 2))).permute(0, 2, 3, 1) for lvl, f in enumerate(feats))
