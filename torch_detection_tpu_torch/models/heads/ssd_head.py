"""SSD's multibox head.

Counterpart of ``torch_detection_tpu/models/heads/ssd_head.py``: for each
level l a 3 x 3 ``cls_conv{l}`` to A_l * (C + 1) logits (softmax over the
classes, background 0) and a 3 x 3 ``reg_conv{l}`` to A_l * 4 deltas; the
weights are a level's own, since the levels' widths differ. NHWC in and
out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import HEADS


@HEADS.register_module
class SSDHead(nn.Module):
    """Per level: cls (B, H, W, A_l * (C + 1)) and reg (B, H, W, A_l * 4).
    ``num_classes`` counts the foreground classes."""

    def __init__(
        self,
        num_classes: int = 80,
        in_channels: Sequence[int] = (512, 1024, 512, 256, 256, 256),
        anchors_per_level: Sequence[int] = (4, 6, 6, 6, 4, 4),
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if len(in_channels) != len(anchors_per_level):
            raise ValueError(f"{len(in_channels)} levels' widths for {len(anchors_per_level)} "
                             "levels' anchor counts")
        self.num_levels = len(anchors_per_level)
        kw = dict(dtype=dtype, device=device)
        for lvl, (cin, a) in enumerate(zip(in_channels, anchors_per_level)):
            self.add_module(f"cls_conv{lvl}", nn.Conv2d(cin, a * (num_classes + 1), 3, padding=1,
                                                        **kw))
            self.add_module(f"reg_conv{lvl}", nn.Conv2d(cin, a * 4, 3, padding=1, **kw))

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        if len(feats) != self.num_levels:
            raise ValueError(f"{len(feats)} maps for {self.num_levels} levels")
        cls_out, reg_out = [], []
        for lvl, f in enumerate(feats):
            x = f.permute(0, 3, 1, 2)
            cls_out.append(getattr(self, f"cls_conv{lvl}")(x).permute(0, 2, 3, 1))
            reg_out.append(getattr(self, f"reg_conv{lvl}")(x).permute(0, 2, 3, 1))
        return tuple(cls_out), tuple(reg_out)
