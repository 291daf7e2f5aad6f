"""GFL head: GN towers, per-level scales, a distribution over each side.

Counterpart of ``torch_detection_tpu/models/heads/gfl_head.py``: FCOS's
towers and ``scales``; ``reg_out`` gives 4 x (reg_max + 1) logits, a
distribution over ``reg_max + 1`` bins for each ltrb side, and there is no
centerness branch (the classification score is the localisation quality).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from ...utils.registry import HEADS
from .fcos_head import _GNTowers


@HEADS.register_module
class GFLHead(_GNTowers):
    """Per level: cls (B, H, W, C) logits and reg (B, H, W, 4 (reg_max + 1))
    scaled bin logits."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, reg_max: int = 16, norm: bool = True,
                 num_levels: int = 5, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(num_classes, in_channels, feat_channels, stacked_convs,
                         4 * (reg_max + 1), norm, num_levels, dtype, device)
        self.reg_max = reg_max

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        if len(feats) != self.scales.shape[0]:
            raise ValueError(f"{len(feats)} levels for {self.scales.shape[0]} scales")
        cls_scores, bbox_preds = [], []
        for level, feat in enumerate(feats):
            cls, reg, _ = self.towers(level, feat)
            cls_scores.append(cls)
            bbox_preds.append(reg)
        return tuple(cls_scores), tuple(bbox_preds)
