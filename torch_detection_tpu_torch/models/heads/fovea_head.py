"""FoveaBox head: GN towers, a class branch and a log-space box branch.

Counterpart of ``torch_detection_tpu/models/heads/fovea_head.py``: FCOS's
``cls_tower{i}`` and ``reg_tower{i}`` (3x3 conv, GroupNorm of 32 groups,
ReLU), ``cls_out`` with the focal-loss prior on its bias and a 4-channel
``reg_out`` of log-space offsets against each level's ``base_edge``. There
are no per-level ``scales`` and no centerness branch, so the state dict is
the flax tree's exactly. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor

from ...utils.registry import HEADS
from .fcos_head import _GNTowers


@HEADS.register_module
class FoveaHead(_GNTowers):
    """Per level: cls (B, H, W, C) logits and reg (B, H, W, 4) log-space
    offsets (``models/detectors/foveabox.py`` decodes them)."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, norm: bool = True, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(num_classes, in_channels, feat_channels, stacked_convs, 4, norm, 0,
                         dtype, device)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        cls_scores, bbox_preds = [], []
        for level, feat in enumerate(feats):
            cls, reg, _ = self.towers(level, feat)
            cls_scores.append(cls)
            bbox_preds.append(reg)
        return tuple(cls_scores), tuple(bbox_preds)
