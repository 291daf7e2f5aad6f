"""R-CNN second-stage box head: 2 shared FCs -> softmax cls + box deltas.

Counterpart of ``torch_detection_tpu/models/heads/bbox_head.py``. RoI
features arrive as (B, R, S, S, C) and flatten in (S, S, C) order, as in
the reference, so fc1's weight converts without a permutation. Class 0 is
background.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import HEADS


@HEADS.register_module
class BBoxHead(nn.Module):
    def __init__(self, num_classes: int, fc_channels: int = 1024, reg_class_agnostic: bool = True,
                 in_channels: int = 256, roi_size: int = 7, dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.roi_size = roi_size
        self.fc1 = nn.Linear(roi_size * roi_size * in_channels, fc_channels, **kw)
        self.fc2 = nn.Linear(fc_channels, fc_channels, **kw)
        self.cls = nn.Linear(fc_channels, num_classes + 1, **kw)
        self.reg = nn.Linear(fc_channels, 4 if reg_class_agnostic else 4 * num_classes, **kw)

    def forward(self, roi_feats: Tensor) -> Tuple[Tensor, Tensor]:
        """(B, R, S, S, C) -> (cls_logits (B, R, C+1), deltas (B, R, 4 or 4C))."""
        b, r = roi_feats.shape[:2]
        x = roi_feats.reshape(b * r, -1)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.cls(x).reshape(b, r, -1), self.reg(x).reshape(b, r, -1)
