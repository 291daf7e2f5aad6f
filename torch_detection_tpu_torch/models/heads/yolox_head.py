"""YOLOX's decoupled head.

Counterpart of ``torch_detection_tpu/models/heads/yolox_head.py``: each
level has parameters of its own, a 1 x 1 ``stem{l}``, a classification
tower ``cls_tower{l}_{i}`` and a regression tower ``reg_tower{l}_{i}``
(3 x 3 ``ConvModule``s with FrozenBN and SiLU), then biased 1 x 1 outputs:
``cls_out{l}`` (C logits) on the classification tower, ``reg_out{l}`` (4:
the centre's offset in the cell and log wh, in stride units) and
``obj_out{l}`` (1 objectness logit) on the regression tower. The seeded
init gives ``cls_out`` and ``obj_out`` the 0.01 prior bias
(``bias_init_with_prob``) and ``reg_out`` 0. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import HEADS
from ..inits import bias_init_with_prob
from ..layers import ConvModule


@HEADS.register_module
class YOLOXHead(nn.Module):
    """Per level: (B, H, W, C) class logits, (B, H, W, 4) box values and
    (B, H, W, 1) objectness logits."""

    def __init__(
        self,
        num_classes: int = 80,
        in_channels: int = 128,
        feat_channels: int = 128,
        stacked_convs: int = 2,
        num_levels: int = 3,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        kw = dict(norm_cfg=dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}, act="silu",
                  dtype=dtype, device=device)
        self.num_levels, self.stacked_convs = num_levels, stacked_convs
        prior = bias_init_with_prob(0.01)
        for lvl in range(num_levels):
            self.add_module(f"stem{lvl}", ConvModule(in_channels, feat_channels, 1, **kw))
            for tower in ("cls", "reg"):
                for i in range(stacked_convs):
                    self.add_module(f"{tower}_tower{lvl}_{i}", ConvModule(
                        feat_channels, feat_channels, 3, padding=1, **kw))
            for name, width in (("cls_out", num_classes), ("reg_out", 4), ("obj_out", 1)):
                conv = nn.Conv2d(feat_channels, width, 1, dtype=dtype, device=device)
                if name != "reg_out":
                    conv.init_bias = prior  # read by inits.init_weights
                self.add_module(f"{name}{lvl}", conv)

    def forward(self, feats: Sequence[Tensor]
                ) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        if len(feats) != self.num_levels:
            raise ValueError(f"{len(feats)} maps for {self.num_levels} levels")
        cls_scores, bbox_preds, objectnesses = [], [], []
        for lvl, feat in enumerate(feats):
            c = r = getattr(self, f"stem{lvl}")(feat.permute(0, 3, 1, 2))
            for i in range(self.stacked_convs):
                c = getattr(self, f"cls_tower{lvl}_{i}")(c)
                r = getattr(self, f"reg_tower{lvl}_{i}")(r)
            cls_scores.append(getattr(self, f"cls_out{lvl}")(c).permute(0, 2, 3, 1))
            bbox_preds.append(getattr(self, f"reg_out{lvl}")(r).permute(0, 2, 3, 1))
            objectnesses.append(getattr(self, f"obj_out{lvl}")(r).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds), tuple(objectnesses)
