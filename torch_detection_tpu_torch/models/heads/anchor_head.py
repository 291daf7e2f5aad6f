"""Anchor-based dense detection head (RetinaNet).

Counterpart of ``torch_detection_tpu/models/heads/anchor_head.py``: a
classification tower and a regression tower of 3x3 convs with ReLU, each
ending in a 3x3 output conv, one set of parameters applied to every pyramid
level. Submodules keep the reference's names (``cls_conv{i}``,
``reg_conv{i}``, ``cls_out``, ``reg_out``). NHWC in and out; NCHW
channels_last inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import HEADS
from ..inits import bias_init_with_prob
from ..layers import ConvModule


@HEADS.register_module
class RetinaHead(nn.Module):
    """Per level: cls (B, H, W, A * num_classes) logits and reg
    (B, H, W, A * 4) deltas. ``num_classes`` counts the foreground classes
    (a sigmoid head, no background column)."""

    def __init__(
        self,
        num_classes: int,
        in_channels: int = 256,
        feat_channels: int = 256,
        stacked_convs: int = 4,
        num_base_anchors: int = 9,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.stacked_convs = stacked_convs
        kw = dict(dtype=dtype, device=device)
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                self.add_module(f"{tower}_conv{i}",
                                ConvModule(cin, feat_channels, 3, padding=1, act="relu", **kw))
        self.cls_out = nn.Conv2d(feat_channels, num_base_anchors * num_classes, 3, padding=1, **kw)
        self.reg_out = nn.Conv2d(feat_channels, num_base_anchors * 4, 3, padding=1, **kw)
        # the reference's initialisers: normal(0.01) kernels, the focal-loss
        # prior on the classification bias (``inits.init_weights`` reads them)
        self.cls_out.init_std = self.reg_out.init_std = 0.01
        self.cls_out.init_bias = bias_init_with_prob(0.01)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        cls_scores, bbox_preds = [], []
        for feat in feats:
            c = r = feat.permute(0, 3, 1, 2)
            for i in range(self.stacked_convs):
                c = getattr(self, f"cls_conv{i}")(c)
                r = getattr(self, f"reg_conv{i}")(r)
            cls_scores.append(self.cls_out(c).permute(0, 2, 3, 1))
            bbox_preds.append(self.reg_out(r).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds)


def flatten_head_outputs(
    cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor], num_classes: int
) -> Tuple[Tensor, Tensor]:
    """Per-level (B, H, W, A*C) / (B, H, W, A*4) -> (B, sum HWA, C) /
    (B, sum HWA, 4), anchor-major in the order of
    ``AnchorGenerator.flat_anchors``; the head's dtype is kept."""
    b = cls_scores[0].shape[0]
    flat_cls = torch.cat([s.reshape(b, -1, num_classes) for s in cls_scores], dim=1)
    flat_reg = torch.cat([p.reshape(b, -1, 4) for p in bbox_preds], dim=1)
    return flat_cls, flat_reg
