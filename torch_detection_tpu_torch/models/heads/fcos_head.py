"""FCOS head: GN towers, per-level scales and a centerness branch.

Counterpart of ``torch_detection_tpu/models/heads/fcos_head.py``: a
classification tower and a regression tower of ``ConvModule`` (3x3 conv,
GroupNorm of 32 groups, ReLU), one set of parameters applied to every
pyramid level; ``cls_out`` (the focal-loss prior on its bias) on the
classification tower, ``reg_out`` (4 ltrb distances, multiplied by the
level's learnable ``scales`` entry) and ``ctr_out`` (1 centerness logit) on
the regression tower. Submodules and parameters keep the reference's names
(``cls_tower{i}``, ``reg_tower{i}``, ``cls_out``, ``reg_out``, ``ctr_out``,
``scales``). NHWC in and out; NCHW channels_last inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import HEADS
from ..inits import bias_init_with_prob
from ..layers import ConvModule


class _GNTowers(nn.Module):
    """The two GN towers, ``cls_out``, a ``reg_out`` of ``reg_channels`` and
    the per-level ``scales`` of FCOS, ATSS and GFL (none with
    ``num_levels=0``, as FoveaBox's head). ``scales`` is float32 in every
    build, as flax's parameter, and is cast to the level's dtype before the
    product, as the reference's ``scales[lvl].astype(f.dtype)``."""

    def __init__(self, num_classes: int, in_channels: int, feat_channels: int,
                 stacked_convs: int, reg_channels: int, norm: bool, num_levels: int,
                 dtype: Optional[torch.dtype], device):
        super().__init__()
        self.stacked_convs = stacked_convs
        kw = dict(dtype=dtype, device=device)
        norm_cfg = dict(type="GN") if norm else None
        for tower in ("cls", "reg"):
            for i in range(stacked_convs):
                cin = in_channels if i == 0 else feat_channels
                self.add_module(f"{tower}_tower{i}", ConvModule(
                    cin, feat_channels, 3, padding=1, norm_cfg=norm_cfg, act="relu", **kw))
        self.cls_out = nn.Conv2d(feat_channels, num_classes, 3, padding=1, **kw)
        self.cls_out.init_bias = bias_init_with_prob(0.01)  # read by inits.init_weights
        self.reg_out = nn.Conv2d(feat_channels, reg_channels, 3, padding=1, **kw)
        self.scales = (nn.Parameter(torch.ones(num_levels, dtype=torch.float32, device=device))
                       if num_levels else None)

    def init_own(self, generator: torch.Generator) -> None:
        if self.scales is not None:
            self.scales.data.fill_(1.0)

    def towers(self, level: int, feat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """NHWC level -> (cls logits NHWC, reg NHWC, scaled where the head has
        ``scales``, reg tower NCHW)."""
        c = r = feat.permute(0, 3, 1, 2)
        for i in range(self.stacked_convs):
            c = getattr(self, f"cls_tower{i}")(c)
        for i in range(self.stacked_convs):
            r = getattr(self, f"reg_tower{i}")(r)
        reg = self.reg_out(r)
        if self.scales is not None:
            reg = reg * self.scales[level].to(reg.dtype)
        return self.cls_out(c).permute(0, 2, 3, 1), reg.permute(0, 2, 3, 1), r


@HEADS.register_module
class FCOSHead(_GNTowers):
    """Per level: cls (B, H, W, C) logits, reg (B, H, W, 4) scaled ltrb
    logits (``exp`` at the loss and the decode) and centerness (B, H, W, 1)
    logits."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 stacked_convs: int = 4, norm: bool = True, num_levels: int = 5,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(num_classes, in_channels, feat_channels, stacked_convs, 4, norm,
                         num_levels, dtype, device)
        self.ctr_out = nn.Conv2d(feat_channels, 1, 3, padding=1, dtype=dtype, device=device)

    def forward(self, feats: Sequence[Tensor]
                ) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        if len(feats) != self.scales.shape[0]:
            raise ValueError(f"{len(feats)} levels for {self.scales.shape[0]} scales")
        cls_scores, bbox_preds, centernesses = [], [], []
        for level, feat in enumerate(feats):
            cls, reg, r = self.towers(level, feat)
            cls_scores.append(cls)
            bbox_preds.append(reg)
            centernesses.append(self.ctr_out(r).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(bbox_preds), tuple(centernesses)
