"""Cascade Mask R-CNN: Cascade R-CNN plus one FCN mask head a stage.

Counterpart of ``torch_detection_tpu/models/detectors/cascade_mask_rcnn.py``.
In training, stage t's mask head takes the positives-first prefix of stage
t's box slate, ``mask_num_rois`` an image or by default the box sampler's
positive cap (0.25 * 512 = 128): ``sample_rois`` orders a slate by
priority, so the prefix holds every positive, and it needs no assignment and
no draw of its own. At inference the three mask heads run on the same final
detections, through one RoIAlign at ``mask_roi_size``, and their sigmoid
probabilities of the detected class are averaged. Both paths reuse the box
path's one forward of the backbone.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import Tensor

from ...utils.registry import DETECTORS
from ..heads.mask_head import mask_loss, mask_targets_for_rois, select_class
from .cascade_rcnn import (
    CascadeRCNN,
    CascadeRCNNConfig,
    _cascade_rcnn_inference_core,
    _cascade_rcnn_loss_core,
)
from .mask_rcnn import MaskDetections, mask_frame
from .two_stage import Noise, roi_features


@DETECTORS.register_module
class CascadeMaskRCNN(CascadeRCNN):
    """CascadeRCNN + ``mask_head0`` to ``mask_head{S-1}``, as flax names
    them, each built from ``mask_head``."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], rpn_head: Dict[str, Any],
                 bbox_head: Dict[str, Any], mask_head: Dict[str, Any], num_stages: int = 3,
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(backbone, neck, rpn_head, bbox_head, num_stages, dtype, param_dtype,
                         device)
        for t in range(num_stages):
            setattr(self, f"mask_head{t}", self._build_roi_head(mask_head))

    def mask_forward(self, roi_feats: Tensor, stage: int) -> Tensor:
        """Stage ``stage``'s mask head: (B, R, S, S, C) aligned features ->
        (B, R, 2S, 2S, classes) logits."""
        with self._autocast(roi_feats):
            return self.get_submodule(f"mask_head{stage}")(roi_feats)


@dataclasses.dataclass(frozen=True)
class CascadeMaskRCNNConfig(CascadeRCNNConfig):
    mask_size: int = 28  # the head outputs twice the roi feature size (14 -> 28)
    mask_roi_size: int = 14
    mask_loss_weight: float = 1.0
    mask_num_rois: Optional[int] = None  # each stage's mask slate; None: the positive cap


def cascade_mask_rcnn_loss(
    cfg: CascadeMaskRCNNConfig, model: CascadeMaskRCNN, batch: Dict[str, Tensor], noise: Noise
) -> Dict[str, Tensor]:
    """Cascade R-CNN's losses plus one mask loss a stage, unweighted as
    ``loss_s{t}_mask``; ``loss`` weighs each by ``stage_loss_weights[t] *
    mask_loss_weight``. ``batch`` adds ``gt_masks`` (B, G_mask, H, W) uint8,
    as for Mask R-CNN. ``noise`` is called as by ``cascade_rcnn_loss``."""
    losses, feats, slates = _cascade_rcnn_loss_core(cfg, model, batch, noise)
    num = cfg.mask_num_rois or max(int(cfg.rcnn_num_samples * cfg.rcnn_pos_fraction), 1)
    total = losses["loss"]
    for t, slate in enumerate(slates):
        rois, matched = slate.rois[:, :num], slate.matched[:, :num]
        targets = mask_targets_for_rois(batch["gt_masks"], rois, matched, cfg.mask_size)
        logits = model.mask_forward(roi_features(cfg, feats, rois, cfg.mask_roi_size), t)
        loss_mask = mask_loss(logits, targets, slate.labels[:, :num], slate.is_pos[:, :num])
        losses[f"loss_s{t}_mask"] = loss_mask
        total = total + cfg.stage_loss_weights[t] * cfg.mask_loss_weight * loss_mask
    losses["loss"] = total
    return losses


def cascade_mask_rcnn_inference(
    cfg: CascadeMaskRCNNConfig,
    model: CascadeMaskRCNN,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> MaskDetections:
    """Cascade box inference, then the stages' mask heads on the padded
    detections, their probabilities averaged, on one forward of the
    backbone. The mask probabilities of invalid slots are 0."""
    dets, feats = _cascade_rcnn_inference_core(cfg, model, images, img_shapes)
    dets, roi_boxes = mask_frame(dets, scale_factors)
    roi_feats = roi_features(cfg, feats, roi_boxes, cfg.mask_roi_size)
    probs_sum = 0.0
    for t in range(cfg.num_stages):
        logits = select_class(model.mask_forward(roi_feats, t), dets.labels)
        probs_sum = probs_sum + torch.sigmoid(logits.float())
    probs = (probs_sum / cfg.num_stages) * dets.valid[..., None, None]
    return MaskDetections(dets.boxes, dets.scores, dets.labels, dets.valid, probs)
