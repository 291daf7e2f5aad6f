"""Mask R-CNN: Faster R-CNN plus the FCN mask branch.

Counterpart of ``torch_detection_tpu/models/detectors/mask_rcnn.py``.
Shapes stay fixed: in training the mask branch samples its own slate of
positive rois (the box sampler's positive cap an image, 0.25 * 512 = 128)
and crops their targets from the padded (B, G, H, W) gt masks; at inference
it runs on the (B, max_detections) padded detections. Both paths reuse the
box path's one forward of the backbone and FPN, and reach the RoIAlign
kernels K1 (and in training K2) at ``mask_roi_size``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ...ops.nms import NMSResult
from ...utils.registry import DETECTORS
from ..heads.mask_head import mask_loss, mask_targets_for_rois, select_class
from ..heads.rpn_head import Proposals
from .two_stage import (
    FasterRCNNConfig,
    Noise,
    TwoStageDetector,
    _faster_rcnn_inference_core,
    _faster_rcnn_loss_core,
    _sample_fixed,
    _take,
    roi_features,
    undo_scale,
)


@DETECTORS.register_module
class MaskRCNN(TwoStageDetector):
    """TwoStageDetector + mask head (``mask_head``, named as the reference's
    flax submodule). The head reads the neck's channels, as flax infers
    them."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], rpn_head: Dict[str, Any],
                 bbox_head: Dict[str, Any], mask_head: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(backbone, neck, rpn_head, bbox_head, dtype, param_dtype, device)
        self.mask_head = self._build_roi_head(mask_head)

    def mask_forward(self, roi_feats: Tensor) -> Tensor:
        """(B, R, S, S, C) aligned features -> (B, R, 2S, 2S, classes) logits."""
        with self._autocast(roi_feats):
            return self.mask_head(roi_feats)


@dataclasses.dataclass(frozen=True)
class MaskRCNNConfig(FasterRCNNConfig):
    mask_size: int = 28  # the head outputs twice the roi feature size (14 -> 28)
    mask_roi_size: int = 14
    mask_loss_weight: float = 1.0


def mask_rcnn_loss(
    cfg: MaskRCNNConfig, model: MaskRCNN, batch: Dict[str, Tensor], noise: Noise
) -> Dict[str, Tensor]:
    """Faster R-CNN's losses plus ``loss_mask``, on one forward.

    ``batch`` adds ``gt_masks`` (B, G_mask, H, W) uint8 to Faster R-CNN's
    keys, G_mask bucketed by the collate (at most G of ``gt_boxes``; the
    valid gts come first). ``noise`` is called a third time, for the mask
    slate (``sample_mask_rois``)."""
    losses, feats, proposals = _faster_rcnn_loss_core(cfg, model, batch, noise)
    slate = sample_mask_rois(cfg, proposals, batch["gt_boxes"], batch["gt_labels"],
                             batch["gt_valid"], noise)
    targets = mask_targets_for_rois(batch["gt_masks"], slate.rois, slate.matched, cfg.mask_size)
    roi_feats = roi_features(cfg, feats, slate.rois, cfg.mask_roi_size)
    loss_mask = mask_loss(model.mask_forward(roi_feats), targets, slate.labels, slate.is_pos)
    loss_mask = loss_mask * cfg.mask_loss_weight
    losses = dict(losses, loss_mask=loss_mask)
    losses["loss"] = losses["loss"] + loss_mask
    return losses


class MaskRois(NamedTuple):
    rois: Tensor  # (B, num, 4)
    labels: Tensor  # (B, num) 1-based, 0 where not positive
    matched: Tensor  # (B, num) int64 gt index, 0 where not positive
    is_pos: Tensor  # (B, num) bool


def sample_mask_rois(
    cfg: MaskRCNNConfig,
    proposals: Proposals,
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G)
    gt_valid: Tensor,  # (B, G)
    noise: Noise,
) -> MaskRois:
    """The mask branch's slate: the proposals and the gt, assigned by the
    RoI assigner, sampled positives first up to the box sampler's positive
    cap an image (``rcnn_pos_fraction * rcnn_num_samples``)."""
    cand = torch.cat([proposals.boxes, gt_boxes.to(proposals.boxes.dtype)], dim=1)
    cand_valid = torch.cat([proposals.valid, gt_valid], dim=1)
    assign = cfg.rcnn_assigner(cand, gt_boxes, gt_valid, gt_labels, anchor_valid=cand_valid)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    num = max(int(cfg.rcnn_num_samples * cfg.rcnn_pos_fraction), 1)
    idx, is_pos, _ = _sample_fixed(pos, neg, num, 1.0, *noise(tuple(pos.shape)))
    labels = torch.where(is_pos, _take(assign.labels, idx), 0)
    matched = (_take(assign.assigned_gt_inds, idx).long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    return MaskRois(_take(cand, idx), labels, matched, is_pos)


class MaskDetections(NamedTuple):
    boxes: Tensor  # (B, D, 4)
    scores: Tensor  # (B, D)
    labels: Tensor  # (B, D) 0-based, -1 pad
    valid: Tensor  # (B, D)
    mask_probs: Tensor  # (B, D, M, M) float32 probabilities of the detected class


def mask_rcnn_inference(
    cfg: MaskRCNNConfig,
    model: MaskRCNN,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> MaskDetections:
    """Box inference, then the mask branch on the padded detections, on
    one forward of the backbone. The mask probabilities of invalid slots are
    0; ``paste_masks`` rasters them onto an image."""
    dets, feats = _faster_rcnn_inference_core(cfg, model, images, img_shapes)
    dets, roi_boxes = mask_frame(dets, scale_factors)
    logits = select_class(model.mask_forward(roi_features(cfg, feats, roi_boxes,
                                                          cfg.mask_roi_size)), dets.labels)
    probs = torch.sigmoid(logits.float()) * dets.valid[..., None, None]
    return MaskDetections(dets.boxes, dets.scores, dets.labels, dets.valid, probs)


def mask_frame(dets: NMSResult, scale_factors: Optional[Tensor]) -> Tuple[NMSResult, Tensor]:
    """The detections in the original frame, and the boxes the mask branch
    looks its features up at: the detections go out in the original frame,
    the features live in the network's, so the factors are undone per image
    and applied back, rounding as the reference does for (B,) factors."""
    dets = undo_scale(dets, scale_factors)
    if scale_factors is None:
        return dets, dets.boxes
    return dets, dets.boxes * scale_factors.reshape(dets.boxes.shape[0], 1, -1).to(dets.boxes.dtype)
