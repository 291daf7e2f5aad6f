"""Cascade R-CNN: three box stages, each trained at a higher IoU threshold
on the previous stage's refined boxes.

Counterpart of ``torch_detection_tpu/models/detectors/cascade_rcnn.py``.
Shapes stay fixed: every stage samples ``rcnn_num_samples`` rois an image,
and stage t + 1's candidates are stage t's sampled slate decoded through
stage t's head, clipped, less the rois that were sampled out of the
appended gt block (the next stage appends the gt itself). The heads regress
class-agnostic deltas, so the refinement is one (B, R, 4) decode. At
inference the stages' softmax scores, each on its own refined slate, are
averaged, and the boxes are decoded from the last stage.

Each stage runs the RoIAlign kernels once: K1, and in training K2.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import Tensor

from ...ops.assign import MaxIoUAssigner
from ...ops.boxes import clip_boxes, delta2bbox
from ...ops.nms import NMSResult
from ...utils.registry import DETECTORS, HEADS
from ..heads.rpn_head import generate_proposals
from .two_stage import (
    FasterRCNNConfig,
    Noise,
    RoIDetector,
    SampledRois,
    TwoStageDetector,
    _rpn_stage,
    class_nms,
    rcnn_losses,
    roi_features,
    sample_rois,
    undo_scale,
)


@DETECTORS.register_module
class CascadeRCNN(TwoStageDetector):
    """backbone + neck + RPN + ``num_stages`` box heads, ``bbox_head0`` to
    ``bbox_head{S-1}`` as flax names them, each built from ``bbox_head``
    with its own parameters. There is no single ``bbox_head``: the
    constructor skips ``TwoStageDetector``'s, which builds one."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], rpn_head: Dict[str, Any],
                 bbox_head: Dict[str, Any], num_stages: int = 3,
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        if not bbox_head.get("reg_class_agnostic", True):
            raise ValueError("CascadeRCNN requires class-agnostic box regression")
        RoIDetector.__init__(self, backbone, neck, dtype, param_dtype, device)
        self.rpn = self._build(HEADS, rpn_head)
        self.num_stages = num_stages
        for t in range(num_stages):
            setattr(self, f"bbox_head{t}", self._build_roi_head(bbox_head))

    def roi_forward(self, roi_feats: Tensor, stage: int) -> Tuple[Tensor, Tensor]:
        """Stage ``stage``'s head on aligned (B, R, S, S, C) roi features."""
        with self._autocast(roi_feats):
            return self.get_submodule(f"bbox_head{stage}")(roi_feats)


@dataclasses.dataclass(frozen=True)
class CascadeRCNNConfig(FasterRCNNConfig):
    """Faster R-CNN's config and the cascade's stages. Stage t assigns with
    pos = neg = min_pos = ``stage_pos_ious[t]`` and normalises its deltas by
    ``stage_target_stds[t]`` (in place of ``rcnn_target_stds``); its losses
    weigh ``stage_loss_weights[t]`` in the total."""

    num_stages: int = 3
    stage_pos_ious: Tuple[float, ...] = (0.5, 0.6, 0.7)
    stage_target_stds: Tuple[Tuple[float, float, float, float], ...] = (
        (0.1, 0.1, 0.2, 0.2),
        (0.05, 0.05, 0.1, 0.1),
        (0.033, 0.033, 0.067, 0.067),
    )
    stage_loss_weights: Tuple[float, ...] = (1.0, 0.5, 0.25)

    def stage_assigner(self, t: int) -> MaxIoUAssigner:
        thr = self.stage_pos_ious[t]
        return dataclasses.replace(self.rcnn_assigner, pos_iou_thr=thr, neg_iou_thr=thr,
                                   min_pos_iou=thr)


def refine(cfg: CascadeRCNNConfig, t: int, rois: Tensor, reg_pred: Tensor,
           img_shapes: Optional[Tensor]) -> Tensor:
    """Stage t's boxes: ``rois`` decoded by its (B, R, 4) deltas with its
    stds, clipped to each image when ``img_shapes`` is given."""
    boxes = delta2bbox(rois, reg_pred.float(), cfg.rcnn_target_means, cfg.stage_target_stds[t])
    return boxes if img_shapes is None else clip_boxes(boxes, img_shapes)


def next_candidates(cfg: CascadeRCNNConfig, t: int, sampled: SampledRois, reg_pred: Tensor,
                    img_shapes: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Stage t + 1's candidates and their validity: stage t's slate refined
    by its detached regression, without the rois sampled out of the gt
    block (the next stage appends the gt again)."""
    boxes = refine(cfg, t, sampled.rois, reg_pred.detach(), img_shapes)
    return boxes, sampled.is_valid & ~sampled.from_gt


def cascade_rcnn_loss(
    cfg: CascadeRCNNConfig, model: CascadeRCNN, batch: Dict[str, Tensor], noise: Noise
) -> Dict[str, Tensor]:
    """The RPN's losses and each stage's, unweighted as ``loss_s{t}_cls``
    and ``loss_s{t}_reg``; ``loss`` weighs the stages by
    ``stage_loss_weights``; ``num_pos_rois`` is the last stage's."""
    losses, _, _ = _cascade_rcnn_loss_core(cfg, model, batch, noise)
    return losses


def _cascade_rcnn_loss_core(
    cfg: CascadeRCNNConfig, model: CascadeRCNN, batch: Dict[str, Tensor], noise: Noise
) -> Tuple[Dict[str, Tensor], Tuple[Tensor, ...], List[SampledRois]]:
    """The loss body; also returns the FPN levels and each stage's sampled
    slate, so that the mask branch reuses the same forward. ``noise`` is
    called 1 + S times: the RPN's anchors, then each stage's (B, P + G) and
    (B, R + G) candidates, as the reference splits its key."""
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    img_shapes = batch.get("img_shape")
    losses, feats, proposals = _rpn_stage(cfg, model, batch, noise)
    total = losses["loss"]
    boxes, valid = proposals.boxes, proposals.valid
    slates = []
    for t in range(cfg.num_stages):
        sampled = sample_rois(cfg, boxes, valid, *gt, noise, assigner=cfg.stage_assigner(t),
                              target_stds=cfg.stage_target_stds[t])
        slates.append(sampled)
        cls_logits, reg_pred = model.roi_forward(roi_features(cfg, feats, sampled.rois), t)
        cls_l, reg_l = rcnn_losses(cfg, cls_logits, reg_pred, sampled)
        losses[f"loss_s{t}_cls"], losses[f"loss_s{t}_reg"] = cls_l, reg_l
        total = total + cfg.stage_loss_weights[t] * (cls_l + reg_l)
        if t + 1 < cfg.num_stages:
            boxes, valid = next_candidates(cfg, t, sampled, reg_pred, img_shapes)
    losses["loss"] = total
    losses["num_pos_rois"] = slates[-1].is_pos.float().sum()
    return losses, feats, slates


def cascade_rcnn_inference(
    cfg: CascadeRCNNConfig,
    model: CascadeRCNN,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Proposals -> the stages on progressively refined boxes -> averaged
    scores on the last stage's boxes -> per-class NMS, padded."""
    res, _ = _cascade_rcnn_inference_core(cfg, model, images, img_shapes)
    return undo_scale(res, scale_factors)


def _cascade_rcnn_inference_core(
    cfg: CascadeRCNNConfig,
    model: CascadeRCNN,
    images: Tensor,
    img_shapes: Optional[Tensor] = None,
) -> Tuple[NMSResult, Tuple[Tensor, ...]]:
    """The detections in the network's frame, and the FPN levels they came
    from, so that the mask branch reuses the same forward."""
    feats, rpn_scores, rpn_deltas = model(images)
    proposals = generate_proposals(
        cfg.proposal_test, cfg.anchor_generator, rpn_scores, rpn_deltas, img_shapes
    )
    boxes = proposals.boxes
    probs_sum = 0.0
    for t in range(cfg.num_stages):
        cls_logits, reg_pred = model.roi_forward(roi_features(cfg, feats, boxes), t)
        probs_sum = probs_sum + torch.softmax(cls_logits.float(), dim=-1)
        boxes = refine(cfg, t, boxes, reg_pred, img_shapes)
    probs = (probs_sum / cfg.num_stages)[..., 1:]  # drop background
    return class_nms(cfg, boxes, probs, proposals.valid), feats
