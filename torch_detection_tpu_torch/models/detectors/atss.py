"""ATSS: adaptive sample selection, focal + GIoU + centerness losses, and
the decode.

Counterpart of ``torch_detection_tpu/models/detectors/atss.py``, batched
over the images: one anchor a location (``octave_base_scale=8``), targets
from ``ops.assign.ATSSAssigner`` (its full-matrix path), GIoU on
delta-decoded boxes weighted by the centerness target, a BCE centerness,
and the valid-anchor mask from the batch's ``img_shape``. The head is
``SingleStageDetector`` with ``ATSSHead``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ...ops.anchors import AnchorGenerator
from ...ops.assign import ATSSAssigner
from ...ops.boxes import clip_boxes, delta2bbox
from ...ops.losses import binary_cross_entropy, iou_loss_elementwise, sigmoid_focal_loss_sparse
from ...ops.nms import NMSResult
from .fcos import centerness, dense_nms, flatten_outputs, per_image_mean, preselect_levels


@dataclasses.dataclass(frozen=True)
class ATSSConfig:
    """The reference's ``ATSSConfig`` with its defaults, less
    ``approx_top_k``."""

    num_classes: int = 80
    anchor_generator: AnchorGenerator = AnchorGenerator(
        strides=(8, 16, 32, 64, 128), ratios=(1.0,), octave_base_scale=8.0, scales_per_octave=1)
    target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    assigner: ATSSAssigner = ATSSAssigner(topk=9)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    reg_loss_weight: float = 2.0
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.6
    pre_select_per_level: int = 1000
    pre_nms_top_k: int = 1000
    max_detections: int = 100


def level_counts(anchor_generator: AnchorGenerator, featmap_sizes) -> Tuple[int, ...]:
    a = anchor_generator.num_base_anchors
    return tuple(h * w * a for (h, w) in featmap_sizes)


def anchor_valid(anchors: Tensor, img_shapes: Optional[Tensor]) -> Optional[Tensor]:
    """(B, N): the anchors whose centre lies inside each image's (h, w);
    None without ``img_shapes`` (every anchor valid)."""
    if img_shapes is None:
        return None
    cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
    cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
    shapes = img_shapes.to(anchors.dtype)
    return (cx[None] < shapes[:, 1:2]) & (cy[None] < shapes[:, 0:1])


def assign_and_match(assigner: ATSSAssigner, anchors: Tensor, counts: Tuple[int, ...],
                     gt_boxes: Tensor, gt_labels: Tensor, gt_valid: Tensor,
                     img_shapes: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """ATSS's (B, N) 0-based labels (-1 = background) and (B, N, 4) matched
    gt boxes (gt 0's where an anchor has none)."""
    assign = assigner(anchors, counts, gt_boxes, gt_valid, gt_labels,
                      anchor_valid(anchors, img_shapes))
    pos = assign.assigned_gt_inds > 0
    safe_gt = (assign.assigned_gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    matched = torch.gather(gt_boxes, 1, safe_gt[..., None].expand(-1, -1, 4))
    label0 = torch.where(pos, assign.labels.long() - 1, torch.full_like(safe_gt, -1))
    return label0, matched


def atss_targets(
    cfg: ATSSConfig,
    anchors: Tensor,  # (N, 4)
    counts: Tuple[int, ...],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
) -> Tuple[Tensor, Tensor, Tensor]:
    """Each anchor's (B, N) 0-based label (-1 = background), (B, N, 4)
    matched gt box and (B, N) centerness target: FCOS's formula measured
    from the anchor's centre inside its matched gt."""
    label0, matched = assign_and_match(cfg.assigner, anchors, counts, gt_boxes, gt_labels,
                                       gt_valid, img_shapes)
    acx = ((anchors[:, 0] + anchors[:, 2]) * 0.5)[None]
    acy = ((anchors[:, 1] + anchors[:, 3]) * 0.5)[None]
    ltrb = torch.stack([acx - matched[..., 0], acy - matched[..., 1],
                        matched[..., 2] - acx, matched[..., 3] - acy], dim=-1)
    ctr = centerness(ltrb)
    return label0, matched, torch.where(label0 >= 0, ctr, torch.zeros_like(ctr))


def atss_loss(
    cfg: ATSSConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    centernesses: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) un-padded (h, w)
) -> Dict[str, Tensor]:
    """The focal loss over the positives' count, GIoU (offset 1, the
    inclusive-pixel boxes of ``delta2bbox``) weighted by the centerness
    target over its sum and times ``reg_loss_weight``, and the centerness
    BCE over the positives' count; each per image, then averaged."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = cfg.anchor_generator.flat_anchors(featmap_sizes, gt_boxes.device)
    counts = level_counts(cfg.anchor_generator, featmap_sizes)
    fc, fr, fct = flatten_outputs(cfg.num_classes, cls_scores, bbox_preds, centernesses)
    label0, matched, ctr_t = atss_targets(cfg, anchors, counts, gt_boxes, gt_labels, gt_valid,
                                          img_shapes)
    b = gt_boxes.shape[0]
    pos = label0 >= 0
    num_pos = pos.sum(dim=1).float()
    per_image = (1.0 / (b * num_pos.clamp(min=1.0)))[:, None, None]
    loss_cls = sigmoid_focal_loss_sparse(fc, label0, weight=per_image, gamma=cfg.focal_gamma,
                                         alpha=cfg.focal_alpha)
    pred_boxes = delta2bbox(anchors[None], fr, cfg.target_means, cfg.target_stds,
                            wh_ratio_clip=16 / 1000)
    ctr_w = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    giou = iou_loss_elementwise(pred_boxes, matched, mode="giou")
    loss_reg = per_image_mean((giou * ctr_w).sum(1), ctr_w.sum(1)) * cfg.reg_loss_weight
    loss_ctr = binary_cross_entropy(fct, ctr_t, weight=pos.float() * per_image[..., 0])
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss_centerness": loss_ctr,
            "loss": loss_cls + loss_reg + loss_ctr, "num_pos": num_pos.mean()}


def atss_candidates(cfg: ATSSConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                    centernesses: Sequence[Tensor], img_shapes: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Per-level preselection and the delta decode: (B, M, C)
    sigmoid(cls) * sigmoid(centerness) and (B, M, 4) boxes, clipped to each
    image's (h, w) when ``img_shapes`` is given."""
    b = cls_scores[0].shape[0]
    level_anchors = cfg.anchor_generator.grid_anchors([tuple(s.shape[1:3]) for s in cls_scores],
                                                      cls_scores[0].device)
    level = [[a, r.reshape(b, -1, 4), c.reshape(b, -1, 1)]
             for a, r, c in zip(level_anchors, bbox_preds, centernesses, strict=True)]
    logits, sel = preselect_levels(cfg.num_classes, cfg.pre_select_per_level, cls_scores, level)
    anchors, regs, ctr = (torch.cat([s[i] for s in sel], dim=1) for i in range(3))
    boxes = delta2bbox(anchors, regs, cfg.target_means, cfg.target_stds, wh_ratio_clip=16 / 1000)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.sigmoid(torch.cat(logits, dim=1)) * torch.sigmoid(ctr), boxes


def decode_atss(
    cfg: ATSSConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    centernesses: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> NMSResult:
    """Per-level preselection -> delta decode -> NMS on
    sigmoid(cls) * sigmoid(centerness), padded to (B, max_detections)."""
    return dense_nms(cfg, *atss_candidates(cfg, cls_scores, bbox_preds, centernesses, img_shapes),
                     scale_factors)


def atss_inference(cfg: ATSSConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                   scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_atss``."""
    return decode_atss(cfg, *model(images), img_shapes, scale_factors)
