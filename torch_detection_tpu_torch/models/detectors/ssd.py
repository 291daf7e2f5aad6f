"""SSD: config, softmax loss with hard-negative mining, and the decode.

Counterpart of ``torch_detection_tpu/models/detectors/ssd.py``, batched
over the images. The model is ``SingleStageDetector`` with ``SSDVGG`` and
``SSDHead``.

* The loss is softmax cross-entropy over C + 1 classes (background 0) and
  smooth-L1 on the positives, each image's divided by its positive count
  (at least 1), then averaged over the images.
* The mining is the reference's fixed-shape one: every image's negatives
  are ranked by their cross-entropy with a stable descending sort, so that
  among equal losses the lower index ranks first (XLA's order), and a
  negative is kept where its rank is under int(3 * num_pos).
* The loss takes no ``img_shapes``, as the reference's: anchors over the
  canvas padding are negatives and enter the mining (R11). Their features
  are equal, so their cross-entropies tie exactly, and the tie order
  decides which of them are kept.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ...ops.anchors import SSDAnchorGenerator
from ...ops.assign import MaxIoUAssigner
from ...ops.boxes import bbox2delta, clip_boxes, delta2bbox
from ...ops.losses import smooth_l1_loss
from ...ops.nms import NMSResult
from ..heads.anchor_head import flatten_head_outputs
from .fcos import dense_nms


@dataclasses.dataclass(frozen=True)
class SSDConfig:
    """The reference's ``SSDConfig`` with its defaults, less
    ``approx_top_k`` (a TPU approximation)."""

    num_classes: int = 80
    anchor_generator: SSDAnchorGenerator = SSDAnchorGenerator()
    target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    assigner: MaxIoUAssigner = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0)
    neg_pos_ratio: float = 3.0
    smooth_l1_beta: float = 1.0
    # inference (mmdetection's SSD300 test settings)
    score_thr: float = 0.02
    nms_iou_thr: float = 0.45
    pre_nms_top_k: int = 1000
    max_detections: int = 200


def flatten_ssd_outputs(cfg: SSDConfig, cls_scores: Sequence[Tensor],
                        bbox_preds: Sequence[Tensor]) -> Tuple[Tensor, Tensor]:
    """Per level (B, H, W, A * (C + 1)) and (B, H, W, A * 4) -> float32
    (B, N, C + 1) and (B, N, 4), in the order of ``flat_anchors``."""
    flat_c, flat_r = flatten_head_outputs(cls_scores, bbox_preds, cfg.num_classes + 1)
    return flat_c.float(), flat_r.float()


class SSDTargets(NamedTuple):
    pos: Tensor  # (B, N) bool
    neg: Tensor  # (B, N) bool
    labels: Tensor  # (B, N) int64 1-based class of a positive, 0 elsewhere
    reg_targets: Tensor  # (B, N, 4)


def ssd_targets(cfg: SSDConfig, anchors: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
                gt_valid: Tensor) -> SSDTargets:
    """Every image's MaxIoU assignment (no ``anchor_valid``: R11) and its
    encoded regression targets."""
    assign = cfg.assigner(anchors, gt_boxes, gt_valid, gt_labels)
    pos = assign.assigned_gt_inds > 0
    safe_gt = (assign.assigned_gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    matched = torch.gather(gt_boxes, 1, safe_gt[..., None].expand(-1, -1, 4))
    reg_targets = bbox2delta(anchors[None], matched, cfg.target_means, cfg.target_stds)
    labels = torch.where(pos, assign.labels.long(), torch.zeros_like(safe_gt))
    return SSDTargets(pos, assign.assigned_gt_inds == 0, labels, reg_targets)


def cross_entropy(flat_c: Tensor, labels: Tensor) -> Tensor:
    """(B, N) softmax cross-entropy of each anchor against its label."""
    return -torch.gather(F.log_softmax(flat_c, dim=-1), -1, labels[..., None])[..., 0]


def hard_negatives(cfg: SSDConfig, ce: Tensor, pos: Tensor, neg: Tensor) -> Tensor:
    """(B, N) bool: the negatives whose rank by cross-entropy (a stable
    descending sort, the lower index first among equal losses) is under
    int(neg_pos_ratio * num_pos) of their image."""
    neg_score = torch.where(neg, ce.detach(), torch.full_like(ce, -torch.inf))
    order = torch.sort(neg_score, dim=-1, descending=True, stable=True).indices
    arange = torch.arange(ce.shape[-1], device=ce.device).expand_as(order)
    rank = torch.empty_like(order).scatter_(-1, order, arange)
    limit = (cfg.neg_pos_ratio * pos.sum(dim=-1)).to(torch.int64)
    return neg & (rank < limit[:, None])


def ssd_loss(
    cfg: SSDConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> Dict[str, Tensor]:
    """Softmax cross-entropy with 3:1 hard-negative mining and smooth-L1,
    as mmdetection's SSD, each image's over its positive count, averaged
    over the images."""
    sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = cfg.anchor_generator.flat_anchors(sizes, gt_boxes.device)
    flat_c, flat_r = flatten_ssd_outputs(cfg, cls_scores, bbox_preds)
    t = ssd_targets(cfg, anchors, gt_boxes, gt_labels, gt_valid)
    ce = cross_entropy(flat_c, t.labels)
    keep = t.pos | hard_negatives(cfg, ce, t.pos, t.neg)
    num_pos = t.pos.sum(dim=1).to(torch.float32)
    denom = num_pos.clamp(min=1.0)
    loss_cls = ((ce * keep).sum(dim=1) / denom).mean()
    # each image's weights carry 1 / (B * its denominator): one sum is the mean
    weight = t.pos[..., None] / (flat_r.shape[0] * denom)[:, None, None]
    loss_reg = smooth_l1_loss(flat_r, t.reg_targets, weight=weight, beta=cfg.smooth_l1_beta)
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss": loss_cls + loss_reg,
            "num_pos": num_pos.mean()}


def ssd_candidates(cfg: SSDConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                   img_shapes: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(B, N, C) foreground probabilities (softmax, column 0 dropped) and
    (B, N, 4) decoded boxes, clipped to each image's (h, w) when given."""
    sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = cfg.anchor_generator.flat_anchors(sizes, cls_scores[0].device)
    flat_c, flat_r = flatten_ssd_outputs(cfg, cls_scores, bbox_preds)
    boxes = delta2bbox(anchors, flat_r, cfg.target_means, cfg.target_stds)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.softmax(flat_c, dim=-1)[..., 1:], boxes


def decode_ssd(
    cfg: SSDConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """softmax -> delta decode -> clip -> class-wise NMS, padded to
    (B, max_detections)."""
    scores, boxes = ssd_candidates(cfg, cls_scores, bbox_preds, img_shapes)
    return dense_nms(cfg, scores, boxes, scale_factors)


def ssd_inference(cfg: SSDConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                  scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_ssd``."""
    return decode_ssd(cfg, *model(images), img_shapes, scale_factors)
