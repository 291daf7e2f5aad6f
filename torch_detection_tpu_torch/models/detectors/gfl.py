"""GFL: the quality focal, distribution focal and GIoU losses, and the
decode.

Counterpart of ``torch_detection_tpu/models/detectors/gfl.py``, batched
over the images, on ATSS's skeleton (one anchor a location, the
``ATSSAssigner``): the classification score is the localisation quality,
supervised densely with the detached IoU of the current decoded box (QFL);
each ltrb side is a distribution over ``reg_max + 1`` bins of the level's
stride whose expectation is the distance (``integral``), sharpened by the
DFL on the two bins around the target; GIoU is weighted by the detached
best class probability. The reference's one-hot contractions are plain
``gather``s here. The head is ``SingleStageDetector`` with ``GFLHead``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ...ops.anchors import AnchorGenerator
from ...ops.assign import ATSSAssigner
from ...ops.boxes import clip_boxes
from ...ops.losses import iou_loss_elementwise, optax_sigmoid_ce
from ...ops.nms import NMSResult
from .atss import assign_and_match, level_counts
from .fcos import dense_nms, flatten_outputs, per_image_mean, points_to_boxes, preselect_levels


@dataclasses.dataclass(frozen=True)
class GFLConfig:
    """The reference's ``GFLConfig`` with its defaults, less
    ``approx_top_k``."""

    num_classes: int = 80
    anchor_generator: AnchorGenerator = AnchorGenerator(
        strides=(8, 16, 32, 64, 128), ratios=(1.0,), octave_base_scale=8.0, scales_per_octave=1)
    assigner: ATSSAssigner = ATSSAssigner(topk=9)
    reg_max: int = 16
    qfl_beta: float = 2.0
    qfl_weight: float = 1.0
    dfl_weight: float = 0.25
    giou_weight: float = 2.0
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.6
    pre_select_per_level: int = 1000
    pre_nms_top_k: int = 1000
    max_detections: int = 100


def integral(reg: Tensor, reg_max: int) -> Tensor:
    """(..., 4 (reg_max + 1)) logits -> (..., 4) expected ltrb in bins: the
    softmax over each side's bins against the bin indices."""
    n1 = reg_max + 1
    p = torch.softmax(reg.reshape(*reg.shape[:-1], 4, n1), dim=-1)
    return p @ torch.arange(n1, dtype=p.dtype, device=p.device)


def _aligned_iou(a: Tensor, b: Tensor, offset: float = 1.0, eps: float = 1e-7) -> Tensor:
    """IoU of matching (..., 4) xyxy pairs, the +1 inclusive-pixel
    convention, the union at least ``eps`` (GFL's 1e-7, PAA's 1e-6)."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:4], b[..., 2:4])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0] + offset) * (a[..., 3] - a[..., 1] + offset)
    area_b = (b[..., 2] - b[..., 0] + offset) * (b[..., 3] - b[..., 1] + offset)
    return inter / torch.clamp(area_a + area_b - inter, min=eps)


def _level_strides(cfg: GFLConfig, featmap_sizes, device) -> Tensor:
    """(N,) each anchor's level stride."""
    a = cfg.anchor_generator.num_base_anchors
    return torch.cat([torch.full((h * w * a,), float(s), dtype=torch.float32, device=device)
                      for (h, w), s in zip(featmap_sizes, cfg.anchor_generator.strides,
                                           strict=True)])


def gfl_loss(
    cfg: GFLConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) un-padded (h, w)
) -> Dict[str, Tensor]:
    """QFL over the positives' count, GIoU weighted by the detached best
    class probability over its sum, DFL over four times that sum; each per
    image, then averaged and weighted."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    device = gt_boxes.device
    anchors = cfg.anchor_generator.flat_anchors(featmap_sizes, device)
    strides = _level_strides(cfg, featmap_sizes, device)
    fc, fr = flatten_outputs(cfg.num_classes, cls_scores, bbox_preds)
    label0, matched = assign_and_match(
        cfg.assigner, anchors, level_counts(cfg.anchor_generator, featmap_sizes), gt_boxes,
        gt_labels, gt_valid, img_shapes)
    pos = label0 >= 0
    num_pos = pos.sum(dim=1).float()
    centres = torch.stack([(anchors[:, 0] + anchors[:, 2]) * 0.5,
                           (anchors[:, 1] + anchors[:, 3]) * 0.5], dim=-1)  # (N, 2)

    logits = fc.float()
    boxes = points_to_boxes(centres, integral(fr, cfg.reg_max) * strides[:, None])

    # QFL, dense: the target is the one-hot label times the detached IoU
    quality = torch.where(pos, _aligned_iou(boxes, matched).detach(), 0.0)
    classes = torch.arange(cfg.num_classes, device=device)
    y = (label0[..., None] == classes).float() * quality[..., None]
    p = torch.sigmoid(logits)
    qfl = (y - p).abs() ** cfg.qfl_beta * optax_sigmoid_ce(logits, y)
    loss_qfl = (qfl.sum(dim=(1, 2)) / num_pos.clamp(min=1.0)).mean()

    # the re-weighting: the detached best class probability at the positives
    w = torch.where(pos, p.amax(dim=-1).detach(), 0.0)
    w_sum = w.sum(dim=1).clamp(min=1e-6)
    giou = iou_loss_elementwise(boxes, matched, mode="giou")
    loss_giou = per_image_mean((giou * w).sum(1), w_sum)

    # DFL on the two bins around each side's target distance
    tl_d = torch.stack([centres[:, 0] - matched[..., 0], centres[:, 1] - matched[..., 1],
                        matched[..., 2] - centres[:, 0], matched[..., 3] - centres[:, 1]],
                       dim=-1) / strides[:, None]
    t = torch.clamp(tl_d, 0.0, cfg.reg_max - 1e-4)
    t_lo = torch.floor(t)
    w_hi = t - t_lo
    w_lo = 1.0 - w_hi
    logp = F.log_softmax(fr.reshape(*fr.shape[:-1], 4, cfg.reg_max + 1), dim=-1)
    lo = t_lo.long()[..., None]
    ce = -(w_lo * torch.gather(logp, -1, lo)[..., 0] + w_hi * torch.gather(logp, -1, lo + 1)[..., 0])
    loss_dfl = ((w[..., None] * ce).sum(dim=(1, 2)) / (4.0 * w_sum)).mean()

    loss_qfl = loss_qfl * cfg.qfl_weight
    loss_giou = loss_giou * cfg.giou_weight
    loss_dfl = loss_dfl * cfg.dfl_weight
    return {"loss_qfl": loss_qfl, "loss_giou": loss_giou, "loss_dfl": loss_dfl,
            "loss": loss_qfl + loss_giou + loss_dfl, "num_pos": num_pos.mean()}


def gfl_candidates(cfg: GFLConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                   img_shapes: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per-level preselection and the integral decode: (B, M, C)
    sigmoid(cls) and (B, M, 4) boxes, clipped to each image's (h, w) when
    ``img_shapes`` is given."""
    b = cls_scores[0].shape[0]
    n1 = 4 * (cfg.reg_max + 1)
    level_anchors = cfg.anchor_generator.grid_anchors([tuple(s.shape[1:3]) for s in cls_scores],
                                                      cls_scores[0].device)
    level = []
    for a, r, s in zip(level_anchors, bbox_preds, cfg.anchor_generator.strides, strict=True):
        centres = torch.stack([(a[:, 0] + a[:, 2]) * 0.5, (a[:, 1] + a[:, 3]) * 0.5], dim=-1)
        level.append([torch.cat([centres, torch.full_like(centres[:, :1], float(s))], dim=-1),
                      r.reshape(b, -1, n1)])
    logits, sel = preselect_levels(cfg.num_classes, cfg.pre_select_per_level, cls_scores, level)
    where, regs = (torch.cat([s[i] for s in sel], dim=1) for i in range(2))
    boxes = points_to_boxes(where[..., :2], integral(regs, cfg.reg_max) * where[..., 2:3])
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.sigmoid(torch.cat(logits, dim=1)), boxes


def decode_gfl(
    cfg: GFLConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> NMSResult:
    """Per-level preselection -> integral decode -> class-wise NMS on
    sigmoid(cls), padded to (B, max_detections)."""
    return dense_nms(cfg, *gfl_candidates(cfg, cls_scores, bbox_preds, img_shapes), scale_factors)


def gfl_inference(cfg: GFLConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                  scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_gfl``."""
    return decode_gfl(cfg, *model(images), img_shapes, scale_factors)
