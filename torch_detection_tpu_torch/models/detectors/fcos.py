"""FCOS: point targets, focal + GIoU + centerness losses, and the decode.

Counterpart of ``torch_detection_tpu/models/detectors/fcos.py``, batched
over the images: each point of each level takes the smallest-area gt that
contains it within the level's regression range, through a masked argmin
over the (B, N, G) candidates. The reference's ``take_per_row`` and
``gather_rows`` (``ops/tpu_gather.py``, one-hot TPU devices) are plain
indexing here. The head is ``SingleStageDetector`` with ``FCOSHead``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ...ops.boxes import clip_boxes
from ...ops.losses import binary_cross_entropy, iou_loss_elementwise, sigmoid_focal_loss_sparse
from ...ops.nms import NMSResult, multiclass_nms, top_k_stable

INF = 1e8


@dataclasses.dataclass(frozen=True)
class FCOSConfig:
    """The reference's ``FCOSConfig`` with its defaults, less
    ``approx_top_k`` (a TPU approximation the port does not take)."""

    num_classes: int = 80
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    # per-level ranges of the largest ltrb distance (the FCOS level rule)
    regress_ranges: Tuple[Tuple[float, float], ...] = (
        (-1.0, 64.0), (64.0, 128.0), (128.0, 256.0), (256.0, 512.0), (512.0, INF))
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    pre_select_per_level: int = 1000
    pre_nms_top_k: int = 1000
    max_detections: int = 100


def level_points(featmap_size: Tuple[int, int], stride: int, device=None) -> Tensor:
    """(H*W, 2) point centres (x, y) at (i + 0.5) * stride, row-major."""
    h, w = featmap_size
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) * stride
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) * stride
    return torch.stack([xs[None, :].expand(h, w).reshape(-1),
                        ys[:, None].expand(h, w).reshape(-1)], dim=-1)


def flat_points(cfg: FCOSConfig, featmap_sizes, device=None) -> Tuple[Tensor, Tensor]:
    """Every level's points (N, 2) and each point's (N, 2) regression range."""
    pts, rngs = [], []
    for size, stride, rr in zip(featmap_sizes, cfg.strides, cfg.regress_ranges, strict=True):
        p = level_points(size, stride, device)
        pts.append(p)
        rngs.append(torch.tensor(rr, dtype=torch.float32, device=device).expand(p.shape[0], 2))
    return torch.cat(pts), torch.cat(rngs)


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, n, idx[b, n]]`` for (B, N, G, ...) ``x`` and (B, N) ``idx``."""
    index = idx.reshape(*idx.shape, 1, *([1] * (x.dim() - 3)))
    return torch.gather(x, 2, index.expand(*idx.shape, 1, *x.shape[3:]))[:, :, 0]


def centerness(ltrb: Tensor) -> Tensor:
    """sqrt(min(l, r) / max(l, r) * min(t, b) / max(t, b)), each ratio
    clipped to [0, 1], the maxima at least 1e-6."""
    lr, tb = ltrb[..., 0::2], ltrb[..., 1::2]
    eps = 1e-6
    return torch.sqrt(torch.clamp(lr.amin(-1) / lr.amax(-1).clamp(min=eps), 0, 1)
                      * torch.clamp(tb.amin(-1) / tb.amax(-1).clamp(min=eps), 0, 1))


def fcos_targets(
    cfg: FCOSConfig,
    points: Tensor,  # (N, 2)
    ranges: Tensor,  # (N, 2)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> Tuple[Tensor, Tensor, Tensor]:
    """Each point's (B, N) 0-based label (-1 = background), (B, N, 4) ltrb
    target and (B, N) centerness target. Among equal areas the first gt wins,
    as ``jnp.argmin`` picks it."""
    x, y = points[None, :, None, 0], points[None, :, None, 1]  # (1, N, 1)
    ltrb = torch.stack([x - gt_boxes[:, None, :, 0], y - gt_boxes[:, None, :, 1],
                        gt_boxes[:, None, :, 2] - x, gt_boxes[:, None, :, 3] - y], dim=-1)
    inside = ltrb.amin(-1) > 0.0
    max_dist = ltrb.amax(-1)  # (B, N, G)
    in_range = (max_dist >= ranges[None, :, None, 0]) & (max_dist <= ranges[None, :, None, 1])
    areas = (gt_boxes[..., 2] - gt_boxes[..., 0]) * (gt_boxes[..., 3] - gt_boxes[..., 1])
    cand = inside & in_range & gt_valid[:, None, :]
    masked = torch.where(cand, areas[:, None, :], torch.full_like(max_dist, INF))
    gi = masked.argmin(dim=-1)  # (B, N), the first of equal minima
    has = torch.gather(cand, 2, gi[..., None])[..., 0]
    labels = torch.gather(gt_labels.long(), 1, gi)
    label0 = torch.where(has, labels - 1, torch.full_like(labels, -1))
    tgt = _take(ltrb, gi)
    return label0, tgt, torch.where(has, centerness(tgt), torch.zeros_like(tgt[..., 0]))


def flatten_outputs(num_classes: int, cls_scores, bbox_preds, centernesses=None):
    """Per-level NHWC outputs -> (B, N, C) logits in the head's dtype,
    (B, N, R) float32 regression and (B, N) float32 centerness logits."""
    b = cls_scores[0].shape[0]
    fc = torch.cat([s.reshape(b, -1, num_classes) for s in cls_scores], dim=1)
    r = bbox_preds[0].shape[-1]
    fr = torch.cat([p.reshape(b, -1, r).float() for p in bbox_preds], dim=1)
    if centernesses is None:
        return fc, fr
    return fc, fr, torch.cat([c.reshape(b, -1).float() for c in centernesses], dim=1)


def per_image_mean(total: Tensor, factor: Tensor) -> Tensor:
    """The mean over the images of each image's (B,) ``total`` divided by
    its ``max(factor, 1)``, as the reference's per-image ``_reduce``."""
    return (total / factor.clamp(min=1.0)).mean()


def points_to_boxes(points: Tensor, ltrb: Tensor) -> Tensor:
    """(..., 2) points and (..., 4) ltrb distances -> xyxy boxes."""
    return torch.stack([points[..., 0] - ltrb[..., 0], points[..., 1] - ltrb[..., 1],
                        points[..., 0] + ltrb[..., 2], points[..., 1] + ltrb[..., 3]], dim=-1)


def fcos_loss(
    cfg: FCOSConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    centernesses: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> Dict[str, Tensor]:
    """The focal loss over the positives' count, GIoU (offset 0: the points
    are continuous) weighted by the centerness target over its sum, and the
    centerness BCE over the positives' count; each per image, then averaged
    over the images."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    points, ranges = flat_points(cfg, featmap_sizes, gt_boxes.device)
    fc, fr, fct = flatten_outputs(cfg.num_classes, cls_scores, bbox_preds, centernesses)
    label0, tgt, ctr_t = fcos_targets(cfg, points, ranges, gt_boxes, gt_labels, gt_valid)
    b = gt_boxes.shape[0]
    pos = label0 >= 0
    num_pos = pos.sum(dim=1).float()
    per_image = (1.0 / (b * num_pos.clamp(min=1.0)))[:, None, None]
    loss_cls = sigmoid_focal_loss_sparse(fc, label0, weight=per_image, gamma=cfg.focal_gamma,
                                         alpha=cfg.focal_alpha)
    pred_boxes = points_to_boxes(points, torch.exp(fr))
    tgt_boxes = points_to_boxes(points, tgt)
    ctr_w = torch.where(pos, ctr_t, torch.zeros_like(ctr_t))
    giou = iou_loss_elementwise(pred_boxes, tgt_boxes, mode="giou", offset=0.0)
    loss_reg = per_image_mean((giou * ctr_w).sum(1), ctr_w.sum(1))
    loss_ctr = binary_cross_entropy(fct, ctr_t, weight=pos.float() * per_image[..., 0])
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss_centerness": loss_ctr,
            "loss": loss_cls + loss_reg + loss_ctr, "num_pos": num_pos.mean()}


def preselect_levels(num_classes: int, k_max: int, cls_scores, level_tensors
                     ) -> Tuple[List[Tensor], List[List[Tensor]]]:
    """Each level's top ``k_max`` positions by their best class logit
    (``top_k_stable``: bf16 logits tie often, and the lower index goes
    first, as XLA's ``top_k``), every image at once. ``level_tensors[i]`` is
    level i's list of (B, n_l, D) or image-shared (n_l, D) tensors to
    select with the logits. Returns each level's selected
    float32 logits and its selected tensors, float32 where they are
    floating, every one with the batch axis."""
    b = cls_scores[0].shape[0]
    logits, selected = [], []
    for s_l, tensors in zip(cls_scores, level_tensors, strict=True):
        s = s_l.reshape(b, -1, num_classes)
        n_l = s.shape[1]
        k = min(k_max, n_l)
        picked = []
        if k < n_l:
            _, idx = top_k_stable(s.amax(dim=-1), k)  # the cast to float32 keeps the order
            s = torch.gather(s, 1, idx[..., None].expand(-1, -1, num_classes))
            for t in tensors:
                if t.dim() == 2:  # (n_l, D): shared by the images
                    picked.append(t[idx])
                else:
                    picked.append(torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1])))
        else:
            picked = [t[None].expand(b, *t.shape) if t.dim() == 2 else t for t in tensors]
        logits.append(s.float())
        selected.append([t.float() if t.is_floating_point() else t for t in picked])
    return logits, selected


def dense_nms(cfg, scores: Tensor, boxes: Tensor,
              scale_factors: Optional[Tensor] = None) -> NMSResult:
    """Class-wise NMS of the (B, M, C) scores and (B, M, 4) boxes of
    FCOS's, ATSS's or GFL's candidates, the scale factors undone."""
    res = multiclass_nms(boxes, scores, iou_thr=cfg.nms_iou_thr, score_thr=cfg.score_thr,
                         pre_nms_top_k=cfg.pre_nms_top_k, max_out=cfg.max_detections)
    if scale_factors is None:
        return res
    b = res.boxes.shape[0]
    return res._replace(boxes=res.boxes / scale_factors.reshape(b, 1, -1).to(res.boxes.dtype))


def fcos_candidates(cfg: FCOSConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                    centernesses: Sequence[Tensor], img_shapes: Optional[Tensor] = None
                    ) -> Tuple[Tensor, Tensor]:
    """Per-level preselection and the point decode: (B, M, C)
    sigmoid(cls) * sigmoid(centerness) and (B, M, 4) boxes, clipped to each
    image's (h, w) when ``img_shapes`` is given."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    b = cls_scores[0].shape[0]
    device = cls_scores[0].device
    level = [[level_points(size, stride, device), r.reshape(b, -1, 4), c.reshape(b, -1, 1)]
             for size, stride, r, c in zip(featmap_sizes, cfg.strides, bbox_preds, centernesses,
                                           strict=True)]
    logits, sel = preselect_levels(cfg.num_classes, cfg.pre_select_per_level, cls_scores, level)
    pts, regs, ctr = (torch.cat([s[i] for s in sel], dim=1) for i in range(3))
    boxes = points_to_boxes(pts, torch.exp(regs))
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.sigmoid(torch.cat(logits, dim=1)) * torch.sigmoid(ctr), boxes


def decode_fcos(
    cfg: FCOSConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    centernesses: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> NMSResult:
    """Per-level preselection -> point decode -> NMS on
    sigmoid(cls) * sigmoid(centerness), padded to (B, max_detections)."""
    return dense_nms(cfg, *fcos_candidates(cfg, cls_scores, bbox_preds, centernesses, img_shapes),
                     scale_factors)


def fcos_inference(cfg: FCOSConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                   scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_fcos``."""
    return decode_fcos(cfg, *model(images), img_shapes, scale_factors)
