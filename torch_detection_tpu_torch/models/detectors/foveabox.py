"""FoveaBox: fovea-region targets, focal + log-space smooth-L1, and the
decode.

Counterpart of ``torch_detection_tpu/models/detectors/foveabox.py``,
batched over the images: a gt is routed to the levels whose sqrt-area band
holds its scale, and a point of such a level is a candidate where it lies
in the sigma-shrunk fovea of the box, or in the cell that holds the box's
centre (at least one positive on every assigned level), and strictly
inside the box; each point takes the smallest-area candidate gt, the first
on a tie (a masked argmin over the (B, N, G) candidates). Regression is
log-space against the level's ``base_edge``: ``t = log((px - x1) / base)``,
clipped to [1/16, 16] before the log; the decode is ``base * exp(t)`` with
no clamp, as the reference's. The reference's ``take_per_row`` and
``gather_rows`` are plain indexing here. The head is
``SingleStageDetector`` with ``FoveaHead``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import Tensor

from ...ops.boxes import clip_boxes
from ...ops.losses import sigmoid_focal_loss_sparse
from ...ops.nms import NMSResult
from .fcos import dense_nms, flatten_outputs, level_points, preselect_levels

INF = 1e8


@dataclasses.dataclass(frozen=True)
class FoveaConfig:
    """The reference's ``FoveaConfig`` with its defaults, less
    ``approx_top_k``."""

    num_classes: int = 80
    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    base_edges: Tuple[float, ...] = (16.0, 32.0, 64.0, 128.0, 256.0)
    # per-level sqrt-area bands; overlapping on purpose (one gt may train
    # two adjacent levels)
    scale_ranges: Tuple[Tuple[float, float], ...] = (
        (1.0, 64.0), (32.0, 128.0), (64.0, 256.0), (128.0, 512.0), (256.0, 2048.0))
    sigma: float = 0.4  # fovea shrink factor
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    smooth_l1_beta: float = 0.11
    reg_loss_weight: float = 1.0
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    pre_select_per_level: int = 1000
    pre_nms_top_k: int = 1000
    max_detections: int = 100


def flat_geometry(cfg: FoveaConfig, featmap_sizes, device=None
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Every level's points (N, 2), and each point's (N,) stride, (N,)
    base edge and (N, 2) sqrt-area band."""
    pts, strides, bases, bands = [], [], [], []
    for size, stride, base, band in zip(featmap_sizes, cfg.strides, cfg.base_edges,
                                        cfg.scale_ranges, strict=True):
        p = level_points(size, stride, device)
        n = p.shape[0]
        pts.append(p)
        strides.append(torch.full((n,), float(stride), device=device))
        bases.append(torch.full((n,), float(base), device=device))
        bands.append(torch.tensor(band, dtype=torch.float32, device=device).expand(n, 2))
    return torch.cat(pts), torch.cat(strides), torch.cat(bases), torch.cat(bands)


def fovea_targets(
    cfg: FoveaConfig,
    points: Tensor,  # (N, 2)
    strides: Tensor,  # (N,)
    bases: Tensor,  # (N,)
    bands: Tensor,  # (N, 2)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> Tuple[Tensor, Tensor]:
    """Each point's (B, N) 0-based label (-1 = background) and (B, N, 4)
    log-space targets."""
    x, y = points[None, :, None, 0], points[None, :, None, 1]  # (1, N, 1)
    x1, y1, x2, y2 = (gt_boxes[:, None, :, i] for i in range(4))  # (B, 1, G)
    w, h = x2 - x1, y2 - y1
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    scale = torch.sqrt(torch.clamp(w * h, min=0.0))
    in_band = (scale >= bands[None, :, None, 0]) & (scale <= bands[None, :, None, 1])
    in_fovea = ((x - cx).abs() <= 0.5 * cfg.sigma * w) & ((y - cy).abs() <= 0.5 * cfg.sigma * h)
    half_cell = 0.5 * strides[None, :, None]
    center_cell = ((x - cx).abs() <= half_cell) & ((y - cy).abs() <= half_cell)
    inside = (x > x1) & (x < x2) & (y > y1) & (y < y2)
    cand = in_band & (in_fovea | center_cell) & inside & gt_valid[:, None, :]
    areas = (w * h)[:, 0]  # (B, G)
    masked = torch.where(cand, areas[:, None, :], INF)
    gi = masked.argmin(dim=-1)  # (B, N), the first of equal minima
    has = torch.gather(cand, 2, gi[..., None])[..., 0]
    labels = torch.gather(gt_labels.long(), 1, gi)
    label0 = torch.where(has, labels - 1, torch.full_like(labels, -1))
    g = torch.gather(gt_boxes, 1, gi[..., None].expand(-1, -1, 4))  # (B, N, 4)
    px, py = points[None, :, 0], points[None, :, 1]
    ratios = torch.stack([px - g[..., 0], py - g[..., 1], g[..., 2] - px, g[..., 3] - py],
                         dim=-1) / bases[None, :, None]
    return label0, torch.log(torch.clamp(ratios, 1.0 / 16.0, 16.0))


def fovea_loss(
    cfg: FoveaConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> Dict[str, Tensor]:
    """The focal loss over the positives' count and the smooth L1 of the
    positives over 4 times that count; each per image, then averaged over
    the images. It takes no ``img_shape``, as the reference's."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    geometry = flat_geometry(cfg, featmap_sizes, gt_boxes.device)
    fc, fr = flatten_outputs(cfg.num_classes, cls_scores, bbox_preds)
    label0, tgt = fovea_targets(cfg, *geometry, gt_boxes, gt_labels, gt_valid)
    b = gt_boxes.shape[0]
    pos = label0 >= 0
    num_pos = pos.sum(dim=1).float()
    per_image = 1.0 / (b * num_pos.clamp(min=1.0))
    loss_cls = sigmoid_focal_loss_sparse(fc, label0, weight=per_image[:, None, None],
                                         gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    diff = (fr - tgt).abs()
    beta = cfg.smooth_l1_beta
    huber = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    reg = (huber * pos[..., None].float()).sum(dim=(1, 2))
    loss_reg = cfg.reg_loss_weight * (reg / (num_pos.clamp(min=1.0) * 4.0)).mean()
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss": loss_cls + loss_reg,
            "num_pos": num_pos.mean()}


def fovea_candidates(cfg: FoveaConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                     img_shapes: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Per-level preselection and the log-space decode: (B, M, C)
    sigmoid(cls) and (B, M, 4) boxes ``point -+ base * exp(reg)``, clipped
    to each image's (h, w) when ``img_shapes`` is given."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    b = cls_scores[0].shape[0]
    device = cls_scores[0].device
    level = [[level_points(size, stride, device), r.reshape(b, -1, 4)]
             for size, stride, r in zip(featmap_sizes, cfg.strides, bbox_preds, strict=True)]
    logits, sel = preselect_levels(cfg.num_classes, cfg.pre_select_per_level, cls_scores, level)
    base = torch.cat([torch.full(s[0].shape[:2], float(e), device=device)
                      for s, e in zip(sel, cfg.base_edges)], dim=1)
    pts, regs = (torch.cat([s[i] for s in sel], dim=1) for i in range(2))
    dist = base[..., None] * torch.exp(regs)
    boxes = torch.stack([pts[..., 0] - dist[..., 0], pts[..., 1] - dist[..., 1],
                         pts[..., 0] + dist[..., 2], pts[..., 1] + dist[..., 3]], dim=-1)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.sigmoid(torch.cat(logits, dim=1)), boxes


def decode_fovea(
    cfg: FoveaConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> NMSResult:
    """Per-level preselection -> base_edge * exp decode -> class-wise NMS,
    padded to (B, max_detections)."""
    return dense_nms(cfg, *fovea_candidates(cfg, cls_scores, bbox_preds, img_shapes),
                     scale_factors)


def fovea_inference(cfg: FoveaConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                    scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_fovea``."""
    return decode_fovea(cfg, *model(images), img_shapes, scale_factors)
