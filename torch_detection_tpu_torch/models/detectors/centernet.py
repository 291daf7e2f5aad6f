"""CenterNet ("Objects as Points"): config, targets, the loss, the decode.

Counterpart of ``torch_detection_tpu/models/detectors/centernet.py``,
batched over the images. The model is ``SingleStageDetector`` with a
``ResNet`` (C5 alone), ``CTResNetNeck`` and ``CenterNetHead``; no anchors
and no NMS.

* Targets: each gt's centre and size in feature cells (``down_ratio``,
  boxes xyxy inclusive, +1), its Gaussian radius (the corrected CornerNet
  quadratic), ``radius = floor(max(r, 0))`` and sigma ``(2 radius + 1) /
  6``. The reference folds one gt at a time into an (H, W, C) map with a
  maximum; here every gt's windowed Gaussian is one (B, G, H, W) tensor,
  masked to 0 for an invalid gt, and ``scatter_reduce(..., "amax")`` puts
  it into (B, C, H * W) by label. A maximum does not depend on order, so
  the map is the reference's fold, never building a (G, H, W, C) tensor.
  The Gaussian is the reference's float32 expression ``-(dx^2 + dy^2) /
  (2 sigma^2 + 1e-12)`` within ``|dx|, |dy| <= radius``, its exp taken in
  float64 and rounded to float32, and every division a correctly rounded
  one (``_div``): the same bits on every device (XLA's and CUDA's float32
  exps each stay within an ulp of the correctly rounded one, and both
  divide by a constant as a product by its reciprocal).
* Loss: the penalty-reduced focal loss (alpha 2, beta 4) over the heatmap,
  positives where the target is 1 (the valid centres), and L1 on the size
  and offset at the centre cells; all over the batch's count of valid gts
  (at least 1), the reported ``num_pos`` that count over the images.
* Decode: sigmoid in float32, a 3 x 3 SAME max-pool, the cells equal to it
  kept (every cell of a plateau), then the top ``max_detections`` of the
  (H * W * C) scores in NHWC order (index cell * C + class), the lower
  index first among ties (``top_k_stable``, as XLA's ``top_k``); boxes
  from the size and offset at each cell, scores over ``score_thr`` valid.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from ...ops.boxes import clip_boxes
from ...ops.nms import NMSResult, top_k_stable
from ...parallel.distributed import batch_normaliser
from ..layers import max_pool_same


@dataclasses.dataclass(frozen=True)
class CenterNetConfig:
    """The reference's ``CenterNetConfig`` with its defaults."""

    num_classes: int = 80
    down_ratio: int = 4
    min_overlap: float = 0.3  # the Gaussian radius's IoU bound
    heat_weight: float = 1.0
    wh_weight: float = 0.1
    off_weight: float = 1.0
    # inference
    score_thr: float = 0.05
    max_detections: int = 100
    # read by the evaluator's plumbing; CenterNet itself runs no NMS
    nms_iou_thr: float = 0.5


def _div(x: Tensor, divisor: float) -> Tensor:
    """``x / divisor`` correctly rounded on every device: CUDA divides by a
    Python scalar as a product by its reciprocal, which for 6 or 1.3 is an
    ulp off the quotient, so the divisor is a 0-d tensor on ``x``'s device."""
    return x / torch.full((), divisor, dtype=x.dtype, device=x.device)


def gaussian_radius(h: Tensor, w: Tensor, min_overlap: float) -> Tensor:
    """The radius within which a centre keeps IoU >= ``min_overlap`` with
    the (h, w) box, elementwise; the corrected quadratic roots."""
    b1 = h + w
    c1 = _div(w * h * (1.0 - min_overlap), 1.0 + min_overlap)
    r1 = (b1 - torch.sqrt((b1 * b1 - 4.0 * c1).clamp(min=0.0))) / 2.0
    b2 = 2.0 * (h + w)
    c2 = (1.0 - min_overlap) * w * h
    r2 = (b2 - torch.sqrt((b2 * b2 - 16.0 * c2).clamp(min=0.0))) / 8.0
    a3 = 4.0 * min_overlap
    b3 = -2.0 * min_overlap * (h + w)
    c3 = (min_overlap - 1.0) * w * h
    r3 = _div(b3 + torch.sqrt((b3 * b3 - 4.0 * a3 * c3).clamp(min=0.0)), 2.0 * a3)
    return torch.minimum(torch.minimum(r1, r2), r3)


class CenterNetTargets(NamedTuple):
    heat: Tensor  # (B, H, W, C) float32, NHWC view of channels_last memory
    wh: Tensor  # (B, G, 2) size in cells
    offset: Tensor  # (B, G, 2) centre's offset in its cell
    ind: Tensor  # (B, G) int64 centre cell, y * W + x
    mask: Tensor  # (B, G) bool valid gt with a positive size


def centernet_targets(
    cfg: CenterNetConfig,
    featmap_size: Tuple[int, int],
    gt_boxes: Tensor,  # (B, G, 4) xyxy image coordinates
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> CenterNetTargets:
    """Every image's heatmap, size, offset, centre cell and mask."""
    hh, ww = featmap_size
    dr = float(cfg.down_ratio)
    boxes = gt_boxes.float()
    w_f = (boxes[..., 2] - boxes[..., 0] + 1.0) / dr
    h_f = (boxes[..., 3] - boxes[..., 1] + 1.0) / dr
    cx_f = 0.5 * (boxes[..., 0] + boxes[..., 2]) / dr
    cy_f = 0.5 * (boxes[..., 1] + boxes[..., 3]) / dr
    mask = gt_valid & (w_f > 0) & (h_f > 0)
    cx_i = torch.floor(cx_f).clamp(0, ww - 1)
    cy_i = torch.floor(cy_f).clamp(0, hh - 1)
    radius = torch.floor(gaussian_radius(h_f, w_f, cfg.min_overlap).clamp(min=0.0))
    sigma = _div(2.0 * radius + 1.0, 6.0)

    # every gt's windowed Gaussian, (B, G, H, W)
    device = boxes.device
    dx = torch.arange(ww, dtype=torch.float32, device=device) - cx_i[..., None]  # (B, G, W)
    dy = torch.arange(hh, dtype=torch.float32, device=device) - cy_i[..., None]  # (B, G, H)
    arg = -(dx[..., None, :] ** 2 + dy[..., :, None] ** 2) / (2.0 * sigma ** 2 + 1e-12)[
        ..., None, None]
    label0 = gt_labels.long() - 1
    c = cfg.num_classes
    # an invalid gt, or a label outside [1, C] (the reference's one-hot of it is 0), adds nothing
    keep = mask & (label0 >= 0) & (label0 < c)
    window = ((dx.abs() <= radius[..., None])[..., None, :]
              & (dy.abs() <= radius[..., None])[..., :, None] & keep[..., None, None])
    g2d = torch.exp(arg.double()).to(torch.float32)  # correctly rounded (module docstring)
    contrib = torch.where(window, g2d, torch.zeros_like(g2d))

    b, g = gt_boxes.shape[:2]
    index = label0.clamp(0, c - 1)[..., None].expand(b, g, hh * ww)
    heat = torch.zeros((b, c, hh * ww), dtype=torch.float32, device=device)
    heat = heat.scatter_reduce(1, index, contrib.reshape(b, g, hh * ww), "amax")
    heat = heat.reshape(b, c, hh, ww).contiguous(memory_format=torch.channels_last)
    return CenterNetTargets(heat.permute(0, 2, 3, 1), torch.stack([w_f, h_f], dim=-1),
                            torch.stack([cx_f - cx_i, cy_f - cy_i], dim=-1),
                            (cy_i * ww + cx_i).long(), mask)


def _at_cells(pred: Tensor, ind: Tensor) -> Tensor:
    """(B, H, W, D) -> float32 (B, K, D) at the (B, K) cells ``ind``."""
    flat = pred.reshape(pred.shape[0], -1, pred.shape[-1]).float()
    return torch.gather(flat, 1, ind[..., None].expand(-1, -1, flat.shape[-1]))


def centernet_loss(
    cfg: CenterNetConfig,
    heat_pred: Tensor,  # (B, H, W, C) logits
    wh_pred: Tensor,  # (B, H, W, 2)
    off_pred: Tensor,  # (B, H, W, 2)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G)
    gt_valid: Tensor,  # (B, G)
) -> Dict[str, Tensor]:
    b, hh, ww, _ = heat_pred.shape
    t = centernet_targets(cfg, (hh, ww), gt_boxes, gt_labels, gt_valid)
    p = torch.sigmoid(heat_pred.float()).clamp(1e-6, 1.0 - 1e-6)
    pos = t.heat >= 1.0 - 1e-6  # exactly 1.0 at the valid centres
    num_pos = batch_normaliser(t.mask.to(torch.float32).sum())
    zero = torch.zeros((), dtype=torch.float32, device=p.device)
    # the penalty-reduced focal loss (alpha 2, beta 4)
    pos_loss = torch.where(pos, -((1.0 - p) ** 2) * torch.log(p), zero)
    neg_loss = torch.where(pos, zero, -((1.0 - t.heat) ** 4) * (p ** 2) * torch.log(1.0 - p))
    loss_heat = (pos_loss.sum() + neg_loss.sum()) / num_pos
    w = t.mask.to(torch.float32)[..., None]
    loss_wh = ((_at_cells(wh_pred, t.ind) - t.wh).abs() * w).sum() / (num_pos * 2.0)
    loss_off = ((_at_cells(off_pred, t.ind) - t.offset).abs() * w).sum() / (num_pos * 2.0)
    total = cfg.heat_weight * loss_heat + cfg.wh_weight * loss_wh + cfg.off_weight * loss_off
    return {"loss": total, "loss_heatmap": loss_heat, "loss_wh": loss_wh, "loss_offset": loss_off,
            "num_pos": num_pos / b}


def centernet_peaks(heat_pred: Tensor) -> Tensor:
    """(B, H, W, C) logits -> float32 (B, H * W * C) scores in NHWC order:
    sigmoid, zero where under its 3 x 3 SAME max-pool."""
    p = torch.sigmoid(heat_pred.float())
    pooled = max_pool_same(p.permute(0, 3, 1, 2), 3, 1).permute(0, 2, 3, 1)
    return torch.where(p == pooled, p, torch.zeros_like(p)).reshape(p.shape[0], -1)


def decode_centernet(
    cfg: CenterNetConfig,
    heat_pred: Tensor,  # (B, H, W, C) logits
    wh_pred: Tensor,  # (B, H, W, 2)
    off_pred: Tensor,  # (B, H, W, 2)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Peaks, the top ``max_detections`` (ties to the lower NHWC index),
    the boxes at their cells; ``indices`` are the cells."""
    b, hh, ww, c = heat_pred.shape
    dr = float(cfg.down_ratio)
    scores, idx = top_k_stable(centernet_peaks(heat_pred), min(cfg.max_detections, hh * ww * c))
    cls = idx % c
    cell = idx // c
    cx = (cell % ww).to(torch.float32)
    cy = (cell // ww).to(torch.float32)
    wh_g, off_g = _at_cells(wh_pred, cell), _at_cells(off_pred, cell)
    cx_img = (cx + off_g[..., 0]) * dr
    cy_img = (cy + off_g[..., 1]) * dr
    w_img = wh_g[..., 0] * dr
    h_img = wh_g[..., 1] * dr
    x1 = cx_img - 0.5 * (w_img - 1.0)
    y1 = cy_img - 0.5 * (h_img - 1.0)
    boxes = torch.stack([x1, y1, x1 + w_img - 1.0, y1 + h_img - 1.0], dim=-1)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    if scale_factors is not None:
        boxes = boxes / scale_factors.reshape(b, 1, -1).to(boxes.dtype)
    valid = scores > cfg.score_thr
    return NMSResult(boxes, scores, torch.where(valid, cls, torch.full_like(cls, -1)), valid, cell)


def centernet_inference(cfg: CenterNetConfig, model, images: Tensor,
                        img_shapes: Optional[Tensor] = None,
                        scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_centernet``."""
    return decode_centernet(cfg, *model(images), img_shapes, scale_factors)
