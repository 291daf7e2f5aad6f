"""SOLOv2: dense instance segmentation by location (no boxes, anchors or
RoIAlign), its targets, loss and decode.

Counterpart of ``torch_detection_tpu/models/detectors/solov2.py``, batched
over the images. Each FPN level is an S x S grid; a cell inside an
object's mass-centre region predicts its class and an E-vector, a dynamic
1 x 1 conv over the stride-4 mask features. Suppression is Matrix NMS.

* Targets (``solov2_targets``): the gt masks are pooled to stride 4 as an
  integer count of each 4 x 4 window (more than half set: the reference's
  float32 mean over 0.5, bit for bit, without a float32 copy of the
  (B, G, H, W) masks); the mass centres from exact integer moments rounded
  once to float32. A division by the canvas followed by a product by the
  grid size is one product by float32's ``fl(1 / h) * S``, as XLA compiles
  the reference's under jit, so every device finds the same cells.
  Overlaps go to the smallest-area gt, the first among equal areas.
  ``solov2_loss`` takes the gts up to the masks' count: the collate pads
  ``gt_masks`` to a bucket of at most ``max_gts`` rows, the valid gts
  first (R12: the reference's loss breaks there, its (G,) gts against the
  (G_mask,) masks).
* The slate, the flat top 256 of the decode, its re-sort and the final top
  100 take ``top_k_stable`` (ties to the lower index, as XLA's ``top_k``).
* Float32 with autocast and TF32 off (``ops/matmul.py``): the dynamic conv
  of the loss and the decode, the mask IoU, the crops' hat-function
  matmuls and the decode.
* The decode sets the Matrix-NMS score of every candidate not above
  ``score_thr`` to 0 before the final top-k (official SOLOv2; R3: the
  reference lets such a candidate through when its score is above
  ``update_thr``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from ...ops.boxes import clip_boxes
from ...ops.losses import dice_loss, sigmoid_focal_loss_sparse
from ...ops.matmul import float32_matmul
from ...ops.nms import NMSResult, matrix_nms, take_rows, top_k_stable
from ...utils.device import resolve_device
from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from ..layers import compute_autocast
from .mask_rcnn import MaskDetections

INF = 1e8


@DETECTORS.register_module
class SOLOV2(nn.Module):
    """backbone + neck + ``SOLOV2Head`` (``head``) + ``MaskFeatHead``
    (``mask_feat_head``), the reference's names. ``forward`` -> (per-level
    (B, S, S, C) logits, per-level (B, S, S, E) kernels, (B, H/4, W/4, E)
    mask features). ``dtype``, ``param_dtype`` and ``device`` as
    ``SingleStageDetector``'s."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], head: Dict[str, Any],
                 mask_feat_head: Dict[str, Any], dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.param_dtype = param_dtype or self.dtype
        kw = dict(dtype=self.param_dtype, device=resolve_device(device))
        self.backbone = BACKBONES.build(dict(backbone), **kw)
        self.neck = NECKS.build(dict(neck), **kw)
        self.head = HEADS.build(dict(head), **kw)
        self.mask_feat_head = HEADS.build(dict(mask_feat_head), **kw)

    def _autocast(self, x: Tensor):
        return compute_autocast(x, self.dtype, self.param_dtype)

    def features(self, images: Tensor) -> Tuple[Tensor, ...]:
        """NHWC images -> the FPN levels."""
        x = images.to(self.dtype).contiguous()
        with self._autocast(x):
            return self.neck(self.backbone(x))

    def heads(self, feats: Sequence[Tensor]):
        """FPN levels -> (class logits, kernels, mask features)."""
        with self._autocast(feats[0]):
            cls_scores, kernels = self.head(feats)
            return cls_scores, kernels, self.mask_feat_head(feats)

    def forward(self, images: Tensor):
        return self.heads(self.features(images))


@dataclasses.dataclass(frozen=True)
class SOLOV2Config:
    """The reference's ``SOLOV2Config`` with its defaults, less
    ``approx_top_k`` (a TPU approximation)."""

    num_classes: int = 80
    grid_numbers: Tuple[int, ...] = (40, 36, 24, 16, 12)
    # sqrt(box area) band of each level (official SOLOv2 ranges)
    scale_ranges: Tuple[Tuple[float, float], ...] = (
        (1.0, 96.0), (48.0, 192.0), (96.0, 384.0), (192.0, 768.0), (384.0, 2048.0))
    sigma: float = 0.2  # centre-region shrink
    mask_stride: int = 4
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    dice_weight: float = 3.0
    max_pos_cells: int = 256  # the mask loss's slate, positives first
    # inference
    score_thr: float = 0.1
    update_thr: float = 0.05  # Matrix-NMS score floor
    mask_thr: float = 0.5
    pre_nms_top_k: int = 256
    max_detections: int = 100
    nms_method: str = "gauss"
    nms_sigma: float = 2.0
    mask_out_size: int = 28  # the (M, M) patch of the mask paste protocol

    def __post_init__(self):
        if len(self.grid_numbers) != len(self.scale_ranges):
            raise ValueError(f"{len(self.grid_numbers)} grids for {len(self.scale_ranges)} "
                             "scale ranges")
        if self.nms_method not in ("gauss", "linear"):
            raise ValueError(f"nms_method {self.nms_method!r} is not 'gauss' or 'linear'")

    @property
    def num_cells(self) -> int:
        return sum(s * s for s in self.grid_numbers)


def _ratio(num: int, den: float) -> float:
    """float32's ``fl(fl(1 / den) * num)``: XLA's product for the
    reference's ``x / den * num`` under jit (module docstring)."""
    return float(np.float32(1.0) / np.float32(den) * np.float32(num))


def downsample_masks(gt_masks: Tensor, stride: int) -> Tensor:
    """(B, G, H, W) uint8 -> (B, G, H/stride, W/stride) float32 in {0, 1}:
    a window's values summed as integers, set where the sum exceeds half
    the window (the reference's float32 mean over 0.5)."""
    b, g, h, w = gt_masks.shape
    x = gt_masks.reshape(b, g, h // stride, stride, w // stride, stride)
    return (x.sum(dim=(3, 5), dtype=torch.int32) > (stride * stride) // 2).float()


def solov2_targets(
    cfg: SOLOV2Config,
    gt_boxes: Tensor,  # (B, G, 4) xyxy canvas coordinates
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    ds_masks: Tensor,  # (B, G, H4, W4) stride-4 binary masks
    canvas_hw: Tuple[int, int],
) -> Tuple[Tensor, Tensor]:
    """Every level's cells -> (B, N) 0-based class (-1 background) and
    (B, N) matched gt. A cell is positive for a gt whose sqrt-area lies in
    the level's band where it lies inside the gt's sigma-shrunk region
    around its mass centre, clamped to the centre's cell +- 1; overlaps go
    to the smallest-area gt."""
    h_img, w_img = float(canvas_hw[0]), float(canvas_hw[1])
    stride = cfg.mask_stride
    # each row's and column's count, exact in float32, then float64 moments
    rows, cols = ds_masks.sum(dim=3).double(), ds_masks.sum(dim=2).double()
    device = ds_masks.device
    ys = (torch.arange(rows.shape[-1], dtype=torch.float64, device=device) + 0.5) * stride
    xs = (torch.arange(cols.shape[-1], dtype=torch.float64, device=device) + 0.5) * stride
    count = rows.sum(dim=-1).float()
    tot = count.clamp(min=1e-6)
    # exact moments, each rounded once to float32
    cm_y = (rows * ys).sum(dim=-1).float() / tot
    cm_x = (cols * xs).sum(dim=-1).float() / tot
    has_mask = count > 0

    boxes = gt_boxes.float()
    bw = (boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
    bh = (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0)
    areas = bw * bh
    scale = torch.sqrt(areas)
    half_w = 0.5 * bw * cfg.sigma
    half_h = 0.5 * bh * cfg.sigma

    label_parts, gt_parts = [], []
    for s, (lo, hi) in zip(cfg.grid_numbers, cfg.scale_ranges):
        in_band = (scale >= lo) & (scale <= hi) & gt_valid & has_mask  # (B, G)
        fy, fx = _ratio(s, h_img), _ratio(s, w_img)

        def cell(v: Tensor, f: float) -> Tensor:
            return torch.floor(v * f).clamp(0, s - 1)

        ci, cj = cell(cm_y, fy), cell(cm_x, fx)
        top = torch.maximum(cell(cm_y - half_h, fy), ci - 1)
        down = torch.minimum(cell(cm_y + half_h, fy), ci + 1)
        left = torch.maximum(cell(cm_x - half_w, fx), cj - 1)
        right = torch.minimum(cell(cm_x + half_w, fx), cj + 1)

        ii = torch.arange(s, dtype=torch.float32, device=device)[None, :, None]
        rows_in = (ii >= top[:, None, :]) & (ii <= down[:, None, :])  # (B, S, G)
        cols_in = (ii >= left[:, None, :]) & (ii <= right[:, None, :])
        cand = rows_in[:, :, None, :] & cols_in[:, None, :, :] & in_band[:, None, None, :]
        cand = cand.reshape(cand.shape[0], s * s, -1)  # (B, S^2, G)
        gi = torch.where(cand, areas[:, None, :], INF).argmin(dim=-1)  # smallest area, first
        lab = torch.gather(gt_labels.long(), 1, gi) - 1
        label_parts.append(torch.where(cand.any(dim=-1), lab, -1))
        gt_parts.append(gi)
    return torch.cat(label_parts, dim=1), torch.cat(gt_parts, dim=1)


def flatten_levels(cls_scores: Sequence[Tensor], kernels: Sequence[Tensor]
                   ) -> Tuple[Tensor, Tensor]:
    """Per-level (B, S, S, C) and (B, S, S, E) -> (B, N, C) and (B, N, E),
    the levels in order, each row-major."""
    b = cls_scores[0].shape[0]
    return (torch.cat([s.reshape(b, -1, s.shape[-1]) for s in cls_scores], dim=1),
            torch.cat([k.reshape(b, -1, k.shape[-1]) for k in kernels], dim=1))


def _mask_matrix(mask_feat: Tensor) -> Tensor:
    """(B, H4, W4, E) -> float32 (B, E, H4 * W4)."""
    b, h4, w4, e = mask_feat.shape
    return mask_feat.float().reshape(b, h4 * w4, e).transpose(1, 2)


def solov2_loss(
    cfg: SOLOV2Config,
    cls_scores: Sequence[Tensor],
    kernels: Sequence[Tensor],
    mask_feat: Tensor,  # (B, H4, W4, E)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G)
    gt_valid: Tensor,  # (B, G)
    gt_masks: Tensor,  # (B, G_mask, H, W) uint8, G_mask <= G, the valid gts first
) -> Dict[str, Tensor]:
    """The focal loss over every cell and class and ``dice_weight`` times
    the dice loss of the positive cells' masks (a slate of
    ``max_pos_cells``, positives first), each image's over its own
    positive count (at least 1), averaged over the images."""
    fc, fk = flatten_levels(cls_scores, kernels)
    b, h4, w4, _ = mask_feat.shape
    g = gt_masks.shape[1]
    ds = downsample_masks(gt_masks, cfg.mask_stride)
    label0, gtidx = solov2_targets(cfg, gt_boxes[:, :g], gt_labels[:, :g], gt_valid[:, :g], ds,
                                   (h4 * cfg.mask_stride, w4 * cfg.mask_stride))
    pos = label0 >= 0
    num_pos = pos.sum(dim=1).float()
    per_image = 1.0 / (b * num_pos.clamp(min=1.0))  # one sum = the mean of the images' losses
    loss_cls = sigmoid_focal_loss_sparse(fc, label0, weight=per_image[:, None, None],
                                         gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)

    flag, idx = top_k_stable(pos.float(), min(cfg.max_pos_cells, pos.shape[1]))
    logits = float32_matmul(take_rows(fk, idx), _mask_matrix(mask_feat))  # (B, P, H4 * W4)
    targets = take_rows(ds.reshape(b, g, -1), torch.gather(gtidx, 1, idx))
    weight = (flag > 0.5).float() * per_image[:, None]
    loss_mask = dice_loss(torch.sigmoid(logits), targets, weight=weight) * cfg.dice_weight
    return {"loss_cls": loss_cls, "loss_mask": loss_mask, "loss": loss_cls + loss_mask,
            "num_pos": num_pos.mean()}


def mask_extent_boxes(binary: Tensor, stride: int) -> Tensor:
    """(..., H4, W4) binary -> (..., 4) xyxy canvas boxes of each mask's
    extent (inclusive pixels); 0 for an empty mask."""
    h4, w4 = binary.shape[-2:]
    col_any = binary.amax(dim=-2) > 0
    row_any = binary.amax(dim=-1) > 0
    js = torch.arange(w4, dtype=torch.float32, device=binary.device)
    is_ = torch.arange(h4, dtype=torch.float32, device=binary.device)
    x1 = torch.where(col_any, js, INF).amin(dim=-1) * stride
    x2 = (torch.where(col_any, js, -1.0).amax(dim=-1) + 1.0) * stride - 1.0
    y1 = torch.where(row_any, is_, INF).amin(dim=-1) * stride
    y2 = (torch.where(row_any, is_, -1.0).amax(dim=-1) + 1.0) * stride - 1.0
    empty = binary.sum(dim=(-2, -1)) <= 0
    return torch.where(empty[..., None], 0.0, torch.stack([x1, y1, x2, y2], dim=-1))


def crop_patches(probs: Tensor, boxes: Tensor, stride: int, out_size: int) -> Tensor:
    """(B, D, H4, W4) probabilities cropped into their (B, D, 4) boxes ->
    (B, D, M, M) by bilinear sampling: dense hat weights ``max(0, 1 - |c -
    p|)`` along each axis, two float32 matmuls a detection. The sample
    offsets ``(i + 0.5) / M`` are products by float32's 1 / M, as XLA
    compiles the reference's."""
    h4, w4 = probs.shape[-2:]
    device = probs.device
    t = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * float(
        np.float32(1.0) / np.float32(out_size))
    x1, y1, x2, y2 = boxes.float().unbind(-1)
    ys = (y1[..., None] + t * (y2 - y1).clamp(min=1.0)[..., None]) / stride - 0.5
    xs = (x1[..., None] + t * (x2 - x1).clamp(min=1.0)[..., None]) / stride - 0.5
    wy = (1.0 - (ys[..., None] - torch.arange(h4, device=device)).abs()).clamp(0.0, 1.0)
    wx = (1.0 - (xs[..., None] - torch.arange(w4, device=device)).abs()).clamp(0.0, 1.0)
    return float32_matmul(float32_matmul(wy, probs), wx.transpose(-1, -2))


class Candidates(NamedTuple):
    scores: Tensor  # (B, K) rescored, descending
    labels: Tensor  # (B, K) 0-based
    binary: Tensor  # (B, K, H4 * W4) float32 masks in score order
    rows: Tensor  # (B, K) each candidate's row of ``probs``
    probs: Tensor  # (B, K, H4 * W4) float32 probabilities in the flat top-k's order


def solov2_candidates(cfg: SOLOV2Config, cls_scores: Sequence[Tensor],
                      kernels: Sequence[Tensor], mask_feat: Tensor) -> Candidates:
    """The flat top ``pre_nms_top_k`` of the (cell, class) scores, their
    masks (one float32 matmul of their kernels with the mask features),
    the maskness rescoring, and the candidates re-sorted by it."""
    fc, fk = flatten_levels(cls_scores, kernels)
    b, c = fc.shape[0], cfg.num_classes
    top_s, top_i = top_k_stable(torch.sigmoid(fc.float()).reshape(b, -1), cfg.pre_nms_top_k)
    probs = torch.sigmoid(float32_matmul(take_rows(fk, top_i // c), _mask_matrix(mask_feat)))
    binary = (probs > cfg.mask_thr).float()  # (B, K, H4 * W4)
    area = binary.sum(dim=-1)
    maskness = (probs * binary).sum(dim=-1) / area.clamp(min=1.0)
    score, order = top_k_stable(top_s * maskness * (area > 0), cfg.pre_nms_top_k)
    return Candidates(score, torch.gather(top_i % c, 1, order), take_rows(binary, order), order, probs)


def solov2_detections(cfg: SOLOV2Config, cand: Candidates, decayed: Tensor,
                      mask_hw: Tuple[int, int], img_shapes: Optional[Tensor] = None,
                      scale_factors: Optional[Tensor] = None) -> MaskDetections:
    """The top ``max_detections`` of the Matrix-NMS scores, those not above
    ``score_thr`` before it at 0 (R3): boxes from the masks' extents
    (clipped to each image), (M, M) patches of the masks in their boxes'
    frames."""
    b = decayed.shape[0]
    h4, w4 = mask_hw
    decayed = torch.where(cand.scores > cfg.score_thr, decayed, 0.0)  # R3
    out_s, keep = top_k_stable(decayed, cfg.max_detections)
    out_cls = torch.gather(cand.labels, 1, keep)
    out_probs = take_rows(cand.probs, torch.gather(cand.rows, 1, keep)).reshape(b, -1, h4, w4)
    out_v = out_s > cfg.update_thr
    boxes = mask_extent_boxes(take_rows(cand.binary, keep).reshape(b, -1, h4, w4), cfg.mask_stride)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    patches = crop_patches(out_probs, boxes, cfg.mask_stride, cfg.mask_out_size)
    if scale_factors is not None:
        boxes = boxes / scale_factors.reshape(b, 1, -1).to(boxes.dtype)
    return MaskDetections(torch.where(out_v[..., None], boxes, 0.0),
                          torch.where(out_v, out_s, 0.0), torch.where(out_v, out_cls, -1), out_v,
                          patches * out_v[..., None, None])


def decode_solov2(
    cfg: SOLOV2Config,
    cls_scores: Sequence[Tensor],
    kernels: Sequence[Tensor],
    mask_feat: Tensor,
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> MaskDetections:
    """``solov2_candidates`` -> Matrix NMS over the candidates above
    ``score_thr`` -> ``solov2_detections``."""
    cand = solov2_candidates(cfg, cls_scores, kernels, mask_feat)
    decayed = matrix_nms(cand.binary, cand.labels, cand.scores, cand.scores > cfg.score_thr,
                         method=cfg.nms_method, sigma=cfg.nms_sigma)
    return solov2_detections(cfg, cand, decayed, tuple(mask_feat.shape[1:3]), img_shapes,
                             scale_factors)


def solov2_inference(cfg: SOLOV2Config, model: SOLOV2, images: Tensor,
                     img_shapes: Optional[Tensor] = None,
                     scale_factors: Optional[Tensor] = None) -> MaskDetections:
    """The detector's outputs through ``decode_solov2``: the segm route."""
    return decode_solov2(cfg, *model(images), img_shapes, scale_factors)


def solov2_box_inference(cfg: SOLOV2Config, model: SOLOV2, images: Tensor,
                         img_shapes: Optional[Tensor] = None,
                         scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The box route of a box-free family: the decode's mask-extent boxes,
    scores, labels and validity (no indices)."""
    d = solov2_inference(cfg, model, images, img_shapes, scale_factors)
    return NMSResult(d.boxes, d.scores, d.labels, d.valid, None)
