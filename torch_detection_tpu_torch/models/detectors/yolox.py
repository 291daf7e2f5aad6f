"""YOLOX: config, SimOTA assignment, the loss, and the decode.

Counterpart of ``torch_detection_tpu/models/detectors/yolox.py``, batched
over the images. The model is ``SingleStageDetector`` with ``CSPDarknet``,
``YOLOXPAFPN`` and ``YOLOXHead``.

* Points: every level's cells in NHWC order (index y * W + x), level by
  level; a cell's corner is (x, y) * stride, its prior centre the corner
  plus half a stride. A box is decoded as centre ``reg_xy * stride +
  corner`` and size ``exp(clip(reg_wh, -10, 8)) * stride``.
* SimOTA, under ``torch.no_grad`` in float32 with autocast off (the
  reference stops the gradient): candidates are the points inside a gt or
  within ``center_radius`` strides of its centre; the cost is the class
  BCE of sqrt(sigmoid(cls) * sigmoid(obj)) against the gt's class, plus
  3 x -log(IoU + 1e-8), plus ``BIG`` where a point is not in both regions.
  The class BCE is the sum over classes of -log(1 - p) plus a correction
  at the gt's class, ``p[:, label]`` taken by a gather (exact, where a
  one-hot product would round under autocast or TF32). Each gt takes
  k_g = clip(int(sum of its 10 best candidate IoUs), 1, 10) and selects
  every candidate whose cost is at most its k_g-th smallest: all the
  points tied at that cost. A point selected by several gts goes to its
  cheapest, the first one among equal costs (``torch.argmin``, like
  ``jnp.argmin``, returns the first index of the minimum).
* Loss: objectness BCE over all points, class BCE against one-hot times
  the matched IoU and the square-IoU box loss (``offset=0``) over the
  positives, each image's sums over its own positive count (at least 1),
  then averaged over the images (R3: the official YOLOX divides the
  batch's sums by the batch's count); ``use_l1`` adds the L1 on the raw
  box values.
* Decode: scores sigmoid(cls) * sigmoid(obj), the boxes clipped to each
  image's (h, w), then the class-wise NMS (IoU offset 1, as the
  reference's call) over the top ``pre_nms_top_k`` pairs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ...ops.boxes import bbox_overlaps, clip_boxes
from ...ops.losses import iou_loss_elementwise, optax_sigmoid_ce
from ...ops.nms import NMSResult
from .fcos import dense_nms

INF = 1e8
BIG = 1e5


@dataclasses.dataclass(frozen=True)
class YOLOXConfig:
    """The reference's ``YOLOXConfig`` with its defaults, less
    ``approx_top_k`` (a TPU approximation)."""

    num_classes: int = 80
    strides: Tuple[int, ...] = (8, 16, 32)
    center_radius: float = 2.5  # the centre prior's radius in strides
    candidate_topk: int = 10  # the dynamic k's pool (k_g <= this)
    iou_cost_weight: float = 3.0
    reg_loss_weight: float = 5.0
    use_l1: bool = False  # the official fine-tune phase's L1 on the raw box values
    # inference
    score_thr: float = 0.01
    nms_iou_thr: float = 0.65
    pre_nms_top_k: int = 1000
    max_detections: int = 100


def flat_grid(cfg: YOLOXConfig, featmap_sizes, device=None) -> Tuple[Tensor, Tensor]:
    """Every level's (N, 2) cell corners, (x, y) * stride, and (N,) strides."""
    points, strides = [], []
    for (h, w), s in zip(featmap_sizes, cfg.strides, strict=True):
        ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                                torch.arange(w, dtype=torch.float32, device=device),
                                indexing="ij")
        points.append(torch.stack([xs.reshape(-1), ys.reshape(-1)], dim=-1) * s)
        strides.append(torch.full((h * w,), float(s), dtype=torch.float32, device=device))
    return torch.cat(points), torch.cat(strides)


def decode_boxes(reg: Tensor, grid: Tensor, strides: Tensor) -> Tensor:
    """(..., N, 4) raw box values -> xyxy: centre ``reg_xy * stride +
    corner``, size ``exp(clip(reg_wh, -10, 8)) * stride``."""
    cxy = reg[..., :2] * strides[:, None] + grid
    wh = torch.exp(reg[..., 2:].clamp(-10.0, 8.0)) * strides[:, None]
    return torch.cat([cxy - wh / 2.0, cxy + wh / 2.0], dim=-1)


def flatten_yolox_outputs(cfg: YOLOXConfig, cls_scores: Sequence[Tensor],
                          bbox_preds: Sequence[Tensor], objectnesses: Sequence[Tensor]
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """Per level NHWC maps -> float32 (B, N, C), (B, N, 4) and (B, N), the
    points in ``flat_grid``'s order."""
    b = cls_scores[0].shape[0]
    return (torch.cat([s.reshape(b, -1, cfg.num_classes).float() for s in cls_scores], dim=1),
            torch.cat([r.reshape(b, -1, 4).float() for r in bbox_preds], dim=1),
            torch.cat([o.reshape(b, -1).float() for o in objectnesses], dim=1))


class SimOTA(NamedTuple):
    fg: Tensor  # (B, N) bool
    matched: Tensor  # (B, N) int64 gt slot of each point (0 where none)
    matched_iou: Tensor  # (B, N) IoU of each point's box with that gt
    cost: Tensor  # (B, N, G) the cost, INF outside the candidates
    kth: Tensor  # (B, G) each gt's k_g-th smallest cost


def simota_costs(cfg: YOLOXConfig, cls_logits: Tensor, obj_logits: Tensor, boxes: Tensor,
                 grid: Tensor, strides: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
                 gt_valid: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(candidates (B, N, G) bool, IoUs (B, N, G), costs (B, N, G), INF
    outside the candidates) of float32 inputs."""
    centers = grid + 0.5 * strides[:, None]
    x, y = centers[None, :, 0, None], centers[None, :, 1, None]  # (1, N, 1)
    in_box = ((x > gt_boxes[:, None, :, 0]) & (x < gt_boxes[:, None, :, 2])
              & (y > gt_boxes[:, None, :, 1]) & (y < gt_boxes[:, None, :, 3]))
    gcx = 0.5 * (gt_boxes[..., 0] + gt_boxes[..., 2])
    gcy = 0.5 * (gt_boxes[..., 1] + gt_boxes[..., 3])
    r = (cfg.center_radius * strides)[None, :, None]
    in_center = ((x - gcx[:, None, :]).abs() < r) & ((y - gcy[:, None, :]).abs() < r)
    cand = (in_box | in_center) & gt_valid[:, None, :]
    both = in_box & in_center

    iou = bbox_overlaps(boxes, gt_boxes, offset=0.0)  # (B, N, G)
    iou_cost = -torch.log(iou + 1e-8)
    p = torch.sqrt(torch.sigmoid(cls_logits) * torch.sigmoid(obj_logits)[..., None])
    p = p.clamp(1e-8, 1.0 - 1e-8)
    s_all = torch.sum(-torch.log1p(-p), dim=-1)  # (B, N)
    label0 = (gt_labels.long() - 1).clamp(0, cls_logits.shape[-1] - 1)
    p_sel = torch.gather(p, 2, label0[:, None, :].expand(-1, p.shape[1], -1))  # p[n, label_g]
    cls_cost = s_all[..., None] - torch.log(p_sel) + torch.log1p(-p_sel)
    cost = cls_cost + cfg.iou_cost_weight * iou_cost + BIG * (~both).to(torch.float32)
    return cand, iou, torch.where(cand, cost, torch.full_like(cost, INF))


@torch.no_grad()
def simota_assign(
    cfg: YOLOXConfig,
    cls_logits: Tensor,  # (B, N, C)
    obj_logits: Tensor,  # (B, N)
    boxes: Tensor,  # (B, N, 4) decoded xyxy
    grid: Tensor,  # (N, 2) cell corners
    strides: Tensor,  # (N,)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> SimOTA:
    """SimOTA for every image at once, in float32 with autocast off."""
    with torch.autocast(boxes.device.type, enabled=False):
        cand, iou, cost = simota_costs(cfg, cls_logits.float(), obj_logits.float(), boxes.float(),
                                       grid, strides, gt_boxes.float(), gt_labels, gt_valid)
        k = cfg.candidate_topk
        iou_cand = torch.where(cand, iou, torch.zeros_like(iou)).transpose(1, 2)  # (B, G, N)
        k_g = torch.topk(iou_cand, k, dim=-1).values.sum(dim=-1).to(torch.int32).clamp(1, k)
        smallest = torch.topk(cost.transpose(1, 2), k, dim=-1, largest=False).values  # ascending
        kth = torch.gather(smallest, 2, (k_g.long() - 1)[..., None])[..., 0]  # (B, G)
        # every candidate at or under the k_g-th smallest cost: ties at it all enter
        selected = cand & (cost <= kth[:, None, :])
        sel_cost = torch.where(selected, cost, torch.full_like(cost, INF))
        matched = torch.argmin(sel_cost, dim=-1)  # the first of equal minima, as jnp.argmin
        fg = selected.any(dim=-1)
        matched_iou = torch.gather(iou, 2, matched[..., None])[..., 0]
    return SimOTA(fg, matched, matched_iou, cost, kth)


def yolox_loss(
    cfg: YOLOXConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    objectnesses: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
) -> Dict[str, Tensor]:
    """Class and objectness BCE and the square-IoU box loss on SimOTA's
    positives; each image's over its own positive count, then the mean over
    the images (R3)."""
    sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    grid, strides = flat_grid(cfg, sizes, gt_boxes.device)
    fc, fr, fo = flatten_yolox_outputs(cfg, cls_scores, bbox_preds, objectnesses)
    boxes = decode_boxes(fr, grid, strides)
    a = simota_assign(cfg, fc.detach(), fo.detach(), boxes.detach(), grid, strides, gt_boxes,
                      gt_labels, gt_valid)
    w_fg = a.fg.to(torch.float32)
    num_fg = w_fg.sum(dim=1).clamp(min=1.0)  # (B,)

    obj_l = optax_sigmoid_ce(fo, w_fg).sum(dim=1) / num_fg
    label0 = (torch.gather(gt_labels.long(), 1, a.matched) - 1).clamp(0, cfg.num_classes - 1)
    cls_t = F.one_hot(label0, cfg.num_classes).to(torch.float32) * a.matched_iou[..., None]
    cls_l = (optax_sigmoid_ce(fc, cls_t) * w_fg[..., None]).sum(dim=(1, 2)) / num_fg
    tgt = torch.gather(gt_boxes.float(), 1, a.matched[..., None].expand(-1, -1, 4))
    reg_l = ((iou_loss_elementwise(boxes, tgt, mode="square_iou", offset=0.0) * w_fg).sum(dim=1)
             / num_fg * cfg.reg_loss_weight)
    if cfg.use_l1:
        # the official fine-tune phase: L1 on the raw box values
        t_cxy = (0.5 * (tgt[..., :2] + tgt[..., 2:]) - grid) / strides[:, None]
        t_wh = torch.log((tgt[..., 2:] - tgt[..., :2]).clamp(min=1e-3) / strides[:, None])
        l1 = (fr - torch.cat([t_cxy, t_wh], dim=-1)).abs() * w_fg[..., None]
        reg_l = reg_l + l1.sum(dim=(1, 2)) / num_fg
    out = {"loss_cls": cls_l.mean(), "loss_reg": reg_l.mean(), "loss_obj": obj_l.mean()}
    out["loss"] = out["loss_cls"] + out["loss_reg"] + out["loss_obj"]
    out["num_pos"] = a.fg.sum(dim=1).to(torch.float32).mean()
    return out


def yolox_candidates(cfg: YOLOXConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                     objectnesses: Sequence[Tensor], img_shapes: Optional[Tensor] = None
                     ) -> Tuple[Tensor, Tensor]:
    """(B, N, C) scores sigmoid(cls) * sigmoid(obj) and (B, N, 4) decoded
    boxes of every point, clipped to each image's (h, w) when given."""
    sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    grid, strides = flat_grid(cfg, sizes, cls_scores[0].device)
    fc, fr, fo = flatten_yolox_outputs(cfg, cls_scores, bbox_preds, objectnesses)
    boxes = decode_boxes(fr, grid, strides)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.sigmoid(fc) * torch.sigmoid(fo)[..., None], boxes


def decode_yolox(
    cfg: YOLOXConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    objectnesses: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Scores, the point decode, the clip, then the class-wise NMS, padded
    to (B, max_detections)."""
    return dense_nms(cfg, *yolox_candidates(cfg, cls_scores, bbox_preds, objectnesses,
                                            img_shapes), scale_factors)


def yolox_inference(cfg: YOLOXConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                    scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_yolox``."""
    return decode_yolox(cfg, *model(images), img_shapes, scale_factors)
