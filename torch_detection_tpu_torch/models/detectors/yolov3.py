"""YOLOv3: config, the grid-assigned loss, and the decode.

Counterpart of ``torch_detection_tpu/models/detectors/yolov3.py``, batched
over the images. The model is ``SingleStageDetector`` with ``Darknet``,
``YOLOV3Neck`` and ``YOLOV3Head``.

* Box coding: the centre's offset in its cell in sigmoid space,
  ``t_xy = (gt_c - anchor_c) / stride + 0.5`` clipped to [eps, 1 - eps],
  and ``t_wh = log(gt_wh / anchor_wh)``, on the repo's inclusive (+1)
  convention; the decode caps |t_wh| at 4.135 (delta2bbox's 16/1000 clip).
* Assignment: ``GridAssigner`` over ``responsible_flags``; with
  ``img_shapes`` an anchor takes part only where its centre lies inside
  the image.
* Loss: BCE on xy, objectness and the classes, MSE on wh, each image's
  over its positive count (at least 1), averaged over the images and
  weighted by term; the objectness term counts the positives and the
  negatives.
* Decode: each level's top ``pre_select_per_level`` anchors by objectness
  (``top_k_stable``, the lower index first among ties, as XLA's
  ``top_k``), objectness under ``conf_thr`` zeroed, scores
  sigmoid(cls) * objectness, the boxes decoded and clipped, then the
  class-wise NMS.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ...ops.anchors import YOLOAnchorGenerator
from ...ops.assign import GridAssigner
from ...ops.boxes import clip_boxes
from ...ops.losses import optax_sigmoid_ce
from ...ops.nms import NMSResult, top_k_stable
from .fcos import dense_nms


@dataclasses.dataclass(frozen=True)
class YOLOV3Config:
    """The reference's ``YOLOV3Config`` with its defaults, less
    ``approx_top_k`` (a TPU approximation)."""

    num_classes: int = 80
    anchor_generator: YOLOAnchorGenerator = YOLOAnchorGenerator()
    assigner: GridAssigner = GridAssigner(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0)
    loss_xy_weight: float = 2.0
    loss_wh_weight: float = 2.0
    loss_conf_weight: float = 1.0
    loss_cls_weight: float = 1.0
    # inference
    conf_thr: float = 0.005
    score_thr: float = 0.05
    nms_iou_thr: float = 0.45
    pre_select_per_level: int = 1000
    pre_nms_top_k: int = 1000
    max_detections: int = 100


def flatten_yolo_outputs(cfg: YOLOV3Config, pred_maps: Sequence[Tensor]) -> Tensor:
    """Per level (B, H, W, A * (5 + C)) -> float32 (B, N, 5 + C), in the
    order of ``flat_anchors``."""
    b = pred_maps[0].shape[0]
    return torch.cat([p.reshape(b, -1, 5 + cfg.num_classes).float() for p in pred_maps], dim=1)


def _anchor_geometry(anchors: Tensor) -> Tuple[Tensor, Tensor]:
    """(..., 4) xyxy -> centres and sizes (..., 2) on the +1 convention."""
    wh = anchors[..., 2:4] - anchors[..., 0:2] + 1.0
    return anchors[..., 0:2] + 0.5 * (wh - 1.0), wh


def yolo_encode(anchors: Tensor, strides: Tensor, gt: Tensor, eps: float = 1e-6) -> Tensor:
    """(..., N, 4) targets [tx, ty, tw, th] of ``gt`` (..., N, 4) matched to
    ``anchors`` (N, 4) of ``strides`` (N,)."""
    ac, awh = _anchor_geometry(anchors)
    gc, gwh = _anchor_geometry(gt)
    t_xy = ((gc - ac) / strides[:, None] + 0.5).clamp(eps, 1.0 - eps)
    t_wh = torch.log((gwh / awh).clamp(min=eps))
    return torch.cat([t_xy, t_wh], dim=-1)


def yolo_decode(anchors: Tensor, strides: Tensor, pred: Tensor,
                max_wh_ratio: float = 4.135) -> Tensor:
    """Raw [tx, ty, tw, th] (..., M, 4) on ``anchors`` (..., M, 4) of
    ``strides`` (M,) -> xyxy boxes (inclusive convention)."""
    ac, awh = _anchor_geometry(anchors)
    c = ac + (torch.sigmoid(pred[..., 0:2]) - 0.5) * strides[:, None]
    wh = awh * torch.exp(pred[..., 2:4].clamp(-max_wh_ratio, max_wh_ratio))
    return torch.cat([c - 0.5 * (wh - 1.0), c + 0.5 * (wh - 1.0)], dim=-1)


class YOLOTargets(NamedTuple):
    pos: Tensor  # (B, N) bool
    neg: Tensor  # (B, N) bool
    label0: Tensor  # (B, N) int64 0-based class, clipped into [0, C) where there is none
    box_targets: Tensor  # (B, N, 4)


def yolo_targets(cfg: YOLOV3Config, featmap_sizes, gt_boxes: Tensor, gt_labels: Tensor,
                 gt_valid: Tensor, img_shapes: Optional[Tensor] = None) -> YOLOTargets:
    """Every image's responsible flags, grid assignment and encoded box
    targets; with ``img_shapes`` (B, 2) an anchor whose centre lies outside
    its image's (h, w) is ignored."""
    gen = cfg.anchor_generator
    device = gt_boxes.device
    anchors = gen.flat_anchors(featmap_sizes, device)
    strides = gen.flat_strides(featmap_sizes, device)
    anchor_valid = None
    if img_shapes is not None:
        cx = 0.5 * (anchors[:, 0] + anchors[:, 2])
        cy = 0.5 * (anchors[:, 1] + anchors[:, 3])
        shapes = img_shapes.to(anchors.dtype)
        anchor_valid = (cx[None] < shapes[:, 1:2]) & (cy[None] < shapes[:, 0:1])
    resp = gen.responsible_flags(featmap_sizes, gt_boxes, gt_valid)
    assign = cfg.assigner(anchors, resp, gt_boxes, gt_valid, gt_labels, anchor_valid=anchor_valid)
    safe_gt = (assign.assigned_gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    matched = torch.gather(gt_boxes, 1, safe_gt[..., None].expand(-1, -1, 4))
    label0 = (assign.labels.long() - 1).clamp(0, cfg.num_classes - 1)
    return YOLOTargets(assign.assigned_gt_inds > 0, assign.assigned_gt_inds == 0, label0,
                       yolo_encode(anchors, strides, matched))


def yolo_losses_from_targets(cfg: YOLOV3Config, flat: Tensor, t: YOLOTargets) -> Dict[str, Tensor]:
    """The loss dict of the flat predictions (B, N, 5 + C) on the targets."""
    w_pos = t.pos.to(torch.float32)
    num_pos = w_pos.sum(dim=1)
    denom = num_pos.clamp(min=1.0)

    def per_image(elem: Tensor, weight: Tensor) -> Tensor:
        return (elem * weight).flatten(1).sum(dim=1) / denom

    onehot = F.one_hot(t.label0, cfg.num_classes).to(torch.float32)
    xy = per_image(optax_sigmoid_ce(flat[..., 0:2], t.box_targets[..., 0:2]), w_pos[..., None])
    wh = per_image((flat[..., 2:4] - t.box_targets[..., 2:4]) ** 2, w_pos[..., None])
    conf = per_image(optax_sigmoid_ce(flat[..., 4], w_pos), (t.pos | t.neg).to(torch.float32))
    cls = per_image(optax_sigmoid_ce(flat[..., 5:], onehot), w_pos[..., None])
    out = {"loss_xy": xy.mean() * cfg.loss_xy_weight, "loss_wh": wh.mean() * cfg.loss_wh_weight,
           "loss_conf": conf.mean() * cfg.loss_conf_weight,
           "loss_cls": cls.mean() * cfg.loss_cls_weight}
    out["loss"] = out["loss_xy"] + out["loss_wh"] + out["loss_conf"] + out["loss_cls"]
    out["num_pos"] = num_pos.mean()
    return out


def yolo_loss(
    cfg: YOLOV3Config,
    pred_maps: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w) of each image
) -> Dict[str, Tensor]:
    """BCE on xy, objectness and classes, MSE on wh, weighted by term."""
    sizes = [tuple(p.shape[1:3]) for p in pred_maps]
    t = yolo_targets(cfg, sizes, gt_boxes, gt_labels, gt_valid, img_shapes)
    return yolo_losses_from_targets(cfg, flatten_yolo_outputs(cfg, pred_maps), t)


class YOLOCandidates(NamedTuple):
    pred: Tensor  # (B, M, 5 + C) float32
    anchors: Tensor  # (B, M, 4)
    strides: Tensor  # (M,)


def preselect_yolo(cfg: YOLOV3Config, pred_maps: Sequence[Tensor]) -> YOLOCandidates:
    """Each level's top ``pre_select_per_level`` anchors by objectness (all
    of a level that has no more), every image at once."""
    sizes = [tuple(p.shape[1:3]) for p in pred_maps]
    gen = cfg.anchor_generator
    level_anchors = gen.grid_anchors(sizes, pred_maps[0].device)
    b, c5 = pred_maps[0].shape[0], 5 + cfg.num_classes
    preds, anchors, strides = [], [], []
    for pm, anchors_l, stride in zip(pred_maps, level_anchors, gen.strides):
        p = pm.reshape(b, -1, c5).float()
        k = min(cfg.pre_select_per_level, p.shape[1])
        if k < p.shape[1]:
            _, idx = top_k_stable(p[..., 4], k)
            p = torch.gather(p, 1, idx[..., None].expand(-1, -1, c5))
            a = anchors_l[idx]
        else:
            a = anchors_l[None].expand(b, -1, -1)
        preds.append(p)
        anchors.append(a)
        strides.append(torch.full((p.shape[1],), float(stride), dtype=torch.float32,
                                  device=p.device))
    return YOLOCandidates(torch.cat(preds, dim=1), torch.cat(anchors, dim=1), torch.cat(strides))


def yolo_candidates(cfg: YOLOV3Config, pred_maps: Sequence[Tensor],
                    img_shapes: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(B, M, C) scores sigmoid(cls) * objectness (objectness under
    ``conf_thr`` zeroed) and (B, M, 4) decoded boxes of the preselected
    anchors, clipped to each image's (h, w) when given."""
    cand = preselect_yolo(cfg, pred_maps)
    conf = torch.sigmoid(cand.pred[..., 4])
    conf = torch.where(conf >= cfg.conf_thr, conf, torch.zeros_like(conf))
    scores = torch.sigmoid(cand.pred[..., 5:]) * conf[..., None]
    boxes = yolo_decode(cand.anchors, cand.strides, cand.pred[..., 0:4])
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return scores, boxes


def decode_yolo(
    cfg: YOLOV3Config,
    pred_maps: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Preselection -> conf-weighted scores -> decode -> clip -> class-wise
    NMS, padded to (B, max_detections)."""
    return dense_nms(cfg, *yolo_candidates(cfg, pred_maps, img_shapes), scale_factors)


def yolo_inference(cfg: YOLOV3Config, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                   scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's prediction maps through ``decode_yolo``."""
    return decode_yolo(cfg, model(images), img_shapes, scale_factors)
