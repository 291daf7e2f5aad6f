"""Single-stage detector (RetinaNet): backbone -> neck -> dense head, its
training loss, and fixed-shape inference.

Counterpart of ``torch_detection_tpu/models/detectors/single_stage.py``.
The module returns the raw per-level head outputs; ``retina_loss`` and
``decode_detections`` are functions over them, batched over the images:
the assignment runs on a (B, N, G) IoU tensor, the preselection and the
class-wise NMS on (B, ...) tensors, with no loop over images.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...ops.anchors import AnchorGenerator
from ...ops.assign import MaxIoUAssigner
from ...ops.boxes import bbox2delta, clip_boxes, delta2bbox
from ...ops.losses import sigmoid_focal_loss_sparse, smooth_l1_loss
from ...ops.nms import NMSResult, multiclass_nms, multiclass_soft_nms, top_k_stable
from ...utils.device import resolve_device
from ...utils.registry import BACKBONES, DETECTORS, HEADS
from ..heads.anchor_head import flatten_head_outputs
from ..layers import compute_autocast
from ..necks import build_neck


@DETECTORS.register_module
class SingleStageDetector(nn.Module):
    """backbone (+ optional neck) + dense head, named as the reference's
    (``backbone``, ``neck``, ``head``). ``dtype``, ``param_dtype`` and
    ``device`` as ``TwoStageDetector``'s; without a neck the backbone's
    levels feed the head."""

    def __init__(self, backbone: Dict[str, Any], head: Dict[str, Any],
                 neck: Optional[Dict[str, Any]] = None, dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.param_dtype = param_dtype or self.dtype
        kw = dict(dtype=self.param_dtype, device=resolve_device(device))
        self.backbone = BACKBONES.build(dict(backbone), **kw)
        self.neck = build_neck(neck, self.backbone, **kw) if neck else None
        self.head = HEADS.build(dict(head), **kw)

    def _autocast(self, x: Tensor):
        return compute_autocast(x, self.dtype, self.param_dtype)

    def forward(self, images: Tensor) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        """NHWC images (or the backbone's space-to-depth wire) -> per-level
        (B, H, W, A*C) logits and (B, H, W, A*4) deltas."""
        x = images.to(self.dtype).contiguous()
        with self._autocast(x):
            feats = self.backbone(x)
            if self.neck is not None:
                feats = self.neck(feats)
            return self.head(feats)


@dataclasses.dataclass(frozen=True)
class RetinaNetConfig:
    """The reference's ``RetinaNetConfig``, with its defaults, less
    ``approx_top_k`` (a TPU approximation). ``nms_method`` ``"hard"`` is
    greedy NMS, ``"soft"`` gaussian Soft-NMS of ``soft_sigma``
    (``ops/nms.py::multiclass_soft_nms``)."""

    num_classes: int = 80
    anchor_generator: AnchorGenerator = AnchorGenerator(
        strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
        octave_base_scale=4.0, scales_per_octave=3,
    )
    target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    assigner: MaxIoUAssigner = MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    smooth_l1_beta: float = 1.0 / 9.0
    reg_loss_weight: float = 1.0
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    pre_select_per_level: int = 1000  # top anchors a level by their best class score
    pre_nms_top_k: int = 1000  # (box, class) pairs entering NMS
    max_detections: int = 100
    nms_method: str = "hard"
    soft_sigma: float = 0.5

    def __post_init__(self):
        if self.nms_method not in ("hard", "soft"):
            raise ValueError(f"nms_method {self.nms_method!r} is not 'hard' or 'soft'")


class RetinaTargets(NamedTuple):
    pos: Tensor  # (B, N) bool
    neg: Tensor  # (B, N) bool
    label0: Tensor  # (B, N) int64 0-based class of a positive, -1 elsewhere
    reg_targets: Tensor  # (B, N, 4)


def retina_targets(
    cfg: RetinaNetConfig,
    anchors: Tensor,  # (N, 4)
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
) -> RetinaTargets:
    """Every image's anchor targets (the reference's ``_per_image_targets``).
    With ``img_shapes`` an anchor takes part only where its centre lies
    inside the image's (h, w)."""
    anchor_valid = None
    if img_shapes is not None:
        cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        shapes = img_shapes.to(anchors.dtype)
        anchor_valid = (cx[None] < shapes[:, 1:2]) & (cy[None] < shapes[:, 0:1])
    assign = cfg.assigner(anchors, gt_boxes, gt_valid, gt_labels, anchor_valid=anchor_valid)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    safe_gt = (assign.assigned_gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    matched = torch.gather(gt_boxes, 1, safe_gt[..., None].expand(-1, -1, 4))
    reg_targets = bbox2delta(anchors[None], matched, cfg.target_means, cfg.target_stds)
    label0 = torch.where(pos, assign.labels.long() - 1, torch.full_like(safe_gt, -1))
    return RetinaTargets(pos, neg, label0, reg_targets)


def retina_loss(
    cfg: RetinaNetConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w) of each image
) -> Dict[str, Tensor]:
    """Focal and smooth-L1 losses over all levels. Each image's losses are
    divided by its own positive count (at least 1), then averaged over the
    images, as the reference (not mmdetection's count over the batch)."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = cfg.anchor_generator.flat_anchors(featmap_sizes, gt_boxes.device)
    # the logits stay in the head's dtype: the focal loss casts inside
    flat_cls, flat_reg = flatten_head_outputs(cls_scores, bbox_preds, cfg.num_classes)
    targets = retina_targets(cfg, anchors, gt_boxes, gt_labels, gt_valid, img_shapes)
    cls_weight, reg_weight = loss_weights(targets)
    loss_cls = sigmoid_focal_loss_sparse(flat_cls, targets.label0, weight=cls_weight,
                                         gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    loss_reg = smooth_l1_loss(flat_reg.float(), targets.reg_targets, weight=reg_weight,
                              beta=cfg.smooth_l1_beta) * cfg.reg_loss_weight
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss": loss_cls + loss_reg,
            "num_pos": targets.pos.sum(dim=1).to(torch.float32).mean()}


def loss_weights(targets: RetinaTargets) -> Tuple[Tensor, Tensor]:
    """(B, N, 1) weights of the classification (positives and negatives)
    and regression (positives) terms. Each image's carry 1 / (B * max(its
    positives, 1)), so one sum over the batch is the mean over the images of
    the per-image losses."""
    num_pos = targets.pos.sum(dim=1).to(torch.float32)
    per_image = (1.0 / (targets.pos.shape[0] * num_pos.clamp(min=1.0)))[:, None, None]
    return (targets.pos | targets.neg)[..., None] * per_image, targets.pos[..., None] * per_image


class Candidates(NamedTuple):
    logits: Tensor  # (B, M, C) float32
    anchors: Tensor  # (B, M, 4)
    deltas: Tensor  # (B, M, 4) float32


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, idx[b]]`` for (B, N, D) ``x`` and (B, K) ``idx``."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


def preselect(cfg: RetinaNetConfig, cls_scores: Sequence[Tensor],
              bbox_preds: Sequence[Tensor]) -> Candidates:
    """Each level's top ``pre_select_per_level`` anchors by their best class
    logit, every image at once.

    A level with more positions than k takes the reference's position path:
    the top k positions by their best logit over all A * C, then the exact
    top k of those positions' k * A anchors. A top-k anchor's position has a
    best logit at least its own, so the k positions hold every top-k
    anchor, and with exact top-ks (ties to the lower index, as XLA's
    ``top_k``) both paths select the same set. The maxima, top-ks and
    gathers run in the head's dtype; only the selected rows are cast to
    float32, which is exact and keeps the order."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    level_anchors = cfg.anchor_generator.grid_anchors(featmap_sizes, cls_scores[0].device)
    b, c = cls_scores[0].shape[0], cfg.num_classes
    logits, anchors, deltas = [], [], []
    for cls_l, reg_l, anchors_l in zip(cls_scores, bbox_preds, level_anchors):
        a_per = cls_l.shape[-1] // c
        hw = cls_l.shape[1] * cls_l.shape[2]
        k = min(cfg.pre_select_per_level, hw * a_per)
        if a_per > 1 and hw > k:
            rows = cls_l.reshape(b, hw, a_per * c)
            _, pidx = top_k_stable(rows.amax(dim=-1), k)  # (B, k) positions
            s_ka = _take(rows, pidx).reshape(b, k * a_per, c)
            r_ka = _take(reg_l.reshape(b, hw, a_per * 4), pidx).reshape(b, k * a_per, 4)
            _, aidx = top_k_stable(s_ka.amax(dim=-1), k)  # (B, k) of the k * A anchors
            s, r = _take(s_ka, aidx), _take(r_ka, aidx)
            a = anchors_l[torch.gather(pidx, 1, aidx // a_per) * a_per + aidx % a_per]
        else:
            s, r = cls_l.reshape(b, -1, c), reg_l.reshape(b, -1, 4)
            if k < s.shape[1]:
                _, idx = top_k_stable(s.amax(dim=-1), k)
                s, r, a = _take(s, idx), _take(r, idx), anchors_l[idx]
            else:
                a = anchors_l[None].expand(b, -1, -1)
        logits.append(s.float())
        anchors.append(a)
        deltas.append(r.float())
    return Candidates(torch.cat(logits, dim=1), torch.cat(anchors, dim=1), torch.cat(deltas, dim=1))


def decode_candidates(cfg: RetinaNetConfig, cand: Candidates,
                      img_shapes: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """(B, M, C) class probabilities and (B, M, 4) boxes, clipped to each
    image's (h, w) when ``img_shapes`` is given."""
    boxes = delta2bbox(cand.anchors, cand.deltas, cfg.target_means, cfg.target_stds,
                       wh_ratio_clip=16 / 1000)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return torch.sigmoid(cand.logits), boxes


def decode_detections(
    cfg: RetinaNetConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> NMSResult:
    """Preselection -> sigmoid -> delta decode -> class-wise NMS (greedy,
    or gaussian Soft-NMS with ``nms_method="soft"``), padded to (B,
    max_detections)."""
    scores, boxes = decode_candidates(cfg, preselect(cfg, cls_scores, bbox_preds), img_shapes)
    nms = (functools.partial(multiclass_soft_nms, sigma=cfg.soft_sigma)
           if cfg.nms_method == "soft" else multiclass_nms)
    res = nms(boxes, scores, iou_thr=cfg.nms_iou_thr, score_thr=cfg.score_thr,
              pre_nms_top_k=cfg.pre_nms_top_k, max_out=cfg.max_detections)
    if scale_factors is None:
        return res
    b = res.boxes.shape[0]
    return res._replace(boxes=res.boxes / scale_factors.reshape(b, 1, -1).to(res.boxes.dtype))


def retina_inference(
    cfg: RetinaNetConfig,
    model: SingleStageDetector,
    images: Tensor,  # (B, H, W, 3) or the (B, H/2, W/2, 12) space-to-depth wire
    img_shapes: Optional[Tensor] = None,
    scale_factors: Optional[Tensor] = None,
) -> NMSResult:
    """The detector's head outputs through ``decode_detections``."""
    return decode_detections(cfg, *model(images), img_shapes, scale_factors)
