"""FreeAnchor: a learned anchor matching on RetinaNet's graph.

Counterpart of ``torch_detection_tpu/models/detectors/free_anchor.py``,
batched over the images. The model and the inference are RetinaNet's
(``single_stage.retina_inference``); only the loss differs. Each gt owns
a bag of the ``pre_anchor_topk`` anchors of highest IoU with it, and the
positive term is the negative log of the bag's mean-max likelihood of
``cls_prob * exp(-loc_loss_weight * smooth_l1)``, in log space. The
negative term is a focal-weighted background BCE of
``cls_prob * (1 - object_box_prob)``, where ``object_box_prob`` is, for
each class, the largest over that class's gts of a saturated IoU ramp of
the detached decoded boxes.

Against the reference's TPU forms, with the same values:

* the bag is ``top_k_stable`` of the (B, G, N) anchor IoUs (XLA's exact
  ``top_k`` puts the lower index first on a tie at the k-th place);
* the per-class max over gts of the ramp (``objmax``) is a
  ``scatter_reduce(amax)`` of the (B, G, N) ramp by label into (B, C, N)
  and a gather back, where the reference loops over the G gts; max is
  exact in any order;
* the label columns of ``cls_prob`` (``cls_sel``) are a plain gather, where
  the reference contracts with a one-hot.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor

from ...ops.boxes import bbox2delta, bbox_overlaps, delta2bbox
from ...ops.nms import top_k_stable
from ...parallel.distributed import batch_normaliser
from ..heads.anchor_head import flatten_head_outputs
from .single_stage import RetinaNetConfig


@dataclasses.dataclass(frozen=True)
class FreeAnchorConfig(RetinaNetConfig):
    """``RetinaNetConfig`` and the bag likelihood's knobs, with the
    reference's defaults: bag size 50, box-probability IoU threshold 0.6,
    gamma 2 and alpha 0.5, and 0.75 on the smooth L1 inside
    ``exp(-L_loc)``."""

    pre_anchor_topk: int = 50
    bbox_thr: float = 0.6
    bag_gamma: float = 2.0
    bag_alpha: float = 0.5
    loc_loss_weight: float = 0.75


def positive_bag_loss(log_probs: Tensor, valid: Tensor) -> Tensor:
    """-log of each bag's mean-max likelihood from its (..., k) log joint
    probabilities, 0 on an invalid gt. The weight ``1 / (1 - p)`` is not
    detached, as the paper's and the reference's."""
    probs = torch.exp(log_probs)  # may underflow to 0; only feeds the weight
    w = 1.0 / torch.clamp(1.0 - probs, min=1e-12)
    w = w / w.sum(dim=-1, keepdim=True)
    loss = -torch.logsumexp(log_probs + torch.log(w), dim=-1)
    return torch.where(valid, loss, torch.zeros_like(loss))


def object_box_max(box_prob: Tensor, label0: Tensor, num_classes: int) -> Tensor:
    """(B, G, N): for each gt, the largest ramp over the gts of its class,
    and 0 where that is negative. ``box_prob`` is 0 on the invalid gts, so
    their class-0 rows add nothing to the (B, C, N) maxima."""
    b, g, n = box_prob.shape
    index = label0[..., None].expand(b, g, n)
    per_class = box_prob.new_zeros((b, num_classes, n)).scatter_reduce(
        1, index, box_prob, reduce="amax", include_self=True)
    return torch.gather(per_class, 1, index)


def _bag_focal(p: Tensor, gamma: float) -> Tensor:
    """The focal-weighted background BCE ``p^gamma * -log(1 - p)``, ``p``
    clipped below 1 - 1e-6 (1 - 1e-12 rounds to 1.0 in float32)."""
    p = torch.clamp(p, 0.0, 1.0 - 1e-6)
    return p ** gamma * -torch.log1p(-p)


def negative_term(cfg: FreeAnchorConfig, anchors: Tensor, flat_cls: Tensor, flat_reg: Tensor,
                  boxes: Tensor, label0: Tensor, valid: Tensor) -> Tensor:
    """(B,) sum over anchors and classes of the focal-weighted background
    BCE of ``cls_prob * (1 - objmax)``. The decode, IoU and ramp are
    detached; the sum is the dense sum of ``f(cls_prob)`` plus, on the
    first gt of each label, the change on that label's column."""
    g = valid.shape[1]
    cls_prob = torch.sigmoid(flat_cls)  # (B, N, C)
    with torch.no_grad():
        decoded = delta2bbox(anchors[None], flat_reg, cfg.target_means, cfg.target_stds)
        iou = bbox_overlaps(boxes, decoded)  # (B, G, N)
        iou = torch.where(valid[..., None], iou, 0.0)
        t1 = cfg.bbox_thr
        denom = torch.clamp(iou.amax(dim=-1, keepdim=True) - t1, min=1e-6)
        box_prob = torch.clamp((iou - t1) / denom, 0.0, 1.0)
        box_prob = torch.where(valid[..., None], box_prob, 0.0)
        objmax = object_box_max(box_prob, label0, cfg.num_classes)
        eq = (label0[:, :, None] == label0[:, None, :]) & valid[:, :, None] & valid[:, None, :]
        order = torch.arange(g, device=valid.device)
        first = valid & ~(eq & (order[None, :] < order[:, None])).any(dim=2)
    index = label0[..., None].expand(-1, -1, cls_prob.shape[1])
    cls_sel = torch.gather(cls_prob.transpose(1, 2), 1, index)  # (B, G, N)
    corr = _bag_focal(cls_sel * (1.0 - objmax), cfg.bag_gamma) - _bag_focal(cls_sel, cfg.bag_gamma)
    return (_bag_focal(cls_prob, cfg.bag_gamma).sum(dim=(1, 2))
            + torch.where(first[..., None], corr, 0.0).sum(dim=(1, 2)))


def positive_term(cfg: FreeAnchorConfig, anchors: Tensor, flat_cls: Tensor, flat_reg: Tensor,
                  boxes: Tensor, label0: Tensor, valid: Tensor, bag_idx: Tensor) -> Tensor:
    """(B,) sum over the gts of the bag loss of each gt's (B, G, k) bag:
    ``log_sigmoid`` of the gt's class logit minus ``loc_loss_weight`` times
    the unreduced smooth L1 of the anchor's deltas to the gt."""
    b, g, k = bag_idx.shape
    flat_idx = (bag_idx * cfg.num_classes + label0[..., None]).reshape(b, -1)
    matched_logit = torch.gather(flat_cls.reshape(b, -1), 1, flat_idx).reshape(b, g, k)
    matched_reg = torch.gather(flat_reg, 1, bag_idx.reshape(b, -1, 1).expand(-1, -1, 4))
    targets = bbox2delta(anchors[bag_idx], boxes[:, :, None, :], cfg.target_means,
                         cfg.target_stds)
    diff = (matched_reg.reshape(b, g, k, 4) - targets).abs()
    beta = cfg.smooth_l1_beta
    loc = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta).sum(-1)
    log_joint = F.logsigmoid(matched_logit) - cfg.loc_loss_weight * loc
    return positive_bag_loss(log_joint, valid).sum(dim=1)


def flat_inputs(cfg: FreeAnchorConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                gt_boxes: Tensor, gt_labels: Tensor):
    """The (N, 4) anchors, float32 (B, N, C) logits and (B, N, 4) deltas,
    float32 gt boxes and the (B, G) 0-based labels clamped into range."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = cfg.anchor_generator.flat_anchors(featmap_sizes, gt_boxes.device)
    flat_cls, flat_reg = flatten_head_outputs(cls_scores, bbox_preds, cfg.num_classes)
    label0 = torch.clamp(gt_labels.long() - 1, 0, cfg.num_classes - 1)
    return anchors, flat_cls.float(), flat_reg.float(), gt_boxes.float(), label0


def free_anchor_loss(
    cfg: FreeAnchorConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # unused, as the reference's
) -> Dict[str, Tensor]:
    """The bag likelihood loss over all levels: ``loss_pos`` (alpha times
    the bags' losses over the batch's gt count) and ``loss_neg`` ((1 -
    alpha) times the background term over that count times k)."""
    del img_shapes
    anchors, flat_cls, flat_reg, boxes, label0 = flat_inputs(cfg, cls_scores, bbox_preds,
                                                             gt_boxes, gt_labels)
    neg_loss = negative_term(cfg, anchors, flat_cls, flat_reg, boxes, label0, gt_valid)
    with torch.no_grad():  # each gt's bag: its top k anchors by IoU, the lower index on a tie
        bag_idx = top_k_stable(bbox_overlaps(boxes, anchors), cfg.pre_anchor_topk)[1]
    pos_loss = positive_term(cfg, anchors, flat_cls, flat_reg, boxes, label0, gt_valid, bag_idx)
    num_pos = gt_valid.float().sum(dim=1)
    total_pos = batch_normaliser(num_pos.sum())
    loss_pos = cfg.bag_alpha * pos_loss.sum() / total_pos
    loss_neg = (1.0 - cfg.bag_alpha) * neg_loss.sum() / (total_pos * cfg.pre_anchor_topk)
    return {"loss_pos": loss_pos, "loss_neg": loss_neg, "loss": loss_pos + loss_neg,
            "num_pos": num_pos.sum() / gt_valid.shape[0]}
