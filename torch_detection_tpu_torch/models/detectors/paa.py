"""PAA: probabilistic anchor assignment with a GMM split, IoU prediction
and score voting.

Counterpart of ``torch_detection_tpu/models/detectors/paa.py``, batched
over the images and the gts. The graph is ATSS's (one anchor a location,
``PAAHead``'s third output read as an IoU logit). Each training step
scores every anchor that a loose ``MaxIoUAssigner`` (0.1, 0.1) gave a gt
by its current detection loss (the sparse focal elements summed over the
classes plus 1 - GIoU of the detached decode); each gt's top-k lowest
losses of each level form its candidate slate, sorted by loss;
``ops.gmm.gmm_em_1d`` fits two components to the slate and the low-mean
component's members up to its likelihood mode become the positives. The
losses are the focal loss, GIoU weighted by the detached IoU of the
decode, and BCE of the IoU logit. Inference scores with
``sqrt(cls * iou)`` and, after the class-wise NMS, moves each kept box to
the score- and proximity-weighted mean of the candidates of its class
(kernel ``exp(-(1 - iou)^2 / sigma)``).

The (B, G, N) slates' top-ks are ``top_k_stable`` (the lower index first
on a tie, as XLA's ``top_k``) and the slate sort a stable argsort; the
reference's one-hot contractions are plain gathers, and the voting's
``w @ boxes`` is a float32 ``bmm`` (the caller keeps TF32 off).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ...ops.anchors import AnchorGenerator
from ...ops.assign import MaxIoUAssigner
from ...ops.boxes import clip_boxes, delta2bbox
from ...ops.gmm import GMMResult, gmm_em_1d
from ...ops.losses import (
    _FocalSparse,
    binary_cross_entropy,
    iou_loss_elementwise,
    sigmoid_focal_loss_sparse,
)
from ...ops.nms import NMSResult, multiclass_nms, top_k_stable
from .atss import anchor_valid, level_counts
from .fcos import flatten_outputs, per_image_mean, preselect_levels
from .gfl import _aligned_iou

_BIG = 3e38  # the loss of a slot that holds no candidate


@dataclasses.dataclass(frozen=True)
class PAAConfig:
    """The reference's ``PAAConfig`` with its defaults, less
    ``approx_top_k``."""

    num_classes: int = 80
    anchor_generator: AnchorGenerator = AnchorGenerator(
        strides=(8, 16, 32, 64, 128), ratios=(1.0,), octave_base_scale=8.0, scales_per_octave=1)
    target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    # the loose initial matching that defines each gt's candidate pool
    assigner: MaxIoUAssigner = MaxIoUAssigner(pos_iou_thr=0.1, neg_iou_thr=0.1, min_pos_iou=0.0)
    topk: int = 9  # candidates a level a gt
    gmm_iters: int = 25
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    reg_loss_weight: float = 1.3
    iou_loss_weight: float = 0.5
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.6
    pre_select_per_level: int = 1000
    pre_nms_top_k: int = 1000
    max_detections: int = 100
    score_voting: bool = True
    voting_sigma: float = 0.025  # exp(-(1-iou)^2 / sigma) proximity kernel


class Slates(NamedTuple):
    loss: Tensor  # (B, G, L * k) float32, ascending; 3e38 in a slot without a candidate
    index: Tensor  # (B, G, L * k) int64 anchor index
    valid: Tensor  # (B, G, L * k) bool


def candidate_slates(cfg: PAAConfig, anchor_loss: Tensor, assigned_gt: Tensor, gt_valid: Tensor,
                     counts: Tuple[int, ...]) -> Slates:
    """Each gt's slate: on each level the (at most) ``topk`` lowest losses
    of the anchors assigned to it (``top_k_stable`` of the negated losses,
    the lower index first on a tie; a level of fewer than ``topk`` anchors
    padded with 3e38), then sorted by loss (stable)."""
    g = gt_valid.shape[1]
    k = cfg.topk
    gt_ids = torch.arange(1, g + 1, device=assigned_gt.device)
    mine = assigned_gt[:, None, :] == gt_ids[None, :, None]  # (B, G, N)
    masked = torch.where(mine, anchor_loss[:, None, :], _BIG)
    losses, indices = [], []
    start = 0
    for cnt in counts:
        kk = min(k, cnt)
        neg, idx = top_k_stable(-masked[..., start:start + cnt], kk)  # lowest loss first
        v = -neg
        if kk < k:  # a tiny level: pad to the fixed slate width
            v = F.pad(v, (0, k - kk), value=_BIG)
            idx = F.pad(idx, (0, k - kk))
        losses.append(v)
        indices.append(idx + start)
        start += cnt
    loss, index = torch.cat(losses, dim=-1), torch.cat(indices, dim=-1)
    valid = (loss < _BIG * 0.5) & gt_valid[..., None]
    order = torch.argsort(torch.where(valid, loss, _BIG), dim=-1, stable=True)
    return Slates(*(torch.gather(t, -1, order) for t in (loss, index, valid)))


def separate(slates: Slates, res: GMMResult) -> Tensor:
    """(B, G, L * k) positives: the members of the lower-mean component
    (responsibility at least 0.5) up to the one of highest mixture
    likelihood, the first on a tie (rank arithmetic on the sorted slate)."""
    lo = res.means.argmin(dim=-1)  # the first on a tie
    r_lo = torch.gather(res.resp, -1, lo[..., None, None].expand(*res.resp.shape[:-1], 1))[..., 0]
    comp0 = (r_lo >= 0.5) & slates.valid
    rank = torch.cumsum(comp0.long(), dim=-1) - 1
    score = torch.where(comp0, res.log_prob, -torch.inf)
    best = torch.gather(rank, -1, score.argmax(dim=-1, keepdim=True))
    best = torch.where(comp0.any(dim=-1, keepdim=True), best, -1)
    return comp0 & (rank <= best)


def scatter_positives(slates: Slates, pos: Tensor, n: int) -> Tensor:
    """(B, N) int64 in {0, 1..G}: each positive anchor's gt, 0 elsewhere.
    The pools of the gts are disjoint (an anchor has one MaxIoU gt), so no
    two positives collide; the others go to an overflow slot."""
    b, g, m = pos.shape
    dest = torch.where(pos, slates.index, n).reshape(b, -1)
    gt = torch.arange(1, g + 1, device=pos.device)[None, :, None].expand(b, g, m).reshape(b, -1)
    return torch.zeros((b, n + 1), dtype=torch.int64, device=pos.device).scatter(1, dest, gt)[:, :n]


def paa_reassign(cfg: PAAConfig, anchor_loss: Tensor, assigned_gt: Tensor, gt_valid: Tensor,
                 counts: Tuple[int, ...]) -> Tensor:
    """GMM-split positives from the (B, N) candidate losses and MaxIoU
    assignment: (B, N) int64 in {0, 1..G} (0 = background)."""
    slates = candidate_slates(cfg, anchor_loss, assigned_gt, gt_valid, counts)
    res = gmm_em_1d(slates.loss, slates.valid, n_iter=cfg.gmm_iters)
    return scatter_positives(slates, separate(slates, res), anchor_loss.shape[1])


def initial_assignment(cfg: PAAConfig, anchors: Tensor, gt_boxes: Tensor, gt_labels: Tensor,
                       gt_valid: Tensor, img_shapes: Optional[Tensor]
                       ) -> Tuple[Tensor, Tensor, Tensor]:
    """The loose MaxIoU assignment ((B, N) int in {-1, 0, 1..G}, the valid
    anchors from ``img_shapes``), each anchor's (B, N, 4) gt box and (B, N)
    0-based label (-1 where it has none)."""
    assign = cfg.assigner(anchors, gt_boxes, gt_valid, gt_labels,
                          anchor_valid=anchor_valid(anchors, img_shapes))
    pos = assign.assigned_gt_inds > 0
    safe = (assign.assigned_gt_inds.long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    matched = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    label0 = torch.where(pos, assign.labels.long() - 1, torch.full_like(safe, -1))
    return assign.assigned_gt_inds, matched, label0


def candidate_losses(cfg: PAAConfig, anchors: Tensor, fc: Tensor, fr: Tensor, matched: Tensor,
                     label0: Tensor) -> Tensor:
    """(B, N) detached detection loss of each anchor under the initial
    assignment: its focal elements summed over the classes plus 1 - GIoU of
    its decoded box with its gt."""
    with torch.no_grad():
        cls = _FocalSparse.apply(fc.detach(), label0, cfg.focal_gamma, cfg.focal_alpha).sum(-1)
        decoded = delta2bbox(anchors[None], fr.detach(), cfg.target_means, cfg.target_stds,
                             wh_ratio_clip=16 / 1000)
        return cls + iou_loss_elementwise(decoded, matched, mode="giou", eps=1e-6)


def paa_loss(
    cfg: PAAConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    iou_preds: Sequence[Tensor],  # the head's third branch, the IoU logits
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) un-padded (h, w)
) -> Dict[str, Tensor]:
    """The focal loss over the positives' count, GIoU weighted by the
    detached IoU over that weight's sum (times ``reg_loss_weight``) and the
    IoU branch's BCE over the positives' count (times
    ``iou_loss_weight``); each per image, then averaged over the images."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in cls_scores]
    anchors = cfg.anchor_generator.flat_anchors(featmap_sizes, gt_boxes.device)
    counts = level_counts(cfg.anchor_generator, featmap_sizes)
    fc, fr, fi = flatten_outputs(cfg.num_classes, cls_scores, bbox_preds, iou_preds)
    assigned, matched0, label0_init = initial_assignment(cfg, anchors, gt_boxes, gt_labels,
                                                         gt_valid, img_shapes)
    anchor_loss = candidate_losses(cfg, anchors, fc, fr, matched0, label0_init)
    reassigned = paa_reassign(cfg, anchor_loss, assigned, gt_valid, counts)
    b, g = gt_valid.shape
    pos = reassigned > 0
    safe = (reassigned - 1).clamp(0, g - 1)
    matched = torch.gather(gt_boxes, 1, safe[..., None].expand(-1, -1, 4))
    label0 = torch.where(pos, torch.gather(gt_labels.long(), 1, safe) - 1, -1)
    num_pos = pos.sum(dim=1).float()
    per_image = 1.0 / (b * num_pos.clamp(min=1.0))
    loss_cls = sigmoid_focal_loss_sparse(fc, label0, weight=per_image[:, None, None],
                                         gamma=cfg.focal_gamma, alpha=cfg.focal_alpha)
    decoded = delta2bbox(anchors[None], fr, cfg.target_means, cfg.target_stds,
                         wh_ratio_clip=16 / 1000)
    iou_t = _aligned_iou(decoded, matched, eps=1e-6).detach()
    w_reg = torch.where(pos, iou_t.clamp(min=1e-6), 0.0)
    giou = iou_loss_elementwise(decoded, matched, mode="giou")
    loss_reg = per_image_mean((giou * w_reg).sum(1), w_reg.sum(1)) * cfg.reg_loss_weight
    loss_iou = binary_cross_entropy(fi, iou_t, weight=pos.float() * per_image[:, None])
    loss_iou = loss_iou * cfg.iou_loss_weight
    return {"loss_cls": loss_cls, "loss_reg": loss_reg, "loss_iou": loss_iou,
            "loss": loss_cls + loss_reg + loss_iou, "num_pos": num_pos.mean()}


def paa_candidates(cfg: PAAConfig, cls_scores: Sequence[Tensor], bbox_preds: Sequence[Tensor],
                   iou_preds: Sequence[Tensor], img_shapes: Optional[Tensor] = None
                   ) -> Tuple[Tensor, Tensor]:
    """Per-level preselection and the delta decode: (B, M, C)
    sqrt(sigmoid(cls) * sigmoid(iou)), at least 1e-6, and (B, M, 4) boxes,
    clipped to each image's (h, w) when ``img_shapes`` is given."""
    b = cls_scores[0].shape[0]
    level_anchors = cfg.anchor_generator.grid_anchors([tuple(s.shape[1:3]) for s in cls_scores],
                                                      cls_scores[0].device)
    level = [[a, r.reshape(b, -1, 4), c.reshape(b, -1, 1)]
             for a, r, c in zip(level_anchors, bbox_preds, iou_preds, strict=True)]
    logits, sel = preselect_levels(cfg.num_classes, cfg.pre_select_per_level, cls_scores, level)
    anchors, regs, iou = (torch.cat([s[i] for s in sel], dim=1) for i in range(3))
    boxes = delta2bbox(anchors, regs, cfg.target_means, cfg.target_stds, wh_ratio_clip=16 / 1000)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    scores = torch.sigmoid(torch.cat(logits, dim=1)) * torch.sigmoid(iou)
    return torch.sqrt(torch.clamp(scores, min=1e-12)), boxes


def score_voting(cfg: PAAConfig, det: NMSResult, cand_boxes: Tensor, cand_scores: Tensor) -> Tensor:
    """(B, D, 4): each kept box moved to the mean of the (B, K, 4)
    candidates weighted by their score at its class (above ``score_thr``)
    times ``exp(-(1 - iou)^2 / voting_sigma)`` (IoU above 0.01); a box with
    no such candidate, and an invalid slot, keeps its own."""
    iou = _aligned_iou(det.boxes[:, :, None, :], cand_boxes[:, None, :, :], eps=1e-6)  # B, D, K
    labels = det.labels.clamp(0, cand_scores.shape[-1] - 1)
    sc = torch.gather(cand_scores.transpose(1, 2), 1,
                      labels[..., None].expand(-1, -1, cand_scores.shape[1]))  # (B, D, K)
    w = torch.where((iou > 0.01) & (sc > cfg.score_thr),
                    sc * torch.exp(-torch.square(1.0 - iou) / cfg.voting_sigma), 0.0)
    denom = w.sum(dim=-1, keepdim=True)
    voted = torch.bmm(w, cand_boxes.float()) / denom.clamp(min=1e-6)
    return torch.where(det.valid[..., None] & (denom > 1e-6), voted, det.boxes)


def decode_paa(
    cfg: PAAConfig,
    cls_scores: Sequence[Tensor],
    bbox_preds: Sequence[Tensor],
    iou_preds: Sequence[Tensor],
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w), for clipping
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4), undone on the boxes
) -> NMSResult:
    """Per-level preselection -> delta decode -> NMS on sqrt(cls * iou) ->
    score voting over the candidates (with ``score_voting``), padded to (B,
    max_detections)."""
    scores, boxes = paa_candidates(cfg, cls_scores, bbox_preds, iou_preds, img_shapes)
    res = multiclass_nms(boxes, scores, iou_thr=cfg.nms_iou_thr, score_thr=cfg.score_thr,
                         pre_nms_top_k=cfg.pre_nms_top_k, max_out=cfg.max_detections)
    out = score_voting(cfg, res, boxes, scores) if cfg.score_voting else res.boxes
    if scale_factors is not None:
        out = out / scale_factors.reshape(out.shape[0], 1, -1).to(out.dtype)
    return res._replace(boxes=out)


def paa_inference(cfg: PAAConfig, model, images: Tensor, img_shapes: Optional[Tensor] = None,
                  scale_factors: Optional[Tensor] = None) -> NMSResult:
    """The detector's head outputs through ``decode_paa``."""
    return decode_paa(cfg, *model(images), img_shapes, scale_factors)
