"""Anchor to gt assignment (fixed shapes, masked), batched over images.

Counterpart of ``torch_detection_tpu/ops/assign.py``, cut to what the
ported slices call: ``MaxIoUAssigner`` with its rules 1-4, every anchor
that ties a gt's best IoU taking it (the reference's
``gt_max_assign_all=True``), and ``anchor_valid``; and ``ATSSAssigner``
(ATSS and GFL). The ignore-region rule waits for a caller. Labels come from
plain indexing; the reference's one-hot matmul (``ops/tpu_gather.py``) is a
TPU workaround with the same values.

``assigned_gt_inds``: -1 = ignored, 0 = negative (background), k > 0 = gt k.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence

import torch
from torch import Tensor

from .boxes import bbox_overlaps
from .nms import top_k_stable


class AssignResult(NamedTuple):
    assigned_gt_inds: Tensor  # (..., N) int32 in {-1, 0, 1..G}
    max_overlaps: Tensor  # (..., N) float32, IoU with the best gt
    labels: Tensor  # (..., N) int32 label of the assigned gt, 0 where none


@dataclasses.dataclass(frozen=True)
class MaxIoUAssigner:
    """Assign each anchor to the gt with the highest IoU.

    Rules, in order: (1) everything starts ignored; (2) anchors whose best
    IoU is under ``neg_iou_thr`` are negative; (3) anchors at or above
    ``pos_iou_thr`` take that gt; (4) every anchor that ties a gt's best IoU
    takes that gt if the IoU is at least ``min_pos_iou`` (and above 0); an
    anchor that ties several gts takes the one of highest IoU, the first on a
    tie. Anchors outside ``anchor_valid`` are ignored. With no valid gt every
    anchor is negative."""

    pos_iou_thr: float = 0.5
    neg_iou_thr: float = 0.4
    min_pos_iou: float = 0.0

    def __call__(
        self,
        anchors: Tensor,  # (..., N, 4)
        gt_boxes: Tensor,  # (..., G, 4) zero-padded
        gt_valid: Tensor,  # (..., G) bool
        gt_labels: Optional[Tensor] = None,  # (..., G) int
        anchor_valid: Optional[Tensor] = None,  # (..., N) bool
    ) -> AssignResult:
        overlaps = bbox_overlaps(anchors, gt_boxes)  # (..., N, G)
        overlaps = torch.where(gt_valid[..., None, :], overlaps, torch.full_like(overlaps, -1.0))
        max_overlaps, argmax_overlaps = overlaps.max(dim=-1)

        any_gt = gt_valid.any(dim=-1, keepdim=True)  # (..., 1)
        assigned = torch.full(max_overlaps.shape, -1, dtype=torch.int32, device=anchors.device)
        is_neg = (max_overlaps < self.neg_iou_thr) | ~any_gt
        assigned = torch.where(is_neg, torch.zeros_like(assigned), assigned)
        is_pos = any_gt & (max_overlaps >= self.pos_iou_thr)
        assigned = torch.where(is_pos, argmax_overlaps.to(torch.int32) + 1, assigned)

        gt_max = overlaps.max(dim=-2).values  # (..., G)
        qualify = gt_valid & (gt_max >= self.min_pos_iou) & (gt_max > 0)
        tie = (overlaps == gt_max[..., None, :]) & qualify[..., None, :]
        tie_best = torch.where(tie, overlaps, torch.full_like(overlaps, -torch.inf)).argmax(dim=-1)
        assigned = torch.where(tie.any(dim=-1), tie_best.to(torch.int32) + 1, assigned)

        if anchor_valid is not None:
            assigned = torch.where(anchor_valid, assigned, torch.full_like(assigned, -1))

        if gt_labels is None:
            labels = torch.zeros_like(assigned)
        else:
            safe = (assigned.long() - 1).clamp(0, gt_boxes.shape[-2] - 1)
            gathered = torch.gather(gt_labels.to(torch.int32), -1, safe)
            labels = torch.where(assigned > 0, gathered, torch.zeros_like(gathered))
        return AssignResult(assigned, max_overlaps, labels)


@dataclasses.dataclass(frozen=True)
class ATSSAssigner:
    """Adaptive Training Sample Selection (Zhang et al., CVPR 2020), every
    image of the batch at once.

    For each gt and each pyramid level, the ``topk`` anchors whose centres
    lie nearest the gt's centre are its candidates. The gt's IoU threshold
    is the mean plus the unbiased standard deviation of its L * k candidate
    IoUs; a candidate at or above it whose centre lies inside the gt (by
    more than 0.01) is a positive, and an anchor claimed by several gts
    goes to the one of highest IoU (the first on a tie). Anchors outside
    ``anchor_valid`` take IoU -1, never become candidates where a valid one
    is nearer, and are ignored (-1); invalid gts take no anchor.

    The per-level top-k runs on the full (G, N_l) squared distances with
    ``top_k_stable``, the lower index first among equal distances, as XLA's
    ``top_k``: on a regular grid equal distances are the common case, and
    ``torch.topk`` promises no order among them. The reference's windowed
    candidate path (``_window_candidates``) is a TPU speed device that it
    proves equal to this full path. The threshold's sums run in float64
    and round to float32, so the GPU and the CPU, which sum in other
    orders, take the same threshold."""

    topk: int = 9

    def __call__(
        self,
        anchors: Tensor,  # (N, 4) flat, level-major
        level_counts: Sequence[int],
        gt_boxes: Tensor,  # (B, G, 4) zero-padded
        gt_valid: Tensor,  # (B, G) bool
        gt_labels: Optional[Tensor] = None,  # (B, G) int
        anchor_valid: Optional[Tensor] = None,  # (B, N) bool
    ) -> AssignResult:
        b, g = gt_boxes.shape[:2]
        n = anchors.shape[0]
        if sum(level_counts) != n:
            raise ValueError(f"level counts {tuple(level_counts)} do not sum to {n} anchors")
        overlaps = bbox_overlaps(anchors, gt_boxes)  # (B, N, G)
        acx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        acy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        gcx = (gt_boxes[..., 0] + gt_boxes[..., 2]) * 0.5  # (B, G)
        gcy = (gt_boxes[..., 1] + gt_boxes[..., 3]) * 0.5
        # squared distances select the same top-k; (B, G, N), gt-major
        dist2 = (acx[None, None] - gcx[..., None]) ** 2 + (acy[None, None] - gcy[..., None]) ** 2
        if anchor_valid is not None:
            overlaps = torch.where(anchor_valid[..., None], overlaps,
                                   torch.full_like(overlaps, -1.0))
            dist2 = torch.where(anchor_valid[:, None], dist2, torch.full_like(dist2, torch.inf))
        parts, start = [], 0
        for n_l in level_counts:
            _, idx = top_k_stable(-dist2[..., start:start + n_l], min(self.topk, n_l))
            parts.append(idx + start)
            start += n_l
        cand = torch.cat(parts, dim=-1)  # (B, G, K)
        k = cand.shape[-1]

        cand_iou = torch.gather(overlaps.transpose(1, 2), 2, cand)  # (B, G, K)
        mean = (cand_iou.double().sum(-1) / k).float()
        var = (((cand_iou - mean[..., None]) ** 2).double().sum(-1) / max(k - 1, 1)).float()
        thr = mean + torch.sqrt(var)
        ccx, ccy = acx[cand], acy[cand]
        eps = 0.01
        inside = ((ccx - gt_boxes[..., 0:1] > eps) & (ccy - gt_boxes[..., 1:2] > eps)
                  & (gt_boxes[..., 2:3] - ccx > eps) & (gt_boxes[..., 3:4] - ccy > eps))
        is_pos = (cand_iou >= thr[..., None]) & inside & gt_valid[..., None]

        # each (anchor, gt) pair is at most one gt's candidate once: a scatter
        pos_mask = torch.zeros((b, n, g), dtype=torch.bool, device=anchors.device)
        pos_mask.scatter_(1, cand.transpose(1, 2), is_pos.transpose(1, 2))
        masked = torch.where(pos_mask, overlaps, torch.full_like(overlaps, -torch.inf))
        best = masked.argmax(dim=-1)  # (B, N), the first of equal maxima
        has_pos = pos_mask.any(dim=-1)
        assigned = torch.where(has_pos, best.to(torch.int32) + 1, torch.zeros_like(best, dtype=torch.int32))
        if anchor_valid is not None:
            assigned = torch.where(anchor_valid, assigned, torch.full_like(assigned, -1))
        best_iou = torch.gather(overlaps, 2, best[..., None])[..., 0]
        max_overlaps = torch.where(has_pos, best_iou, torch.zeros_like(best_iou))
        if gt_labels is None:
            labels = torch.zeros_like(assigned)
        else:
            gathered = torch.gather(gt_labels.to(torch.int32), 1, best)
            labels = torch.where(assigned > 0, gathered, torch.zeros_like(gathered))
        return AssignResult(assigned, max_overlaps, labels)
