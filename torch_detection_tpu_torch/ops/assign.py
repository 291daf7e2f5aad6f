"""Anchor to gt assignment (fixed shapes, masked), batched over images.

Counterpart of ``torch_detection_tpu/ops/assign.py``, cut to what the
two-stage slice calls: ``MaxIoUAssigner`` with its rules 1-4, every anchor
that ties a gt's best IoU taking it (the reference's
``gt_max_assign_all=True``), and ``anchor_valid``. The ignore-region rule
waits for a caller. Labels come from plain indexing; the reference's one-hot
matmul (``ops/tpu_gather.py``) is a TPU workaround with the same values.

``assigned_gt_inds``: -1 = ignored, 0 = negative (background), k > 0 = gt k.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
from torch import Tensor

from .boxes import bbox_overlaps


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
