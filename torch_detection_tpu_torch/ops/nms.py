"""Fixed-shape greedy NMS, batched over images.

Counterpart of ``torch_detection_tpu/ops/nms.py``. Outputs are padded to
``max_out`` rows (score 0, label -1, index -1, ``valid`` False), so the
caller's shapes do not depend on the data.

* Candidates are selected by a stable descending sort, so among equal
  scores the lower index comes first, as XLA's ``top_k`` orders them
  (``torch.topk`` promises no order for ties, and bf16 logits tie often).
* Greedy suppression is the reference's fixpoint iteration over a (K, K)
  IoU matrix, run for the whole batch at once: ``alive`` is updated for
  every image until no image changes. Iterations past an image's own
  fixpoint leave it unchanged, so the result is exact greedy NMS. Each
  convergence test is one host sync; ``suppress_syncs`` counts them.
* ``multiclass_nms`` shifts each candidate by ``class * (max_coord + 1)``
  so that boxes of different classes never overlap, and runs one NMS.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from .boxes import bbox_overlaps


class NMSResult(NamedTuple):
    boxes: Tensor  # (B, max_out, 4)
    scores: Tensor  # (B, max_out)
    labels: Tensor  # (B, max_out) int64 0-based class id (0 for single-class), -1 pad
    valid: Tensor  # (B, max_out) bool
    indices: Optional[Tensor] = None  # (B, max_out) int64 original candidate index, -1 pad


def top_k_stable(x: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The k largest values along the last dim, ties broken by lower index."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def suppress_syncs() -> int:
    """Host syncs spent by ``_greedy_suppress`` in this process so far."""
    return _greedy_suppress.syncs


def _greedy_suppress(iou: Tensor, iou_thr: float) -> Tensor:
    """(B, K) keep mask of greedy NMS over score-sorted candidates.

    Iterates ``alive <- NOT any_i (alive_i AND iou[i, j] > thr AND i < j)``
    to its fixpoint, which is exactly the sequential greedy solution, for
    every image at once, capped at K iterations as the reference."""
    b, k = iou.shape[0], iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    suppress = (iou > iou_thr) & upper  # row i suppresses column j
    alive = torch.ones((b, k), dtype=torch.bool, device=iou.device)
    prev = torch.zeros_like(alive)
    it = 0
    while it < k:
        _greedy_suppress.syncs += 1
        if not bool(torch.any(alive != prev)):
            break
        killed = torch.any(suppress & alive[:, :, None], dim=1)
        prev, alive = alive, ~killed
        it += 1
    return alive


_greedy_suppress.syncs = 0


def _compact(keep: Tensor, max_out: int, boxes: Tensor, scores: Tensor, labels: Tensor,
             indices: Tensor) -> NMSResult:
    """Move the kept rows to the front (stable), then crop or pad to max_out."""
    b, k = keep.shape
    rank = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    dest = torch.where(keep, rank, torch.full_like(rank, k))  # dropped rows -> overflow slot

    def scatter(src: Tensor, fill) -> Tensor:
        out = torch.full((b, k + 1, *src.shape[2:]), fill, dtype=src.dtype, device=src.device)
        idx = dest.reshape(b, k, *([1] * (src.dim() - 2))).expand_as(src)
        return out.scatter(1, idx, src)[:, :k]

    out_b = scatter(boxes, 0)
    out_s = scatter(torch.where(keep, scores, torch.zeros_like(scores)), 0)
    out_l = scatter(labels, -1)
    out_v = scatter(keep, False)
    out_i = scatter(indices, -1)
    if k >= max_out:
        out_b, out_s, out_l, out_v, out_i = (a[:, :max_out] for a in (out_b, out_s, out_l, out_v, out_i))
    else:
        pad = max_out - k

        def padded(a: Tensor, fill) -> Tensor:
            tail = torch.full((b, pad, *a.shape[2:]), fill, dtype=a.dtype, device=a.device)
            return torch.cat([a, tail], dim=1)

        out_b, out_s = padded(out_b, 0), padded(out_s, 0)
        out_l, out_v, out_i = padded(out_l, -1), padded(out_v, False), padded(out_i, -1)
    minus_one = torch.full_like(out_l, -1)
    return NMSResult(
        out_b, out_s, torch.where(out_v, out_l, minus_one), out_v,
        torch.where(out_v, out_i, minus_one),
    )


def nms(
    boxes: Tensor,  # (B, N, 4) or (N, 4)
    scores: Tensor,  # (B, N) or (N,)
    iou_thr: float = 0.5,
    score_thr: float = 0.0,
    max_out: int = 100,
    valid: Optional[Tensor] = None,
    offset: float = 1.0,
    pre_top_k: Optional[int] = None,
) -> NMSResult:
    """Single-class NMS with a fixed output shape.

    Suppression runs over the top ``pre_top_k`` candidates by score
    (default: all), and only then are the first ``max_out`` survivors kept,
    so slots freed by suppression backfill from lower-ranked candidates.
    Unbatched inputs give unbatched outputs."""
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    n = boxes.shape[1]
    neg = torch.full_like(scores, -1.0)
    s = torch.where(scores > score_thr, scores, neg)
    if valid is not None:
        s = torch.where(valid, s, neg)
    k = max(min(n, pre_top_k) if pre_top_k is not None else n, 1)

    top_s, top_i = top_k_stable(s, k)
    top_b = torch.gather(boxes, 1, top_i[..., None].expand(-1, -1, 4))
    iou = bbox_overlaps(top_b, top_b, offset=offset)
    keep = _greedy_suppress(iou, iou_thr) & (top_s > 0)
    res = _compact(keep, max_out, top_b, top_s, torch.zeros_like(top_i), top_i)
    return NMSResult(*(a[0] for a in res)) if single else res


def multiclass_nms(
    boxes: Tensor,  # (B, N, 4) or class-specific (B, N, C, 4); unbatched without B
    scores: Tensor,  # (B, N, C) class scores WITHOUT the background column
    iou_thr: float = 0.5,
    score_thr: float = 0.05,
    pre_nms_top_k: int = 1000,
    max_out: int = 100,
    valid: Optional[Tensor] = None,  # (B, N) bool
    offset: float = 1.0,
) -> NMSResult:
    """Class-wise NMS over (N, C) scores in one pass.

    Candidates are the top ``pre_nms_top_k`` (box, class) pairs by score;
    the class offset keeps suppression within a class. ``labels`` are
    0-based class indices. Unbatched inputs (2-d scores) give unbatched
    outputs."""
    single = scores.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    b, n, c = scores.shape
    flat = scores.reshape(b, n * c)  # box-major
    neg = torch.full_like(flat, -1.0)
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(c, dim=1), flat, neg)
    flat = torch.where(flat > score_thr, flat, neg)

    k = min(n * c, pre_nms_top_k)
    top_s, top_flat = top_k_stable(flat, k)
    box_idx = top_flat // c
    cls_idx = top_flat % c
    rows = torch.arange(b, device=scores.device)[:, None]
    cand = boxes[rows, box_idx, cls_idx] if boxes.dim() == 4 else boxes[rows, box_idx]

    # class-offset trick: disjoint coordinate islands per class
    max_coord = torch.amax(torch.abs(cand), dim=(1, 2)) + offset  # (B,)
    shifted = cand + (cls_idx.to(cand.dtype) * (max_coord[:, None] + 1.0))[..., None]
    iou = bbox_overlaps(shifted, shifted, offset=offset)
    keep = _greedy_suppress(iou, iou_thr) & (top_s > 0)
    res = _compact(keep, max_out, cand, top_s, cls_idx, box_idx)
    return NMSResult(*(a[0] for a in res)) if single else res
