"""Fixed-shape greedy NMS, Soft-NMS and Matrix NMS, batched over images.

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
  convergence test is one host sync; ``suppress_syncs`` counts them. Under
  ``torch.export`` the loop is a ``while_loop`` of the same condition and
  body, which an exported graph keeps.
* ``multiclass_nms`` shifts each candidate by ``class * (max_coord + 1)``
  so that boxes of different classes never overlap, and runs one NMS.
* Soft-NMS (``soft_nms``, ``multiclass_soft_nms``) is the reference's
  ``max_out``-step scan over the top-K pool, run for every image at once
  with no host sync: each step is an argmax (the first index among ties),
  a gather of one row of the (B, K, K) decay matrix, a product and a
  scatter of -inf at the pick. The decay of every pair is computed once before the scan: it is
  elementwise in the IoU, so each step multiplies by the values the
  reference computes from its IoU row.
* ``matrix_nms`` (SOLOv2) decays sorted scores by pairwise mask IoU: one
  float32 matmul (``ops/matmul.py``) and elementwise work, no loop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from .boxes import bbox_overlaps
from .matmul import float32_matmul


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
    every image at once, capped at K iterations as the reference. While
    ``torch.export`` traces, the same loop is a ``while_loop`` with the same
    condition and body, so the graph holds the fixpoint, not a count."""
    b, k = iou.shape[0], iou.shape[-1]
    upper = torch.ones((k, k), dtype=torch.bool, device=iou.device).triu(1)
    suppress = (iou > iou_thr) & upper  # row i suppresses column j
    alive = torch.ones((b, k), dtype=torch.bool, device=iou.device)
    prev = torch.zeros_like(alive)
    if torch.compiler.is_exporting():
        return _traced_fixpoint(suppress, alive, prev)
    it = 0
    while it < k:
        _greedy_suppress.syncs += 1
        if not bool(torch.any(alive != prev)):
            break
        killed = torch.any(suppress & alive[:, :, None], dim=1)
        prev, alive = alive, ~killed
        it += 1
    return alive


def _traced_fixpoint(suppress: Tensor, alive: Tensor, prev: Tensor) -> Tensor:
    """``_greedy_suppress``'s loop as ``torch._higher_order_ops.while_loop``:
    the condition ``it < K and any(alive != prev)``, the body one
    suppression step."""
    from torch._higher_order_ops import while_loop

    k = suppress.shape[-1]

    def cond(it, alive, prev):
        return (it < k) & torch.any(alive != prev)

    def body(it, alive, prev):
        killed = torch.any(suppress & alive[:, :, None], dim=1)
        return it + 1, ~killed, alive.clone()

    it = torch.zeros((), dtype=torch.int64, device=alive.device)
    return while_loop(cond, body, (it, alive, prev))[1]


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


def _soft_decay(iou: Tensor, method: str, sigma: float, iou_thr: float) -> Tensor:
    """Soft-NMS's factor of each pair: ``exp(-iou^2 / sigma)`` (gaussian;
    the division a product by float32's 1 / sigma, as XLA compiles the
    reference's and as CUDA divides by a scalar) or ``1 - iou`` above
    ``iou_thr`` (linear)."""
    if method == "gaussian":
        return torch.exp((iou * iou) * -float(np.float32(1.0) / np.float32(sigma)))
    return torch.where(iou > iou_thr, 1.0 - iou, torch.ones_like(iou))


def _soft_scan(decay: Tensor, scores: Tensor, max_out: int) -> Tuple[Tensor, Tensor]:
    """The reference's scan for every image at once: ``max_out`` picks of
    the pool's argmax, each multiplying the pool by its decay row and
    leaving the pool at -inf; (B, max_out) picked positions and their
    scores at their pick. Five gathers, products and scatters a step, no
    host sync."""
    w = scores.clone()
    k = w.shape[1]
    picked, picked_s = [], []
    for _ in range(max_out):
        i = torch.argmax(w, dim=1, keepdim=True)  # (B, 1)
        picked.append(i)
        picked_s.append(w.gather(1, i))
        w.mul_(decay.gather(1, i[..., None].expand(-1, 1, k))[:, 0])
        w.scatter_(1, i, -torch.inf)
    return torch.cat(picked, dim=1), torch.cat(picked_s, dim=1)


def take_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, idx[b]]`` for (B, K, ...) ``x`` and (B, P) ``idx``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def soft_nms(
    boxes: Tensor,  # (B, N, 4) or (N, 4)
    scores: Tensor,  # (B, N) or (N,)
    method: str = "gaussian",
    sigma: float = 0.5,
    iou_thr: float = 0.3,
    score_thr: float = 1e-3,
    max_out: int = 100,
    valid: Optional[Tensor] = None,
    offset: float = 1.0,
    pre_top_k: Optional[int] = None,
) -> NMSResult:
    """Single-class Soft-NMS (Bodla et al. 2017): each pick decays its
    neighbours' scores instead of removing them. The pool is the top
    ``pre_top_k`` by score (all by default; invalid rows enter at -1); a
    pick whose decayed score is not above ``score_thr`` is padding.
    Unbatched inputs give unbatched outputs."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"soft-NMS method {method!r} is not gaussian or linear")
    single = boxes.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    n = boxes.shape[1]
    s = scores.float()
    if valid is not None:
        s = torch.where(valid, s, torch.full_like(s, -1.0))
    k = max(min(n, pre_top_k) if pre_top_k is not None else n, 1)
    top_s, top_i = top_k_stable(s, k)
    top_b = take_rows(boxes, top_i)
    iou = bbox_overlaps(top_b, top_b, offset=offset).float()
    picked, picked_s = _soft_scan(_soft_decay(iou, method, sigma, iou_thr), top_s, max_out)
    out_v = picked_s > score_thr
    res = NMSResult(
        torch.where(out_v[..., None], take_rows(top_b, picked), 0.0),
        torch.where(out_v, picked_s, 0.0),
        torch.where(out_v, 0, -1),
        out_v,
        torch.where(out_v, torch.gather(top_i, 1, picked), -1),
    )
    return NMSResult(*(a[0] for a in res)) if single else res


def multiclass_soft_nms(
    boxes: Tensor,  # (B, N, 4) or class-specific (B, N, C, 4); unbatched without B
    scores: Tensor,  # (B, N, C)
    method: str = "gaussian",
    sigma: float = 0.5,
    iou_thr: float = 0.3,
    score_thr: float = 0.05,
    pre_nms_top_k: int = 1000,
    max_out: int = 100,
    valid: Optional[Tensor] = None,  # (B, N) bool
    offset: float = 1.0,
) -> NMSResult:
    """Class-wise Soft-NMS in one scan: the pool is the top
    ``pre_nms_top_k`` (box, class) pairs, those not above ``score_thr`` at
    -1, and ``multiclass_nms``'s class offset puts each class on a
    coordinate island of its own, so a cross-class pair has IoU 0 and
    decays nothing. Unbatched inputs (2-d scores) give unbatched outputs."""
    if method not in ("gaussian", "linear"):
        raise ValueError(f"soft-NMS method {method!r} is not gaussian or linear")
    single = scores.dim() == 2
    if single:
        boxes, scores = boxes[None], scores[None]
        valid = None if valid is None else valid[None]
    b, n, c = scores.shape
    flat = scores.reshape(b, n * c).float()
    neg = torch.full_like(flat, -1.0)
    if valid is not None:
        flat = torch.where(valid.repeat_interleave(c, dim=1), flat, neg)
    flat = torch.where(flat > score_thr, flat, neg)

    top_s, top_flat = top_k_stable(flat, min(n * c, pre_nms_top_k))
    box_idx = top_flat // c
    cls_idx = top_flat % c
    rows = torch.arange(b, device=scores.device)[:, None]
    cand = boxes[rows, box_idx, cls_idx] if boxes.dim() == 4 else boxes[rows, box_idx]
    max_coord = torch.amax(torch.abs(cand), dim=(1, 2)) + offset  # (B,)
    shifted = cand + (cls_idx.to(cand.dtype) * (max_coord[:, None] + 1.0))[..., None]
    iou = bbox_overlaps(shifted, shifted, offset=offset).float()
    picked, picked_s = _soft_scan(_soft_decay(iou, method, sigma, iou_thr), top_s, max_out)
    out_v = picked_s > score_thr
    res = NMSResult(
        torch.where(out_v[..., None], take_rows(cand, picked), 0.0),
        torch.where(out_v, picked_s, 0.0),
        torch.where(out_v, torch.gather(cls_idx, 1, picked), -1),
        out_v,
        torch.where(out_v, torch.gather(box_idx, 1, picked), -1),
    )
    return NMSResult(*(a[0] for a in res)) if single else res


def mask_iou_matrix(masks: Tensor, eps: float = 1e-6) -> Tensor:
    """Pairwise IoU of (..., K, M) binary masks -> (..., K, K) float32: the
    intersections one float32 matmul, exact for 0/1 masks of fewer than
    2^24 pixels, the union from the areas."""
    m = masks.float()
    inter = float32_matmul(m, m.transpose(-1, -2))
    areas = m.sum(dim=-1)
    union = areas[..., :, None] + areas[..., None, :] - inter
    return inter / union.clamp(min=eps)


def matrix_nms(
    masks: Tensor,  # (..., K, M) binary masks, sorted by descending score
    labels: Tensor,  # (..., K) class ids
    scores: Tensor,  # (..., K) descending
    valid: Tensor,  # (..., K) bool
    method: str = "gauss",
    sigma: float = 2.0,
) -> Tensor:
    """SOLOv2's Matrix NMS: candidate b's score times ``min_a f(iou_ab) /
    f(comp_a)`` over the higher-ranked valid candidates a of its class,
    ``comp_a`` a's own largest IoU with a higher-ranked one of its class,
    ``f`` gauss ``exp(-sigma iou^2)`` or linear ``1 - iou``. Returns the
    (..., K) decayed scores."""
    iou = mask_iou_matrix(masks)
    k = masks.shape[-2]
    same = ((labels[..., :, None] == labels[..., None, :]) & valid[..., :, None]
            & valid[..., None, :])
    # dom[a, b]: a of b's class ranked strictly above it
    dom = same & torch.ones((k, k), dtype=torch.bool, device=masks.device).triu(1)
    iou_d = torch.where(dom, iou, 0.0)
    comp = iou_d.amax(dim=-2)  # each candidate's compensation, as the dominated one
    if method == "gauss":
        decay = torch.exp(-sigma * (iou_d ** 2 - comp[..., :, None] ** 2))
    else:
        decay = (1.0 - iou_d) / (1.0 - comp[..., :, None]).clamp(min=1e-6)
    decay = torch.where(dom, decay, 1.0)
    return scores * decay.amin(dim=-2)
