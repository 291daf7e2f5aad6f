"""Detection losses (mask-weighted, fixed shapes).

Counterpart of ``torch_detection_tpu/ops/losses.py``, cut to what the
two-stage, RetinaNet and Sparse R-CNN slices use. Every loss takes an elementwise ``weight`` and an
``avg_factor``; the reduction is an explicit sum over the weighted elements
divided by ``max(avg_factor, 1)``, so padded rows with weight 0 drop out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import Tensor


def _reduce(loss: Tensor, weight: Optional[Tensor], avg_factor: Optional[Tensor]) -> Tensor:
    if weight is not None:
        loss = loss * weight
    total = loss.sum()
    if avg_factor is None:
        return total
    return total / torch.clamp(torch.as_tensor(avg_factor, dtype=total.dtype,
                                               device=total.device), min=1.0)


def optax_sigmoid_ce(logits: Tensor, labels: Tensor) -> Tensor:
    """Numerically stable elementwise sigmoid cross-entropy."""
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(torch.exp(-logits.abs()))


def _focal_terms(x: Tensor, t: Tensor, alpha: float):
    """p, ce, p_t and alpha_t of the focal loss, float32 ``x`` and one-hot ``t``."""
    p = torch.sigmoid(x)
    ce = optax_sigmoid_ce(x, t)
    p_t = p * t + (1 - p) * (1 - t)
    alpha_t = alpha * t + (1 - alpha) * (1 - t)
    return p, ce, p_t, alpha_t


def sigmoid_focal_loss(
    logits: Tensor,  # (..., C)
    targets: Tensor,  # (..., C) one-hot {0, 1}
    weight: Optional[Tensor] = None,
    gamma: float = 2.0,
    alpha: float = 0.25,
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    """RetinaNet's focal loss FL(p_t) = -alpha_t (1 - p_t)^gamma log(p_t),
    on a dense one-hot target."""
    _, ce, p_t, alpha_t = _focal_terms(logits, targets, alpha)
    return _reduce(alpha_t * (1 - p_t) ** gamma * ce, weight, avg_factor)


def _one_hot(label0: Tensor, num_classes: int) -> Tensor:
    classes = torch.arange(num_classes, device=label0.device)
    return (label0[..., None] == classes).to(torch.float32)


class _FocalSparse(torch.autograd.Function):
    """The elementwise focal loss from integer labels, float32 inside with
    autocast off, and the reference's analytic derivative. It saves only the
    logits (in their dtype, bf16 in training) and the labels, as the
    reference's custom VJP (``_focal_sparse_elem``): the one-hot target and
    the float32 terms are rebuilt in the backward instead of being kept as
    (B, N, C) float32 residuals."""

    @staticmethod
    def forward(ctx, logits: Tensor, label0: Tensor, gamma: float, alpha: float) -> Tensor:
        ctx.save_for_backward(logits, label0)
        ctx.gamma, ctx.alpha = gamma, alpha
        with torch.autocast(logits.device.type, enabled=False):
            x = logits.to(torch.float32)
            _, ce, p_t, alpha_t = _focal_terms(x, _one_hot(label0, x.shape[-1]), alpha)
            return alpha_t * (1 - p_t) ** gamma * ce

    @staticmethod
    def backward(ctx, g: Tensor):
        logits, label0 = ctx.saved_tensors
        gamma = ctx.gamma
        with torch.autocast(logits.device.type, enabled=False):
            x = logits.to(torch.float32)
            t = _one_hot(label0, x.shape[-1])
            p, ce, p_t, alpha_t = _focal_terms(x, t, ctx.alpha)
            one_m = 1 - p_t
            # dL/dx = alpha_t [-gamma (1-p_t)^(gamma-1) p (1-p) (2t-1) ce + (1-p_t)^gamma (p - t)]
            dldx = alpha_t * (-gamma * one_m ** (gamma - 1) * p * (1 - p) * (2 * t - 1) * ce
                              + one_m ** gamma * (p - t))
            return (g * dldx).to(logits.dtype), None, None, None


def sigmoid_focal_loss_sparse(
    logits: Tensor,  # (..., C) any float dtype
    label0: Tensor,  # (...,) int 0-based foreground class, -1 = a background row
    weight: Optional[Tensor] = None,
    gamma: float = 2.0,
    alpha: float = 0.25,
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    """``sigmoid_focal_loss`` on the one-hot of ``label0`` without building
    it: the same values, a float32 loss, a gradient in the logits' dtype."""
    return _reduce(_FocalSparse.apply(logits, label0, gamma, alpha), weight, avg_factor)


def binary_cross_entropy(logits: Tensor, targets: Tensor, weight: Optional[Tensor] = None,
                         avg_factor: Optional[Tensor] = None) -> Tensor:
    return _reduce(optax_sigmoid_ce(logits, targets), weight, avg_factor)


def softmax_cross_entropy(
    logits: Tensor,  # (..., C)
    labels: Tensor,  # (...,) int
    weight: Optional[Tensor] = None,
    avg_factor: Optional[Tensor] = None,
) -> Tensor:
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    return _reduce(nll, weight, avg_factor)


def smooth_l1_loss(pred: Tensor, target: Tensor, weight: Optional[Tensor] = None,
                   beta: float = 1.0 / 9.0, avg_factor: Optional[Tensor] = None) -> Tensor:
    """Huber-style box regression loss."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return _reduce(loss, weight, avg_factor)


_IOU_MODES = ("iou", "giou", "linear_iou", "square_iou")


def iou_loss_elementwise(pred: Tensor, target: Tensor, mode: str = "giou", offset: float = 1.0,
                         eps: float = 1e-7) -> Tensor:
    """The unreduced IoU loss of each pair of xyxy boxes, ``pred`` and
    ``target`` broadcast against each other: (G, 1, 4) against (1, Q, 4)
    gives the (G, Q) matrix of every pair. ``giou``: 1 - GIoU; ``iou``:
    -log(IoU); ``linear_iou``: 1 - IoU; ``square_iou``: 1 - IoU^2."""
    if mode not in _IOU_MODES:
        raise ValueError(f"iou mode {mode!r} is not one of {_IOU_MODES}")
    lt = torch.maximum(pred[..., :2], target[..., :2])
    rb = torch.minimum(pred[..., 2:4], target[..., 2:4])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    ap = (pred[..., 2] - pred[..., 0] + offset) * (pred[..., 3] - pred[..., 1] + offset)
    at = (target[..., 2] - target[..., 0] + offset) * (target[..., 3] - target[..., 1] + offset)
    union = torch.clamp(ap + at - inter, min=eps)
    iou = inter / union
    if mode == "iou":
        return -torch.log(torch.clamp(iou, eps, 1.0))
    if mode == "linear_iou":
        return 1.0 - iou
    if mode == "square_iou":
        return 1.0 - iou ** 2
    elt = torch.minimum(pred[..., :2], target[..., :2])
    erb = torch.maximum(pred[..., 2:4], target[..., 2:4])
    ewh = torch.clamp(erb - elt + offset, min=0.0)
    enclose = torch.clamp(ewh[..., 0] * ewh[..., 1], min=eps)
    return 1.0 - (iou - (enclose - union) / enclose)


def iou_loss(pred: Tensor, target: Tensor, weight: Optional[Tensor] = None, mode: str = "giou",
             offset: float = 1.0, eps: float = 1e-7,
             avg_factor: Optional[Tensor] = None) -> Tensor:
    """``iou_loss_elementwise`` reduced as every loss here: the weighted sum
    over ``max(avg_factor, 1)``, or the plain sum without either."""
    return _reduce(iou_loss_elementwise(pred, target, mode, offset, eps), weight, avg_factor)
