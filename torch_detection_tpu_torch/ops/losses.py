"""Detection losses (mask-weighted, fixed shapes).

Counterpart of ``torch_detection_tpu/ops/losses.py``, cut to what the
two-stage slice uses. Every loss takes an elementwise ``weight`` and an
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
