"""One training step: loss, gradients, a guard against non-finite values,
global-norm clipping and SGD with momentum and weight decay, or AdamW.

Counterpart of ``torch_detection_tpu/parallel/train_step.py``
(``make_train_step`` and ``make_optimizer``), cut to what the slice's
config uses: one optimizer step a call, on one device. The port's modules
hold their parameters, and the optimizer holds its state (the momentum, or
AdamW's moments) and the step count, so a step takes the batch alone.
Gradient accumulation, the EMA of the parameters and sharded state wait for
a later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch import Tensor


class Optimizer:
    """SGD with momentum and weight decay, or AdamW, over the parameters
    that require a gradient, its learning rate from a ``step -> lr``
    schedule, after an optional global-norm clip.

    ``torch.optim.SGD`` computes what the reference's optax chain
    ``add_decayed_weights(wd)`` + ``sgd(lr, momentum)`` computes: ``g + wd*p``
    into the momentum buffer ``m = momentum*m + g`` (``m = g`` at the first
    step), then ``p -= lr*m``. ``torch.optim.AdamW`` (b1 0.9, b2 0.999, eps
    1e-8) computes what ``optax.adamw(lr, weight_decay=wd)`` computes:
    ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd*p)``, the decay applied as
    ``p *= 1 - lr*wd`` first. Frozen parameters (``requires_grad=False``)
    are not in either, so neither they nor a state for them move.
    ``steps`` counts the steps taken, skipped ones included, as the
    reference's ``TrainState.step``; ``count`` the updates applied, which
    the schedule reads, as optax's count, which a skipped step restores."""

    def __init__(self, params: Iterable[Tensor], learning_rate: Union[float, Callable[[int], float]],
                 momentum: float, weight_decay: float, grad_clip_norm: Optional[float],
                 kind: str = "sgd"):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = learning_rate if callable(learning_rate) else (lambda step: learning_rate)
        self.grad_clip_norm = grad_clip_norm
        lr = float(self.schedule(0))
        if kind == "sgd":
            self.torch_optimizer = torch.optim.SGD(self.params, lr=lr, momentum=momentum,
                                                   weight_decay=weight_decay)
        elif kind == "adamw":
            self.torch_optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                                     eps=1e-8, weight_decay=weight_decay)
        else:
            raise NotImplementedError(f"optimizer {kind!r} is not ported")
        self.steps = 0
        self.count = 0

    def zero_grad(self) -> None:
        self.torch_optimizer.zero_grad(set_to_none=True)

    def _grads(self):
        """Every parameter's gradient; zeros for one the loss did not reach,
        which optax's chain decays all the same."""
        return [p.grad if p.grad is not None else torch.zeros_like(p) for p in self.params]

    def global_norm(self) -> Tensor:
        """sqrt of the sum of every gradient's squares, as ``optax.global_norm``."""
        return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(self._grads())))

    def apply(self, grad_norm: Tensor) -> None:
        """Clip the gradients by their global norm ``grad_norm`` with optax's
        formula (``g / norm * clip`` where ``norm >= clip``, no epsilon) and
        take one step at the scheduled rate."""
        grads = self._grads()
        if self.grad_clip_norm is not None:
            within = grad_norm < self.grad_clip_norm
            one = torch.ones_like(grad_norm)
            torch._foreach_div_(grads, torch.where(within, one, grad_norm))
            torch._foreach_mul_(grads, torch.where(within, one, one * self.grad_clip_norm))
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.torch_optimizer.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.torch_optimizer.step()
        self.count += 1


def make_optimizer(
    params: Iterable[Tensor],
    learning_rate: Union[float, Callable[[int], float]] = 0.01,
    momentum: float = 0.9,
    weight_decay: float = 1e-4,
    grad_clip_norm: Optional[float] = None,
    kind: str = "sgd",
) -> Optimizer:
    """SGD + momentum + weight decay, the detection default, or AdamW
    (``kind="adamw"``, the transformer families'; ``momentum`` unused), with
    an optional global-norm clip. The frozen stages' parameters carry
    ``requires_grad=False`` and are left out."""
    return Optimizer(params, learning_rate, momentum, weight_decay, grad_clip_norm, kind)


def make_train_step(
    loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]],
    optimizer: Optimizer,
) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """``train_step(batch) -> metrics``: one forward, one backward, one
    optimizer step. ``loss_fn(batch, step) -> (loss, metrics)``.

    A step whose loss or gradient norm is NaN or Inf changes neither the
    parameters nor the optimizer's state, and its metrics carry ``skipped_nonfinite``
    = 1 (0 otherwise). The guard reads both scalars on the host, one sync a
    step; the reference selects on the device instead."""

    def train_step(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        optimizer.zero_grad()
        loss, metrics = loss_fn(batch, step=optimizer.steps)
        loss.backward()
        grad_norm = optimizer.global_norm()
        ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if ok:
            optimizer.apply(grad_norm)
        optimizer.zero_grad()
        optimizer.steps += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
        return metrics

    return train_step
