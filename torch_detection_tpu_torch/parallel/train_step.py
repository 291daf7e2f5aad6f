"""One training step: loss, gradients, a guard against non-finite values,
global-norm clipping and SGD with momentum and weight decay, or AdamW; on
one process or data-parallel over a ``torch.distributed`` group.

Counterpart of ``torch_detection_tpu/parallel/train_step.py``
(``make_train_step`` and ``make_optimizer``), one optimizer step a call.
The port's modules hold their parameters, and the optimizer holds its state
(the momentum, or AdamW's moments) and the step count, so a step takes the
batch alone.

The reference's data-parallel step is one GSPMD program over the global
batch, so N devices give what one gives on the concatenated batch. Here
each rank holds its own shard of the batch, and the step keeps that promise
so: in a group of several ranks every normaliser that counts over the batch
counts over the global one (``distributed.batch_normaliser``) and each
rank's sampling draws are its rows of the global batch's draws
(``distributed.global_rows``); the mean
of the ranks' losses is then the global loss, and the mean of their
gradients its gradient. After the backward the gradients are all-reduced
explicitly, one flat bucket a dtype, and averaged (a ``DistributedDataParallel``
would reduce nothing: the losses call the detector's submodules, never a
wrapper's ``forward``). Every rank then holds the same gradients, the same
norm and so the same skip decision and update, and the replicas stay
identical bit for bit. Under FSDP (``mesh.shard_model``) FSDP2 averages the
gradients by reduce-scatter, each rank keeps its shards of the parameters,
gradients and optimizer state, and the global norm sums the squares of
every shard. Gradient accumulation and the EMA of the parameters wait for a
later slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import torch
from torch import Tensor, nn

from .distributed import all_reduce_sum, world_size
from .mesh import local_tensor


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
    the schedule reads, as optax's count, which a skipped step restores.
    ``fsdp_root`` is the ``mesh.LossRoot`` of a model sharded by FSDP,
    whose parameters (``DTensor`` shards) these are; None otherwise."""

    def __init__(self, params: Iterable[Tensor], learning_rate: Union[float, Callable[[int], float]],
                 momentum: float, weight_decay: float, grad_clip_norm: Optional[float],
                 kind: str = "sgd", fsdp_root: Optional[nn.Module] = None):
        self.params = [p for p in params if p.requires_grad]
        self.fsdp_root = fsdp_root
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

    def reduce_gradients(self) -> None:
        """Average every gradient over the ranks, in place: one all-reduce of
        a flat bucket a dtype. A parameter the loss did not reach takes part
        with zeros. Nothing to do in one process or under FSDP, whose
        backward has reduce-scattered its gradients already."""
        ranks = world_size()
        if ranks == 1 or self.fsdp_root is not None:
            return
        grads = self._grads()
        for p, g in zip(self.params, grads):
            p.grad = g
        for dtype in sorted({g.dtype for g in grads}, key=str):
            bucket = [g for g in grads if g.dtype == dtype]
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in bucket]))
            flat.div_(ranks)
            for g, t in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(t.view_as(g))

    def global_norm(self) -> Tensor:
        """sqrt of the sum of every gradient's squares, as ``optax.global_norm``;
        under FSDP the squares of every rank's shards, all-reduced."""
        grads = [local_tensor(g) for g in self._grads()]
        if self.fsdp_root is None:
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        squares = torch.stack([torch.linalg.vector_norm(g.float()) ** 2 for g in grads]).sum()
        return torch.sqrt(all_reduce_sum(squares))

    def apply(self, grad_norm: Tensor) -> None:
        """Clip the gradients by their global norm ``grad_norm`` with optax's
        formula (``g / norm * clip`` where ``norm >= clip``, no epsilon) and
        take one step at the scheduled rate."""
        grads = self._grads()
        for p, g in zip(self.params, grads):
            p.grad = g
        if self.grad_clip_norm is not None:
            within = grad_norm < self.grad_clip_norm
            one = torch.ones_like(grad_norm)
            shards = [local_tensor(g) for g in grads]  # in place through the shards' storage
            torch._foreach_div_(shards, torch.where(within, one, grad_norm))
            torch._foreach_mul_(shards, torch.where(within, one, one * self.grad_clip_norm))
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
    fsdp_root: Optional[nn.Module] = None,
) -> Optimizer:
    """SGD + momentum + weight decay, the detection default, or AdamW
    (``kind="adamw"``, the transformer families'; ``momentum`` unused), with
    an optional global-norm clip. The frozen stages' parameters carry
    ``requires_grad=False`` and are left out. ``fsdp_root``: the root
    ``mesh.shard_model`` returned for the model these parameters are of."""
    return Optimizer(params, learning_rate, momentum, weight_decay, grad_clip_norm, kind,
                     fsdp_root)


def make_train_step(
    loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]],
    optimizer: Optimizer,
) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """``train_step(batch) -> metrics``: one forward, one backward, one
    optimizer step. ``loss_fn(batch, step) -> (loss, metrics)``.

    A step whose loss or gradient norm is NaN or Inf changes neither the
    parameters nor the optimizer's state, and its metrics carry ``skipped_nonfinite``
    = 1 (0 otherwise). The guard reads both scalars on the host, one sync a
    step; the reference selects on the device instead.

    In a group of more than one rank, ``batch`` is the rank's shard and the
    step is the global batch's (module docstring): the loss and every
    metric returned are the mean over the ranks, one all-reduce for all of
    them, so the loss and the loss parts are the global batch's, and so is
    a count that a family reports as a mean over the images; a count summed
    over the batch (``num_pos_rois``) reads per rank. The guard decides
    from the global loss and the global gradient norm, the same on every
    rank."""
    ranks = world_size()

    def forward(batch: Dict[str, Tensor]):
        if optimizer.fsdp_root is not None:
            return optimizer.fsdp_root(loss_fn, batch, optimizer.steps)
        return loss_fn(batch, step=optimizer.steps)

    def train_step(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        optimizer.zero_grad()
        loss, metrics = forward(batch)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["loss"] = loss.detach()
        if ranks > 1:
            optimizer.reduce_gradients()
            names = sorted(metrics)
            means = all_reduce_sum(torch.stack([metrics[k].float().reshape(()) for k in names]))
            metrics = dict(zip(names, (means / ranks).unbind()))
        loss = metrics["loss"]
        grad_norm = optimizer.global_norm()
        ok = bool(torch.isfinite(loss) & torch.isfinite(grad_norm))
        if ok:
            optimizer.apply(grad_norm)
        optimizer.zero_grad()
        optimizer.steps += 1
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
        return metrics

    return train_step
