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
every shard.

``accum_steps`` splits a step's batch into micro-batches, each with its own
forward, backward and normalisers, and averages their losses, metrics and
gradients before the one optimizer step, as the reference's ``lax.scan``
does. The reference splits the global batch, whose rows are the ranks'
shards in rank order; where ``accum_steps`` is a multiple of the ranks each
micro-batch lies whole on one rank (``distributed.rank_local``), and any
other count over several ranks raises by name. ``ParamEMA`` keeps the
exponential moving average of the parameters.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from .distributed import all_reduce_sum, rank_local, world_size
from .mesh import copy_full_, full_tensor, local_tensor


class ParamEMA:
    """The exponential moving average of every parameter of a model, the
    frozen ones too, as the reference keeps ``ema_params`` beside
    ``params`` (``parallel/train_step.py:55-66``, ``:178-192``).

    After an applied update at step ``t`` (the step count before the
    update, skipped steps included) each average becomes ``d * e + (1 - d)
    * p`` with ``d = min(decay, (1 + t) / (10 + t))``, computed in float32
    and cast to the parameter's dtype. A skipped step leaves it as it was.
    Under FSDP each average is a shard like its parameter's."""

    def __init__(self, model: nn.Module, decay: float):
        self.decay = float(decay)
        named = list(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        with torch.no_grad():
            self.tensors = [p.detach().clone() for p in self.params]

    def rate(self, step: int) -> float:
        """``d`` of step ``step`` in float32, as the reference computes it."""
        t = np.float32(step)
        return float(min(np.float32(self.decay), (np.float32(1) + t) / (np.float32(10) + t)))

    @torch.no_grad()
    def update(self, step: int) -> None:
        d = np.float32(self.rate(step))
        keep, take = float(d), float(np.float32(1) - d)
        pairs = [(local_tensor(e), local_tensor(p.detach())) for e, p in zip(self.tensors,
                                                                               self.params)]
        f32 = [(e, p) for e, p in pairs if e.dtype == p.dtype == torch.float32]
        if f32:  # the training build's parameters: two fused passes over all of them
            emas, params = zip(*f32)
            torch._foreach_mul_(emas, keep)
            torch._foreach_add_(emas, params, alpha=take)
        for e, p in pairs:
            if not e.dtype == p.dtype == torch.float32:
                e.copy_(e.float() * keep + p.float() * take)

    @torch.no_grad()
    def reset(self) -> None:
        """Start the averages from the parameters."""
        for e, p in zip(self.tensors, self.params):
            local_tensor(e).copy_(local_tensor(p.detach()))

    def state_dict(self) -> Dict[str, Tensor]:
        """Each average whole, by parameter name (every rank must call it
        under FSDP)."""
        return {n: full_tensor(e) for n, e in zip(self.names, self.tensors)}

    @torch.no_grad()
    def load_state_dict(self, state: Dict[str, Tensor]) -> None:
        missing = set(self.names) - set(state)
        unexpected = set(state) - set(self.names)
        if missing or unexpected:
            raise RuntimeError(f"EMA state: missing {sorted(missing)}, unexpected "
                               f"{sorted(unexpected)}")
        for n, e in zip(self.names, self.tensors):
            copy_full_(e, state[n])

    @contextlib.contextmanager
    def applied(self) -> Iterator[None]:
        """Within: the model's parameters hold the averages (each rank its
        shards); they are given back on exit."""
        with torch.no_grad():
            saved = [local_tensor(p.detach()).clone() for p in self.params]
            for p, e in zip(self.params, self.tensors):
                local_tensor(p.detach()).copy_(local_tensor(e))
        try:
            yield
        finally:
            with torch.no_grad():
                for p, v in zip(self.params, saved):
                    local_tensor(p.detach()).copy_(v)


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
    whose parameters (``DTensor`` shards) these are; None otherwise.
    ``ema`` is the ``ParamEMA`` the step updates, or None."""

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
        self.ema: Optional[ParamEMA] = None

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


def micro_batches_per_rank(accum_steps: int, ranks: int) -> int:
    """The micro-batches each rank runs a step: ``accum_steps / ranks``.
    The reference splits the global batch into ``accum_steps`` contiguous
    micro-batches; only where the ranks divide that count does each lie
    whole on one rank. Any other count over several ranks would need rows
    exchanged between the ranks, and raises."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")
    if accum_steps > 1 and accum_steps % ranks:
        raise NotImplementedError(
            f"accum_steps={accum_steps} over {ranks} ranks: a micro-batch would span ranks; "
            "only a multiple of the ranks is ported")
    return accum_steps // ranks if accum_steps > 1 else 1


def split_batch(batch: Dict[str, Tensor], parts: int) -> List[Dict[str, Tensor]]:
    """``batch``'s leading axis cut into ``parts`` contiguous micro-batches
    (views); every tensor's leading axis is the batch's."""
    size = batch["image"].shape[0]
    if size % parts:
        raise ValueError(f"a batch of {size} images does not split into {parts} micro-batches")
    step = size // parts
    return [{k: v.narrow(0, i * step, step) if isinstance(v, Tensor) else v
             for k, v in batch.items()} for i in range(parts)]


def make_train_step(
    loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]],
    optimizer: Optimizer,
    accum_steps: int = 1,
) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """``train_step(batch) -> metrics``: one forward and one backward a
    micro-batch, one optimizer step. ``loss_fn(batch, step) -> (loss,
    metrics)``.

    With ``accum_steps > 1`` the batch is cut into contiguous micro-batches
    (``accum_steps / ranks`` a rank), each with its own normalisers; every
    micro-batch of a step gets the same ``step``, so a loss that draws from
    it draws the same noise for each (R15, as the reference's
    ``fold_in(key, step)``). Losses, metrics and gradients are summed over
    the micro-batches and scaled by one over their count, then the step
    goes on as for one batch: the guard and the clip read the averages,
    and the schedule counts optimizer steps.

    A step whose loss or gradient norm is NaN or Inf changes neither the
    parameters, the optimizer's state nor the EMA, and its metrics carry
    ``skipped_nonfinite`` = 1 (0 otherwise). The guard reads both scalars on
    the host, one sync a step; the reference selects on the device instead.
    After an applied step ``optimizer.ema`` (if any) takes the new
    parameters.

    In a group of more than one rank, ``batch`` is the rank's shard and the
    step is the global batch's (module docstring): the loss and every
    metric returned are the mean over the ranks, one all-reduce for all of
    them, so the loss and the loss parts are the global batch's, and so is
    a count that a family reports as a mean over the images; a count summed
    over the batch (``num_pos_rois``) reads per rank. The guard decides
    from the global loss and the global gradient norm, the same on every
    rank."""
    ranks = world_size()
    micro = micro_batches_per_rank(accum_steps, ranks)

    def forward(batch: Dict[str, Tensor]):
        if optimizer.fsdp_root is not None:
            return optimizer.fsdp_root(loss_fn, batch, optimizer.steps)
        return loss_fn(batch, step=optimizer.steps)

    def accumulate(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """Every micro-batch's forward and backward; the averages."""
        sums: Dict[str, Tensor] = {}
        scope = rank_local() if accum_steps > 1 else contextlib.nullcontext()
        with scope:
            for part in split_batch(batch, micro) if micro > 1 else [batch]:
                loss, metrics = forward(part)
                loss.backward()
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["loss"] = loss.detach()
                for k, v in metrics.items():
                    sums[k] = sums[k] + v if k in sums else v
        if micro > 1:
            inv = 1.0 / micro
            sums = {k: v * inv for k, v in sums.items()}
            grads = [local_tensor(p.grad) for p in optimizer.params if p.grad is not None]
            if grads:
                torch._foreach_mul_(grads, inv)
        return sums

    def train_step(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        optimizer.zero_grad()
        metrics = accumulate(batch)
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
            if optimizer.ema is not None:
                optimizer.ema.update(optimizer.steps)
        optimizer.zero_grad()
        optimizer.steps += 1
        metrics["skipped_nonfinite"] = torch.tensor(0.0 if ok else 1.0)
        return metrics

    return train_step
