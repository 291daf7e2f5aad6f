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
does. The reference splits the global batch, whose rows are the data
ranks' shards in rank order, into ``accum_steps`` contiguous micro-batches,
so a micro-batch may span ranks: each rank runs the parts of the
micro-batches its shard holds, in micro-batch order, with no rows moved
(``micro_batch_parts``), and its normalisers and draws are the
micro-batch's (``distributed.batch_part``), summed over the ranks that
share it. ``ParamEMA`` keeps the exponential moving average of the
parameters.

On a ``(data, model)`` mesh (``mesh.make_mesh``) the ranks of a model group
hold the same images: the normalisers and draws count the data ranks, and
the gradients are averaged over the data ranks of this rank's model index.
Under tensor parallelism (``tensor_parallel.py``) those gradients are the
shards and the replicated parameters' equal copies; on row bands
(``spatial.py``, a ``RowBatch``) each rank of a model group runs the loss
at ``1/model``, and the gradients are summed over the group before the
data ranks' mean.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from . import spatial
from .distributed import (BatchPart, all_reduce_sum, batch_part, data_group, data_rank,
                          data_size, model_group, model_size, world_size)
from .mesh import copy_full_, fsdp_modules, full_tensor, is_sharded, local_tensor


def sharded_axes(t: Tensor) -> Tuple[str, ...]:
    """The mesh dims a ``DTensor`` is sharded over (``_StridedShard`` too),
    sorted; () for a whole tensor."""
    if not is_sharded(t):
        return ()
    names = t.device_mesh.mesh_dim_names or ("data",)
    return tuple(sorted(n for n, pl in zip(names, t.placements)
                        if not (pl.is_replicate() or pl.is_partial())))


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
        # a tensor-parallel model holds DTensor shards beside whole tensors, which one
        # multi-tensor kernel cannot take together: the optimizer then steps them one by one
        foreach = False if len({is_sharded(p) for p in self.params}) > 1 else None
        if kind == "sgd":
            self.torch_optimizer = torch.optim.SGD(self.params, lr=lr, momentum=momentum,
                                                   weight_decay=weight_decay, foreach=foreach)
        elif kind == "adamw":
            self.torch_optimizer = torch.optim.AdamW(self.params, lr=lr, betas=(0.9, 0.999),
                                                     eps=1e-8, weight_decay=weight_decay,
                                                     foreach=foreach)
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

    def reduce_gradients(self, bands: bool = False) -> None:
        """Average every gradient over the data ranks, in place: one
        all-reduce of a flat bucket for each dtype and group. A parameter
        the loss did not reach takes part with zeros. A replicated
        parameter's gradient is averaged over every rank, so that the
        copies a model group computes (equal up to the device's rounding
        order) stay one; a tensor-parallel shard's over the data ranks of
        its model index; an FSDP shard's, which FSDP's reduce-scatter has
        averaged over the data ranks already, over its model group.
        ``bands``: the gradients of a step on row bands, where each rank of
        a model group holds its rows' share: summed over the group, then
        averaged over the data ranks."""
        if world_size() == 1:
            return
        grads = self._grads()
        for p, g in zip(self.params, grads):
            p.grad = g
        buckets: Dict[Tuple[str, float, str], List[Tensor]] = {}
        groups = {"all": None, "data": data_group(), "model": model_group()}
        for g in grads:
            axes = sharded_axes(g)
            if "data" in axes:  # FSDP's: averaged over the data ranks in the backward
                if "model" in axes or model_size() == 1:
                    continue
                over, divisor = "model", (1 if bands else model_size())
            elif "model" in axes:  # a tensor-parallel shard
                over, divisor = "data", data_size()
            else:
                over, divisor = "all", (data_size() if bands else world_size())
            buckets.setdefault((over, float(divisor), str(g.dtype)), []).append(local_tensor(g))
        for (over, divisor, _), bucket in sorted(buckets.items()):  # one order on every rank
            flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in bucket]), groups[over])
            if divisor > 1:
                flat.div_(divisor)
            for g, t in zip(bucket, flat.split([g.numel() for g in bucket])):
                g.copy_(t.view_as(g))

    def global_norm(self) -> Tensor:
        """sqrt of the sum of every gradient's squares, as ``optax.global_norm``;
        a sharded gradient's squares (FSDP's, tensor parallelism's) summed
        over the ranks it is sharded across, a replicated one's once."""
        grads = self._grads()
        if not any(is_sharded(g) for g in grads):
            return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        sums: Dict[Tuple[str, ...], List[Tensor]] = {}
        for g in grads:
            sums.setdefault(sharded_axes(g), []).append(
                torch.linalg.vector_norm(local_tensor(g).float()) ** 2)
        total = None
        for axes, squares in sorted(sums.items()):
            part = torch.stack(squares).sum()
            if axes == ("data",):
                part = all_reduce_sum(part, data_group())
            elif axes == ("model",):
                part = all_reduce_sum(part, model_group())
            elif axes:
                part = all_reduce_sum(part)
            total = part if total is None else total + part
        return torch.sqrt(total)

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


def micro_batch_parts(accum_steps: int, ranks: int, rows: int,
                      index: int) -> List[Tuple[int, int, int, int]]:
    """The parts of the step's micro-batches that data rank ``index`` of
    ``ranks`` holds, each ``rows`` images a rank: ``(micro-batch, first row
    in the rank's shard, first row in the micro-batch, rows)``, in
    micro-batch order. The global batch is the ranks' shards in rank
    order, cut into ``accum_steps`` contiguous micro-batches, as the
    reference cuts it. With ``accum_steps=3`` over 2 ranks of 3 images,
    rank 0 holds micro-batch 0 and the first row of micro-batch 1, rank 1
    the second row of micro-batch 1 and micro-batch 2."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps {accum_steps} < 1")
    total = rows * ranks
    if total % accum_steps:
        raise ValueError(f"a global batch of {total} images does not split into {accum_steps} "
                         "micro-batches")
    size = total // accum_steps
    lo, hi = index * rows, (index + 1) * rows
    parts = []
    for m in range(lo // size, (hi - 1) // size + 1):
        a, b = max(lo, m * size), min(hi, (m + 1) * size)
        parts.append((m, a - lo, a - m * size, b - a))
    return parts


def micro_batch_ranks(accum_steps: int, ranks: int, rows: int, m: int) -> List[int]:
    """The data ranks that hold rows of micro-batch ``m``."""
    size = rows * ranks // accum_steps
    return list(range(m * size // rows, ((m + 1) * size - 1) // rows + 1))


_PART_GROUPS: Dict[Tuple[int, ...], Tuple[object, Dict[int, object]]] = {}


def micro_batch_groups(accum_steps: int, rows: int) -> Dict[int, object]:
    """``{micro-batch: the process group of the ranks that hold its rows}``
    for this rank's micro-batches that span ranks (those of its model index).
    Built once for a layout: every rank creates every group, in one order."""
    import torch.distributed as dist

    ranks, models = data_size(), model_size()
    world = dist.group.WORLD
    key = (accum_steps, rows, ranks, models)
    if _PART_GROUPS.get(key, (None,))[0] is not world:  # built in this default group
        me = dist.get_rank()
        mine: Dict[int, object] = {}
        for model_index in range(models):
            for m in range(accum_steps):
                members = micro_batch_ranks(accum_steps, ranks, rows, m)
                if len(members) < 2:
                    continue
                global_ranks = [d * models + model_index for d in members]
                group = dist.new_group(global_ranks)
                if me in global_ranks:
                    mine[m] = group
        _PART_GROUPS[key] = (world, mine)
    return _PART_GROUPS[key][1]


@contextlib.contextmanager
def fsdp_held(root: nn.Module) -> Iterator[Callable[[], None]]:
    """Within: every FSDP module under ``root`` gathered whole now, one
    all-gather each in one order on every rank, and kept whole through the
    parts' forwards and backwards, their gradients accumulated unsharded;
    call the function it yields before the last part, whose backward
    reduce-scatters them and shards the parameters again. A rank's parts
    then issue no collective of FSDP's between the gather and its last
    backward, so the normalisers' sums over the ranks that share a
    micro-batch, which each rank reaches after another count of parts,
    meet no FSDP collective in between (where FSDP gathered a module in
    each part's forward, two ranks would wait on each other's)."""
    modules = fsdp_modules(root)
    units = [m for m in modules if m is not root]
    root._get_fsdp_state()._lazy_init()  # the root's, which the first forward would run
    for m in modules:
        m.unshard()
    for m in modules:
        m.set_reshard_after_backward(False, recurse=False)
        m.set_requires_gradient_sync(False, recurse=False)
    for m in units:  # the root keeps its parameters whole after its forward anyway
        m.set_reshard_after_forward(False, recurse=False)

    def last() -> None:
        for m in modules:
            m.set_reshard_after_backward(True, recurse=False)
            m.set_requires_gradient_sync(True, recurse=False)

    try:
        yield last
    finally:
        last()
        for m in units:
            m.set_reshard_after_forward(True, recurse=False)
        for m in modules:
            m.reshard()


def split_batch(batch: Dict[str, Tensor], parts: int) -> List[Dict[str, Tensor]]:
    """``batch``'s leading axis cut into ``parts`` contiguous micro-batches
    (views); every tensor's leading axis is the batch's."""
    size = batch["image"].shape[0]
    if size % parts:
        raise ValueError(f"a batch of {size} images does not split into {parts} micro-batches")
    step = size // parts
    return [narrow_batch(batch, i * step, step) for i in range(parts)]


def narrow_batch(batch: Dict[str, Tensor], start: int, rows: int) -> Dict[str, Tensor]:
    """Rows ``[start, start + rows)`` of every tensor of ``batch`` (views),
    a ``RowBatch``'s bands kept as such."""
    leaves = {k: v.narrow(0, start, rows) if isinstance(v, Tensor) else v for k, v in batch.items()}
    return batch.with_leaves(leaves) if isinstance(batch, spatial.RowBatch) else leaves


def make_train_step(
    loss_fn: Callable[..., Tuple[Tensor, Dict[str, Tensor]]],
    optimizer: Optimizer,
    accum_steps: int = 1,
) -> Callable[[Dict[str, Tensor]], Dict[str, Tensor]]:
    """``train_step(batch) -> metrics``: one forward and one backward a
    micro-batch, one optimizer step. ``loss_fn(batch, step) -> (loss,
    metrics)``.

    With ``accum_steps > 1`` the global batch is cut into contiguous
    micro-batches, each with its own normalisers, and each rank runs the
    parts its shard holds (``micro_batch_parts``); every micro-batch of a
    step gets the same ``step``, so a loss that draws from it draws the
    same noise for each (R15, as the reference's ``fold_in(key, step)``).
    Losses, metrics and gradients are averaged over the micro-batches,
    each part weighted by its rows: the reference's ``(1/A) sum_m L_m``.
    Then the step goes on as for one batch: the guard and the clip read
    the averages, and the schedule counts optimizer steps.

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
    over the batch (``num_pos_rois``) reads per data rank. The guard decides
    from the global loss and the global gradient norm, the same on every
    rank. A ``spatial.RowBatch`` (``mesh.shard_batch(spatial=True)``) runs
    on row bands (``spatial.bands``)."""
    ranks = world_size()

    def forward(batch: Dict[str, Tensor]):
        scope = spatial.bands(batch) if isinstance(batch, spatial.RowBatch) else \
            contextlib.nullcontext()
        with scope:
            if optimizer.fsdp_root is not None:
                return optimizer.fsdp_root(loss_fn, batch, optimizer.steps)
            return loss_fn(batch, step=optimizer.steps)

    def accumulate(batch: Dict[str, Tensor], scale: float) -> Dict[str, Tensor]:
        """Every part's forward and backward, the loss at ``scale``; the
        averages. Under FSDP, where a micro-batch spans ranks, the parts run
        within ``fsdp_held``."""
        held = contextlib.nullcontext()
        if accum_steps == 1:
            runs = [(batch, None, 1.0)]
        else:
            rows = batch["image"].shape[0]
            if optimizer.fsdp_root is not None and accum_steps % data_size():
                held = fsdp_held(optimizer.fsdp_root)
            groups = micro_batch_groups(accum_steps, rows) if data_size() > 1 else {}
            size = rows * data_size() // accum_steps
            runs = [(narrow_batch(batch, offset, k), BatchPart(start, k, size, groups.get(m)),
                     k / rows)
                    for m, offset, start, k in micro_batch_parts(accum_steps, data_size(), rows,
                                                                  data_rank())]
        even = len({w for _, _, w in runs}) == 1  # equal weights: scale once at the end
        sums: Dict[str, Tensor] = {}
        with held as last:
            for i, (part, where, weight) in enumerate(runs):
                if last is not None and i == len(runs) - 1:
                    last()
                with batch_part(where) if where is not None else contextlib.nullcontext():
                    loss, metrics = forward(part)
                w = 1.0 if even else weight
                (loss * (w * scale) if w * scale != 1.0 else loss).backward()
                metrics = {k: v.detach() for k, v in metrics.items()}
                metrics["loss"] = loss.detach()
                for k, v in metrics.items():
                    v = v * w if w != 1.0 else v
                    sums[k] = sums[k] + v if k in sums else v
        if even and runs[0][2] != 1.0:
            inv = runs[0][2]
            sums = {k: v * inv for k, v in sums.items()}
            grads = [local_tensor(p.grad) for p in optimizer.params if p.grad is not None]
            if grads:
                torch._foreach_mul_(grads, inv)
        return sums

    def train_step(batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        optimizer.zero_grad()
        bands = isinstance(batch, spatial.RowBatch)
        if bands:
            spatial.check_no_tensor_parallel(optimizer.params)
        metrics = accumulate(batch, 1.0 / batch.sharding.parts if bands else 1.0)
        if ranks > 1:
            optimizer.reduce_gradients(bands)
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
