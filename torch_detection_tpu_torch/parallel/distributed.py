"""Process groups for data-parallel training and evaluation: one process a
GPU, launched by torchrun.

Counterpart of ``torch_detection_tpu/parallel/distributed.py``. The
reference wires a TPU pod with ``jax.distributed.initialize`` and lets
GSPMD insert the collectives of its one program over the global batch; here
each rank is a process of its own, ``init_distributed`` joins it to the
group from torchrun's environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), and the collectives are
``torch.distributed``'s: NCCL between GPUs, gloo on the CPU.

In a group of several ranks every loss runs in a data-parallel step
(``parallel/train_step.py``), where:

* ``batch_normaliser`` turns a count over the batch (positives, valid
  rois, gt boxes) into the global batch's, so that the mean of the ranks'
  losses, which the gradient all-reduce averages, is the loss of the
  concatenated batch;
* ``global_rows`` makes a rank's random draws the rows of the global
  batch's draws that belong to its images.

In one process both leave their input as it is, and so they do within
``rank_local()``, where each micro-batch of an accumulated step lies on one
rank.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from ..utils.device import resolve_device

logger = logging.getLogger(__name__)

_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_RANK_LOCAL = False  # set within ``rank_local()``


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return int(value) if value not in (None, "") else default


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    """The number of ranks in the default group; 1 without one."""
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    """This process's rank in the default group; 0 without one."""
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    """Rank 0, the one rank that writes a run's files."""
    return rank() == 0


def _rank_device(device: torch.device, backend: str, local_rank: int) -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK`` for a CUDA run (or the
    index the caller names), else the CPU. NCCL refuses two ranks on one
    device, so a node with more ranks than GPUs raises under it; gloo lets
    them share, rank ``r`` on GPU ``r mod count``."""
    if device.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"backend nccl needs CUDA devices, not {device}")
        return device
    count = torch.cuda.device_count()
    local_ranks = _env_int("LOCAL_WORLD_SIZE", local_rank + 1)
    if backend == "nccl" and (local_ranks > count or device.index not in (None, local_rank)):
        raise ValueError(
            f"backend nccl with {local_ranks} ranks on {count} visible GPU(s): NCCL cannot run "
            "two ranks on one device; launch at most one rank a GPU, or name backend gloo")
    index = device.index if device.index is not None else local_rank
    if index >= count:
        if backend == "nccl":
            raise ValueError(f"local rank {local_rank} has no GPU of its own ({count} visible)")
        logger.warning("local rank %d shares cuda:%d (%d GPU(s) for %d ranks, gloo)",
                       local_rank, index % count, count, local_ranks)
        index %= count
    torch.cuda.set_device(index)
    return torch.device("cuda", index)


def init_distributed(
    backend: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    timeout_s: float = 1800.0,
) -> Dict[str, Any]:
    """Join this process to the default group as torchrun's environment
    says, and bind it to its device.

    With ``WORLD_SIZE`` unset or 1 nothing is initialised. Otherwise
    ``init_process_group`` runs with ``backend`` (``nccl`` for a CUDA
    ``device``, the default, ``gloo`` for the CPU) and any failure raises:
    a run asked to be N processes never goes on as one. A group that is
    already initialised is kept.

    Returns the reference's keys, ``process_index``, ``process_count``,
    ``local_devices`` and ``global_devices`` (every rank's device, in rank
    order), and ``device``, ``backend`` and ``initialized`` (True when
    this call created the group)."""
    world = _env_int("WORLD_SIZE", 1)
    local_rank = _env_int("LOCAL_RANK", 0)
    requested = resolve_device(device)
    if backend is None:
        backend = "nccl" if requested.type == "cuda" else "gloo"
    created = False
    if world > 1 and not is_initialized():
        missing = [k for k in _ENV if os.environ.get(k) in (None, "")]
        if missing:
            raise RuntimeError(f"WORLD_SIZE={world} but {missing} are not set: launch with "
                               "torchrun (python -m torch.distributed.run)")
        bound = _rank_device(requested, backend, local_rank)
        dist.init_process_group(backend=backend, init_method="env://", world_size=world,
                                rank=_env_int("RANK", 0),
                                timeout=datetime.timedelta(seconds=timeout_s))
        created = True
    elif is_initialized():
        backend = dist.get_backend()
        bound = _rank_device(requested, backend, local_rank)
    else:
        bound = requested
    devices: List[Optional[str]] = [str(bound)]
    if is_initialized():
        devices = [None] * world_size()
        dist.all_gather_object(devices, str(bound))
    info = {
        "process_index": rank(),
        "process_count": world_size(),
        "local_devices": [bound],
        "global_devices": [torch.device(d) for d in devices],
        "device": bound,
        "backend": backend if is_initialized() else None,
        "initialized": created,
    }
    logger.info("process %d/%d on %s (%s)", info["process_index"], info["process_count"], bound,
                info["backend"] or "one process")
    return info


def shutdown_distributed(info: Dict[str, Any]) -> None:
    """Destroy the default group if ``init_distributed`` (whose ``info``
    this is) created it, after a barrier, so that no rank leaves while
    another still needs it."""
    if info.get("initialized") and is_initialized():
        dist.barrier()
        dist.destroy_process_group()


def all_reduce_sum(x: Tensor) -> Tensor:
    """The sum of ``x`` over the ranks, as a new tensor on ``x``'s device
    (a CUDA tensor under NCCL); ``x`` itself in one process."""
    if not is_initialized() or world_size() == 1:
        return x
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM)
    return out


def all_gather_objects(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order (``[obj]`` in one process)."""
    if not is_initialized() or world_size() == 1:
        return [obj]
    out: List[Any] = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if not is_initialized() or world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_module(module: torch.nn.Module) -> None:
    """Give every rank rank 0's parameters and buffers (a no-op in one
    process), so that the replicas start from the same bits."""
    if not is_initialized() or world_size() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=0)


@contextlib.contextmanager
def rank_local() -> Iterator[None]:
    """Within: ``batch_normaliser`` and ``global_rows`` act as in one
    process, for a batch that lies whole on this rank (a micro-batch of an
    accumulated step, ``parallel/train_step.py``)."""
    global _RANK_LOCAL
    before, _RANK_LOCAL = _RANK_LOCAL, True
    try:
        yield
    finally:
        _RANK_LOCAL = before


def _batch_ranks() -> int:
    """The ranks the batch in flight is spread over."""
    return 1 if _RANK_LOCAL else world_size()


def batch_normaliser(count: Tensor, floor: float = 1.0) -> Tensor:
    """``max(count, floor)`` for a ``count`` summed over the batch's images,
    taken over the global batch in a group of several ranks:
    ``max(sum over the ranks, floor) / ranks``. A rank that divides its
    own images' sum by it contributes to the mean over the ranks exactly
    its share of the concatenated batch's loss. The sum is all-reduced
    before the floor, so that one rank with no positives still divides by
    the batch's count. ``count`` carries no gradient."""
    if count.requires_grad:
        raise ValueError("batch_normaliser takes a count that carries no gradient")
    ranks = _batch_ranks()
    if ranks == 1:
        return torch.clamp(count, min=floor)
    return torch.clamp(all_reduce_sum(count), min=floor) / ranks


def global_rows(draw: Callable[[Tuple[int, ...]], Tuple[Tensor, ...]]
                ) -> Callable[[Tuple[int, ...]], Tuple[Tensor, ...]]:
    """``draw(shape) -> tensors of shape`` as seen by this rank in a
    group of several ranks: the global batch's ``(ranks * B, ...)`` draws, of
    which it keeps rows ``[rank * B, (rank + 1) * B)``, so that its images
    get the draws they get in one process on the concatenated batch (a
    CUDA generator's stream depends on the whole shape, so drawing B rows
    alone would not). ``draw`` itself in one process."""
    ranks, me = _batch_ranks(), rank()
    if ranks == 1:
        return draw

    def rows(shape: Tuple[int, ...]) -> Tuple[Tensor, ...]:
        b = shape[0]
        return tuple(t.narrow(0, me * b, b) for t in draw((ranks * b,) + tuple(shape[1:])))

    return rows
