"""The device mesh and the FSDP plan.

Counterpart of ``torch_detection_tpu/parallel/mesh.py``. The reference
builds a ``(data, model)`` ``jax.sharding.Mesh`` and states its strategies
as shardings: the batch over ``data``, and under ``fsdp=True`` each leaf of
8192 elements or more sharded over ``data`` as well (ZeRO-3), with GSPMD
inserting the all-gathers and reduce-scatters. Here the mesh is a
``DeviceMesh`` with one ``data`` axis over the ranks
(``init_device_mesh``), each rank loads its own shard of the batch, so
``shard_batch`` has nothing to move, and FSDP is FSDP2's ``fully_shard``:

* ``shard_model`` shards each unit the loss functions call through its
  ``forward`` (the backbone's stages, then the detector's children:
  backbone, neck, heads), then a root that holds the detector and whose
  ``forward`` runs the loss (``LossRoot``). The losses call the
  detector's submodules directly, never the detector's own ``forward``
  as a whole, so without that root FSDP's lazy initialisation would take
  the first unit to run as its root.
* FSDP2 shards every parameter on dim 0 (``torch.chunk`` over the ranks),
  biases and norm scales too, where the reference replicates leaves under
  8192 elements. Each rank's numbers are the same either way; only what
  it holds between steps differs.

Tensor parallelism (``model > 1``) and spatial partitioning (image rows
over ``model``) are not ported and raise ``NotImplementedError``.
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch import Tensor, nn

from .distributed import world_size


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: str = "cuda"):
    """A one-axis ``DeviceMesh`` named ``data`` over the ranks of the
    default group (``data`` None: all of them). ``model > 1`` raises."""
    if model != 1:
        raise NotImplementedError(f"mesh model={model}: tensor parallelism is not ported")
    n = world_size()
    data = n if data is None else data
    if data != n:
        raise ValueError(f"mesh data={data} != {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (data,), mesh_dim_names=("data",))


def spatial_sharding(mesh) -> None:
    """The reference's rows-over-``model`` image sharding: not ported."""
    raise NotImplementedError("spatial_sharding (image rows over the mesh's model axis) is not "
                              "ported")


def shard_batch(mesh, batch: Dict[str, Any], spatial: bool = False) -> Dict[str, Any]:
    """The rank's batch as the mesh's ``data`` shard: each rank's loader
    already yields its own images, so nothing moves. ``spatial=True``
    raises."""
    if spatial:
        spatial_sharding(mesh)
    return batch


class LossRoot(nn.Module):
    """FSDP's root: the detector as its one child, and a ``forward`` that
    runs ``loss_fn(batch, step=step)``, so that the root's hooks (lazy
    initialisation, the gather of the detector's own parameters, the
    wait for the last reduce-scatter) run once a step."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, loss_fn: Callable, batch: Dict[str, Tensor], step: int):
        return loss_fn(batch, step=step)


def fsdp_units(model: nn.Module) -> List[nn.Module]:
    """The modules ``shard_model`` shards before the root, innermost
    first: each child of the backbone, then each child of the detector,
    that holds parameters. Each is called through its ``forward`` by the
    detector's methods."""
    units: List[nn.Module] = []
    backbone = getattr(model, "backbone", None)
    if isinstance(backbone, nn.Module):
        units += [m for m in backbone.children() if any(True for _ in m.parameters())]
    units += [m for m in model.children() if any(True for _ in m.parameters())]
    return units


def shard_model(model: nn.Module, mesh) -> LossRoot:
    """Apply FSDP2 to ``model`` in place over ``mesh``'s ranks: each of
    ``fsdp_units`` then the ``LossRoot`` that is returned. Build the
    optimizer after this call: the parameters become ``DTensor`` shards.
    FSDP2 averages the gradients over the ranks, as the data-parallel
    step's all-reduce does."""
    from torch.distributed.fsdp import fully_shard

    with torch.no_grad():  # FSDP shards contiguous tensors only: the convs' channels_last goes
        for p in model.parameters():
            p.data = p.data.contiguous()
    for unit in fsdp_units(model):
        fully_shard(unit, mesh=mesh)
    root = LossRoot(model)
    fully_shard(root, mesh=mesh)
    return root


def is_sharded(t: Tensor) -> bool:
    """Whether ``t`` is a ``DTensor``. A process that never imported the
    module (seconds of operator registration) holds none, and does not pay
    for the import here."""
    dtensor = sys.modules.get("torch.distributed.tensor")
    return dtensor is not None and isinstance(t, dtensor.DTensor)


def full_tensor(t: Tensor) -> Tensor:
    """The whole of a sharded tensor (an all-gather every rank must join),
    or ``t``."""
    return t.full_tensor() if is_sharded(t) else t


def local_tensor(t: Tensor) -> Tensor:
    """This rank's shard of a sharded tensor (sharing its storage), or ``t``."""
    return t.to_local() if is_sharded(t) else t


def shard_like(full: Tensor, like: Tensor) -> Tensor:
    """``full`` on ``like``'s device, and sharded as ``like`` where that is
    sharded: each rank keeps its own chunk of its own copy, so every rank
    must hold the same ``full``, and nothing is communicated."""
    if not is_sharded(like):
        return full.to(like.device)
    from torch.distributed.tensor import distribute_tensor

    local = like.to_local()
    return distribute_tensor(full.to(local.device), like.device_mesh, like.placements,
                             src_data_rank=None)


def copy_full_(dst: Tensor, src: Tensor) -> None:
    """Copy the whole tensor ``src`` into ``dst``, or into this rank's
    shard of ``dst``."""
    if is_sharded(dst):
        dst.to_local().copy_(shard_like(src.to(dst.dtype), dst).to_local())
    else:
        dst.copy_(src)


def fsdp_modules(root: nn.Module) -> List[nn.Module]:
    from torch.distributed.fsdp import FSDPModule

    return [m for m in root.modules() if isinstance(m, FSDPModule)]


@contextlib.contextmanager
def unsharded(root: Optional[nn.Module]) -> Iterator[None]:
    """Within: every parameter under the FSDP ``root`` whole on each rank
    and kept whole across forwards, for inference outside the training
    step (validation); sharded again on exit. Every rank must enter. A
    ``root`` of None does nothing. Each ``FrozenBatchNorm``'s cached fold
    is dropped on entry: the all-gather writes the step's statistics into
    the same parameters without a trace that its cache key would see."""
    if root is None:
        yield
        return
    from ..models.layers import FrozenBatchNorm  # here: the models import this package

    modules = fsdp_modules(root)
    units = [m for m in modules if m is not root]
    for m in modules:
        m.unshard()
    for m in root.modules():
        if isinstance(m, FrozenBatchNorm):
            m.forget_fold()
    for m in units:
        m.set_reshard_after_forward(False, recurse=False)
    try:
        yield
    finally:
        for m in units:
            m.set_reshard_after_forward(True, recurse=False)
        for m in modules:
            m.reshard()
