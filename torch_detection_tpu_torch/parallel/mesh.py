"""The device mesh, the FSDP plan, and the batch's shards.

Counterpart of ``torch_detection_tpu/parallel/mesh.py``. The reference
builds a ``(data, model)`` ``jax.sharding.Mesh`` and states its strategies
as shardings: the batch over ``data``, under ``fsdp=True`` each leaf of
8192 elements or more sharded over ``data`` as well (ZeRO-3), wide kernels'
output channels over ``model`` (tensor parallelism), and with
``spatial=True`` the images' rows over ``model``; GSPMD inserts the
collectives. Here the mesh is a ``DeviceMesh`` of the same shape and names
over the ranks (``init_device_mesh``), rank ``d * model + m`` at
``(d, m)``; each rank loads its own shard of the batch, the ranks of a
model group the same one, so ``shard_batch`` moves nothing; tensor
parallelism is ``tensor_parallel.apply_tensor_parallel`` and the rows'
partitioning ``spatial.py``. FSDP is FSDP2's ``fully_shard`` over the
mesh's ``data`` dim:

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
  it holds between steps differs. A tensor-parallel shard is sharded
  again over ``data`` (FSDP2's two-dimensional form).
"""

from __future__ import annotations

import contextlib
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch import Tensor, nn

from . import spatial
from .distributed import MeshGroups, set_mesh, world_size


def make_mesh(data: Optional[int] = None, model: int = 1, device_type: str = "cuda"):
    """A ``(data, model)`` ``DeviceMesh`` named ``("data", "model")`` over
    the ranks of the default group (``data`` None: the ranks over
    ``model``), with the reference's checks; it becomes the ranks' layout
    (``distributed.set_mesh``): the batch is spread over the data ranks.
    Every rank must call it."""
    n = world_size()
    if data is None:
        if n % model:
            raise ValueError(f"mesh model={model} does not divide the {n} ranks")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))
    set_mesh(MeshGroups(data, model, mesh.get_local_rank("data"), mesh.get_local_rank("model"),
                        mesh.get_group("data"), mesh.get_group("model")))
    return mesh


def spatial_sharding(mesh) -> spatial.RowSharding:
    """The reference's NHWC sharding with the batch over ``data`` and the
    image rows over ``model``: this rank's place among its model group's
    ranks, by which ``shard_batch(spatial=True)`` cuts its bands."""
    return spatial.RowSharding(mesh.size(mesh.mesh_dim_names.index("model")),
                               mesh.get_local_rank("model"), mesh.get_group("model"))


def shard_batch(mesh, batch: Dict[str, Any], spatial: bool = False) -> Dict[str, Any]:
    """The rank's batch as the mesh's ``data`` shard: each rank's loader
    already yields its own images, so nothing moves. ``spatial=True`` also
    cuts each 4-D leaf whose rows (dim 1 of NHWC) ``model`` divides to this
    rank's band of them (a ``spatial.RowBatch``, which the training step
    runs on bands); the other leaves stay whole, as in the reference."""
    if not spatial:
        return batch
    from . import spatial as rows

    return rows.band_batch(batch, spatial_sharding(mesh))


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
    """Apply FSDP2 to ``model`` in place over ``mesh``'s ``data`` ranks:
    each of ``fsdp_units`` then the ``LossRoot`` that is returned. Build the
    optimizer after this call: the parameters become ``DTensor`` shards.
    FSDP2 averages the gradients over the data ranks, as the data-parallel
    step's all-reduce does. A model already sharded by tensor parallelism
    (over the same mesh's ``model`` dim) keeps its shards, sharded again."""
    from torch.distributed.fsdp import fully_shard

    if mesh.mesh_dim_names and "data" in mesh.mesh_dim_names and mesh.ndim > 1:
        mesh = mesh["data"]
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
    or ``t``. A tensor-parallel shard (one dim of a one-dim mesh, split
    evenly) is gathered by ``torch.distributed.all_gather``, which gloo
    also runs on CUDA tensors (ranks sharing a card); any other through
    ``DTensor.full_tensor``."""
    if not is_sharded(t):
        return t
    mesh, placements = t.device_mesh, t.placements
    if mesh.ndim == 1 and len(placements) == 1 and placements[0].is_shard():
        import torch.distributed as dist

        dim, local = placements[0].dim, t.to_local()
        if local.shape[dim] * mesh.size() == t.shape[dim]:
            parts = [torch.empty_like(local, memory_format=torch.contiguous_format)
                     for _ in range(mesh.size())]
            dist.all_gather(parts, local.contiguous(), group=mesh.get_group())
            return torch.cat(parts, dim=dim)
    return t.full_tensor()


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
