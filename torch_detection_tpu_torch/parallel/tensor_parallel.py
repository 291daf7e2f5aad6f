"""Tensor parallelism over the mesh's ``model`` axis.

Counterpart of the reference's tensor-parallel rule
(``torch_detection_tpu/parallel/mesh.py::param_sharding_rules``): a leaf of
two or more dims whose output dim (the last of the reference's layouts)
``model`` divides, and which is at least ``2 * model``, is held 1/``model``
a rank; everything else is replicated. GSPMD then partitions each such
layer by its output channels. Here the plan is applied by hand:

* each sharded weight becomes a ``DTensor`` on the mesh's ``model`` dim,
  ``Shard(0)`` (``Conv2d`` and ``Linear``, whose weights are (out, in, ...))
  or ``Shard(1)`` (``ConvTranspose2d``'s (in, out, kh, kw)), so that
  ``mesh.full_tensor``, the checkpoints, the EMA and the global norm see it
  as they see FSDP's shards, and FSDP over the ``data`` dim composes with
  it;
* each such layer computes its own output channels from its input, which
  every rank of the model group holds whole, and all-gathers them along
  the channels (the column-parallel form); its bias, a vector, stays whole
  and is added after the gather.

After the gather every rank of a model group computes the same thing, so
their gradients are counted once: the gather's backward keeps this rank's
channels of the output's gradient, and the layer's input gradient, a
partial sum over this rank's output channels, is summed over the group.
The replicated parameters' gradients come out equal on every rank of the
group and the sharded ones' are this rank's shard, so the step averages
them over the data ranks alone (``train_step.Optimizer.reduce_gradients``).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import torch
import torch.distributed as dist
from torch import Tensor, nn


def reference_rule(out_size: int, ndim: int, model: int) -> bool:
    """Whether the reference shards a leaf of ``ndim`` dims whose output dim
    has ``out_size`` entries over ``model`` ranks."""
    return model > 1 and ndim >= 2 and out_size % model == 0 and out_size >= 2 * model


def output_dim(module: nn.Module) -> Optional[int]:
    """The dim of ``module.weight`` that holds its output channels, for the
    layers with a column-parallel form; None for any other module."""
    from ..models.layers import HeadsLinear  # here: the models import this package

    if isinstance(module, HeadsLinear):  # the reference's kernel splits its heads' axis
        return None
    if isinstance(module, (nn.Conv2d, nn.Linear)):
        return 0
    if isinstance(module, nn.ConvTranspose2d):
        return 1
    return None


class _GatherOutputs(torch.autograd.Function):
    """Every rank's output channels along ``axis``, in rank order; the
    backward keeps this rank's channels of the gradient. A 4-D map is
    gathered in NHWC and comes out in channels_last memory, as the layer's
    own output on channels_last input (K1 reads the levels as NHWC)."""

    @staticmethod
    def forward(ctx, y: Tensor, axis: int, group) -> Tensor:
        ctx.axis, ctx.index, ctx.size = axis, dist.get_rank(group), y.shape[axis]
        nhwc = y.dim() == 4 and axis == 1
        z = (y.permute(0, 2, 3, 1) if nhwc else y).contiguous()
        parts = [torch.empty_like(z) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, z, group=group)
        if nhwc:
            return torch.cat(parts, dim=3).permute(0, 3, 1, 2)
        return torch.cat(parts, dim=axis)

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad.narrow(ctx.axis, ctx.index * ctx.size, ctx.size), None, None


class _SumInputGrad(torch.autograd.Function):
    """The identity, whose backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _column_parallel_forward(module: nn.Module, x: Tensor, *, group, index: int,
                             parts: int) -> Tensor:
    """``module``'s forward on this rank's output channels, gathered whole,
    then its bias."""
    weight = module.weight.to_local()
    bias = module.bias
    if x.requires_grad:
        x = _SumInputGrad.apply(x, group)
    groups = getattr(module, "groups", 1)
    if groups > 1:  # a grouped conv: this rank's groups read their own input channels
        span = x.shape[1] // parts
        y = nn.functional.conv2d(x.narrow(1, index * span, span), weight, None, module.stride,
                                 module.padding, module.dilation, groups // parts)
    else:  # the module's own forward on the shard, its bias left for after the gather
        params = module._parameters
        saved = dict(params)
        params["weight"] = weight
        if "bias" in params:
            params["bias"] = None
        try:
            y = type(module).forward(module, x)
        finally:
            params.update(saved)
    axis = 1 if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d)) else y.dim() - 1
    y = _GatherOutputs.apply(y, axis, group)
    if bias is not None:
        shape = [1] * y.dim()
        shape[axis] = -1
        y = y + bias.to(y.dtype).view(shape)
    return y


def tensor_parallel_plan(model: nn.Module, parts: int) -> Dict[str, int]:
    """``{parameter name: the dim it is sharded on}`` under the reference's
    rule over ``parts`` model ranks. A parameter of two or more dims that
    is not the weight of a layer with a column-parallel form raises
    ``NotImplementedError`` by name, as does a layer whose weight the rule
    shards but whose form here cannot split (a grouped ``Conv2d`` whose
    groups ``parts`` does not divide, a grouped ``ConvTranspose2d``, a
    ``Conv2d`` subclass with its own forward and a bias)."""
    plan: Dict[str, int] = {}
    for prefix, module in model.named_modules():
        for pname, p in module.named_parameters(recurse=False):
            if p.dim() < 2:
                continue
            name = f"{prefix}.{pname}" if prefix else pname
            dim = output_dim(module) if pname == "weight" else None
            if dim is None:
                raise NotImplementedError(
                    f"tensor parallelism: {name} ({type(module).__name__}) has no "
                    "column-parallel form")
            if not reference_rule(p.shape[dim], p.dim(), parts):
                continue
            groups = getattr(module, "groups", 1)
            custom = (isinstance(module, nn.Conv2d)
                      and type(module).forward is not nn.Conv2d.forward)
            if (groups > 1 and (isinstance(module, nn.ConvTranspose2d) or groups % parts
                                or custom)) or (custom and module.bias is not None):
                raise NotImplementedError(
                    f"tensor parallelism: {name} ({type(module).__name__}, groups {groups}) "
                    f"cannot split its output channels over {parts} ranks")
            plan[name] = dim
    return plan


def apply_tensor_parallel(model: nn.Module, mesh) -> List[str]:
    """Shard ``model`` in place over ``mesh``'s ``model`` dim by the
    reference's rule (``tensor_parallel_plan``): each sharded weight a
    ``DTensor`` of this rank's chunk of its own copy (every rank must hold
    the same weights, as after ``broadcast_module``), its layer's forward
    the column-parallel one. Build the optimizer after this call. Returns
    the sharded parameters' names."""
    from torch.distributed.tensor import Shard, distribute_tensor

    sub = mesh["model"]
    parts = sub.size()
    group, index = sub.get_group(), sub.get_local_rank()
    plan = tensor_parallel_plan(model, parts)
    modules = dict(model.named_modules())
    for name, dim in plan.items():
        prefix, _, pname = name.rpartition(".")
        module = modules[prefix]
        p = getattr(module, pname)
        shard = distribute_tensor(p.detach().contiguous(), sub, [Shard(dim)], src_data_rank=None)
        setattr(module, pname, nn.Parameter(shard, requires_grad=p.requires_grad))
        module.forward = functools.partial(_column_parallel_forward, module, group=group,
                                           index=index, parts=parts)
    return list(plan)
