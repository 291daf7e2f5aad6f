"""Image-row partitioning over the mesh's ``model`` axis.

Counterpart of the reference's ``spatial_sharding`` and
``shard_batch(spatial=True)`` (``torch_detection_tpu/parallel/mesh.py``):
there GSPMD bands the NHWC rows of the images over ``model`` and
partitions every convolution, exchanging each one's halo rows. Here
``mesh.shard_batch(mesh, batch, spatial=True)`` gives each rank of a model
group its band of every image's rows (a ``RowBatch``), and within
``bands(batch)`` the first module called on a band (the detector: its
backbone, neck and dense heads) runs on bands:

* every map is owned by rows, ``row_bounds`` of its own height, so bands
  may be uneven at deep levels (25 rows over 2 ranks: 12 and 13) and a
  rank may own none;
* each operation with a spatial extent (``conv2d`` at any kernel, stride
  and dilation, ``max_pool2d``, row padding, nearest upsampling,
  ``models.layers.resize_nearest``, ``group_norm``) computes the rows of
  its output that this rank owns, from the input rows it needs: the band's
  own and, from the other ranks, the rows within the layer's reach of
  their edges (one all-gather of each rank's first and last rows; a small
  level whole);
* ``group_norm`` sums its statistics over the band group;
* element-wise operations, permutes and casts keep the band.

Any other operation on a band inside that module raises
``NotImplementedError`` naming it and the module it ran in: a layer is
never computed on its band alone. When the module returns, every band in
its output is gathered whole along its rows, and what follows (the loss,
the proposals, K1) runs whole on every rank of the group.

Gradients: every rank of a group runs the whole tail at ``1/model`` of
the loss (``train_step``), the final gather's backward sums the ranks'
gradients and keeps this rank's rows, each halo's backward returns the
gradient of the rows it lent to their owner, and every parameter's
gradient is summed over the group. Collectives go through
``torch.distributed`` all-gathers and all-reduces (gloo on the CPU or
between ranks sharing a card, NCCL between GPUs); there is no
point-to-point exchange.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor, nn
from torch.overrides import TorchFunctionMode


def row_bounds(rows: int, parts: int) -> List[Tuple[int, int]]:
    """The rows each of ``parts`` ranks owns of a map of ``rows`` rows,
    ``[j * rows // parts, (j + 1) * rows // parts)``."""
    return [(j * rows // parts, (j + 1) * rows // parts) for j in range(parts)]


@dataclasses.dataclass(frozen=True)
class RowSharding:
    """Image rows over the ``model`` ranks of this rank's group: ``parts``
    ranks, this one ``index``, their process ``group``."""

    parts: int
    index: int
    group: Any


class RowBatch(dict):
    """A batch whose ``rows`` keys hold this rank's band of each image's
    rows (dim 1 of NHWC), ``rows[key]`` the whole height; every other leaf
    is whole. ``sharding`` is the ``RowSharding`` the bands are cut by."""

    def __init__(self, leaves: Dict[str, Any], sharding: RowSharding, rows: Dict[str, int]):
        super().__init__(leaves)
        self.sharding = sharding
        self.rows = rows

    def with_leaves(self, leaves: Dict[str, Any]) -> "RowBatch":
        return RowBatch(leaves, self.sharding, self.rows)


def band_batch(batch: Dict[str, Any], sharding: RowSharding) -> Dict[str, Any]:
    """``batch`` with each 4-D leaf whose rows (dim 1) ``sharding.parts``
    divides cut to this rank's band, as the reference shards such a leaf
    (``mesh.py:97``); the other leaves whole. A batch with no such leaf is
    returned as it is."""
    rows = {k: v.shape[1] for k, v in batch.items()
            if isinstance(v, Tensor) and v.dim() == 4 and v.shape[1] % sharding.parts == 0}
    if sharding.parts == 1 or not rows:
        return batch
    leaves = dict(batch)
    for k, h in rows.items():
        lo, hi = row_bounds(h, sharding.parts)[sharding.index]
        leaves[k] = batch[k].narrow(1, lo, hi - lo)
    return RowBatch(leaves, sharding, rows)


# ------------------------------------------------------------------------------- collectives
def _all_gather(x: Tensor, group, parts: int) -> List[Tensor]:
    out = [torch.empty_like(x) for _ in range(parts)]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


class _GatherRows(torch.autograd.Function):
    """A banded map whole along ``axis`` (each rank's band padded to the
    largest for the all-gather). The backward sums the ranks' gradients of
    the whole map and keeps this rank's rows."""

    @staticmethod
    def forward(ctx, x: Tensor, token: Tensor, axis: int, bounds, index: int, group):
        ctx.axis, ctx.bounds, ctx.index, ctx.group = axis, bounds, index, group
        size = max(hi - lo for lo, hi in bounds)
        pad = list(x.shape)
        pad[axis] = size - x.shape[axis]
        padded = torch.cat([x, x.new_zeros(pad)], dim=axis) if pad[axis] else x
        parts = _all_gather(padded, group, len(bounds))
        return torch.cat([p.narrow(axis, 0, hi - lo) for p, (lo, hi) in zip(parts, bounds)],
                         dim=axis), token.clone()

    @staticmethod
    def backward(ctx, grad: Tensor, _token):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        lo, hi = ctx.bounds[ctx.index]
        return grad.narrow(ctx.axis, lo, hi - lo), None, None, None, None, None


class _Edges(torch.autograd.Function):
    """Every rank's first and last ``reach`` rows of a band (axis 2), each
    padded to ``reach``: (parts, B, C, 2 * reach, W). Row ``i`` of a rank's
    first half is its row ``lo + i``, row ``i`` of its second half its row
    ``hi - reach + i``. The backward sums the ranks' gradients of the
    edges and adds this rank's into its band."""

    @staticmethod
    def forward(ctx, x: Tensor, token: Tensor, reach: int, group, parts: int):
        h = x.shape[2]
        ctx.reach, ctx.group, ctx.h = reach, group, h
        ctx.index = dist.get_rank(group)
        take = min(reach, h)
        pad = list(x.shape)
        pad[2] = reach - take
        zeros = x.new_zeros(pad)
        mine = torch.cat([x.narrow(2, 0, take), zeros, zeros, x.narrow(2, h - take, take)], dim=2)
        return torch.stack(_all_gather(mine, group, parts)), token.clone()

    @staticmethod
    def backward(ctx, grad: Tensor, _token):
        grad = grad.contiguous()
        dist.all_reduce(grad, group=ctx.group)
        mine = grad[ctx.index]
        reach, h = ctx.reach, ctx.h
        take = min(reach, h)
        shape = list(mine.shape)
        shape[2] = h
        out = mine.new_zeros(shape)
        out.narrow(2, 0, take).add_(mine.narrow(2, 0, take))
        out.narrow(2, h - take, take).add_(mine.narrow(2, 2 * reach - take, take))
        return out, None, None, None, None


class _SumOverGroup(torch.autograd.Function):
    """The sum over ``group`` of each rank's ``x``; the backward sums the
    gradient over the group too (every rank's sum feeds every rank's loss)."""

    @staticmethod
    def forward(ctx, x: Tensor, token: Tensor, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out, token.clone()

    @staticmethod
    def backward(ctx, grad: Tensor, _token):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None, None


# ------------------------------------------------------------------------------------ bands
@dataclasses.dataclass(frozen=True)
class _Band:
    axis: int  # the rows' dim
    rows: int  # the whole map's


class _BandMode(TorchFunctionMode):
    """Runs every operation on a band by its band rule, or raises."""

    def __init__(self, sharding: RowSharding):
        super().__init__()
        self.sharding = sharding
        self.bands: Dict[int, Tuple[weakref.ref, _Band]] = {}
        self.modules: List[str] = []  # the modules being run, outermost first
        self.root: Optional[nn.Module] = None
        self.root_done = False
        self.names: Dict[int, str] = {}
        self.passthrough = 0  # gathering the output
        self.token: Optional[Tensor] = None  # the last collective's (``chained``)

    # the registry of bands
    def band(self, t: Any) -> Optional[_Band]:
        if not isinstance(t, Tensor):
            return None
        entry = self.bands.get(id(t))
        return entry[1] if entry is not None and entry[0]() is t else None

    def mark(self, t: Tensor, band: _Band) -> Tensor:
        self.bands[id(t)] = (weakref.ref(t), band)
        return t

    def chained(self, function, x: Tensor, *args) -> Tensor:
        """``function.apply(x, token, *args)``: a collective whose backward
        waits for the backward of every collective created after it. The
        ranks' graphs differ (a rank with no rows of a map takes other
        paths), so the autograd engine could order two collectives'
        backwards otherwise on each; the chain of tokens fixes the order."""
        if self.token is None:
            self.token = torch.zeros((), device=x.device, requires_grad=torch.is_grad_enabled()
                                     and not torch.is_inference_mode_enabled())
        out, self.token = function.apply(x, self.token, *args)
        return out

    def bounds(self, rows: int) -> List[Tuple[int, int]]:
        return row_bounds(rows, self.sharding.parts)

    def where(self) -> str:
        return self.modules[-1] if self.modules else "<no module>"

    def refuse(self, what: str) -> NotImplementedError:
        return NotImplementedError(
            f"spatial=True: {self.where()} runs {what} on a row band, which has no band rule")

    # rows from the other ranks
    def fetch(self, x: Tensor, rows: int, need: Callable[[int], Tuple[int, int]],
              fill: float) -> Tensor:
        """Rows ``need(index)`` (``[lo, hi)``, which may reach past the map's
        edges) of the banded NCHW map ``x`` of ``rows`` rows, those outside
        the map filled with ``fill``. Every rank of the group must call it
        with the same ``need``."""
        bounds = self.bounds(rows)

        def inside(j):  # the rows of the map among rank j's, and the fill above and below
            lo, hi = need(j)
            above = min(max(-lo, 0), hi - lo)
            below = min(max(hi - rows, 0), hi - lo - above)
            return lo + above, hi - below, above, below

        reach = 0
        for j, (own_lo, own_hi) in enumerate(bounds):
            a, b, _, _ = inside(j)
            if b > a:
                reach = max(reach, own_lo - a, b - own_hi)
        me = self.sharding.index
        a, b, above, below = inside(me)
        edges = self.chained(_Edges, x, reach, self.sharding.group, self.sharding.parts) \
            if reach else None
        pieces = []
        r = a
        while r < b:
            owner = next(j for j, (lo, hi) in enumerate(bounds) if lo <= r < hi)
            lo, hi = bounds[owner]
            end = min(hi, b)
            if owner == me:
                pieces.append(x.narrow(2, r - lo, end - r))
            elif owner < me:  # the rows sit in the owner's last ``reach``
                pieces.append(edges[owner].narrow(2, reach + r - (hi - reach), end - r))
            else:  # in its first ``reach``
                pieces.append(edges[owner].narrow(2, r - lo, end - r))
            r = end
        if not pieces:
            pieces.append(x.narrow(2, 0, 0))
        out = torch.cat(pieces, dim=2) if len(pieces) > 1 else pieces[0]
        if above or below:
            out = F.pad(out, (0, 0, above, below), value=fill)
        return out

    # rules
    def windowed(self, x: Tensor, band: _Band, kernel: int, stride: int, padding: int,
                 dilation: int, fill: float, op: Callable[[Tensor], Tensor]) -> Tensor:
        """A window along the rows: this rank's output rows of the map from
        the input rows they read, the rows outside the map ``fill``."""
        if band.axis != 2 or x.dim() != 4:
            raise self.refuse("a windowed operation off the rows of NCHW")
        span = dilation * (kernel - 1) + 1
        out_rows = (band.rows + 2 * padding - span) // stride + 1
        out_bounds = self.bounds(out_rows)

        def need(j):
            lo, hi = out_bounds[j]
            if hi == lo:
                return 0, 0
            return lo * stride - padding, (hi - 1) * stride - padding + span

        slab = self.fetch(x, band.rows, need, fill)
        lo, hi = out_bounds[self.sharding.index]
        if hi == lo:  # no rows here: the output's shape from one window of fill
            y = op(F.pad(slab, (0, 0, 0, span), value=fill)).narrow(2, 0, 0)
        else:
            y = op(slab)
        return self.mark(y, _Band(2, out_rows))

    def conv2d(self, x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
        band = self.band(x)
        kh = weight.shape[2]
        sh, sw = _pair(stride)
        dh, dw = _pair(dilation)
        if isinstance(padding, str):
            if padding == "valid":
                ph = pw = 0
            elif sh == 1 and sw == 1 and (dh * (kh - 1)) % 2 == 0:
                ph, pw = dh * (kh - 1) // 2, dw * (weight.shape[3] - 1) // 2
            else:
                raise self.refuse(f"conv2d with padding {padding!r}")
        else:
            ph, pw = _pair(padding)
        return self.windowed(x, band, kh, sh, ph, dh, 0.0,
                             lambda s: F.conv2d(s, weight, bias, (sh, sw), (0, pw), (dh, dw),
                                                groups))

    def max_pool2d(self, x, kernel_size, stride=None, padding=0, dilation=1, ceil_mode=False,
                   return_indices=False):
        if ceil_mode or return_indices:
            raise self.refuse("max_pool2d with ceil_mode or indices")
        kh, kw = _pair(kernel_size)
        sh, sw = _pair(stride if stride not in (None, []) else kernel_size)
        ph, pw = _pair(padding)
        dh, dw = _pair(dilation)
        return self.windowed(x, self.band(x), kh, sh, ph, dh, -math.inf,
                             lambda s: F.max_pool2d(s, (kh, kw), (sh, sw), (0, pw), (dh, dw)))

    def pad(self, x, pad, mode="constant", value=None):
        band = self.band(x)
        pad = list(pad)
        k = 2 * (x.dim() - 1 - band.axis)  # the rows' pair in ``pad``
        if k + 1 >= len(pad) or pad[k] == pad[k + 1] == 0:  # the rows are not padded
            return self.mark(F.pad(x, pad, mode, value), band)
        if mode != "constant" or band.axis != 2 or x.dim() != 4:
            raise self.refuse(f"pad (mode {mode!r}) of the rows")
        top, bottom = pad[k], pad[k + 1]
        rest = pad[:k] + [0, 0] + pad[k + 2:]
        fill = 0.0 if value is None else value
        out_rows = band.rows + top + bottom
        out_bounds = self.bounds(out_rows)
        slab = self.fetch(x, band.rows, lambda j: (out_bounds[j][0] - top,
                                                    out_bounds[j][1] - top), fill)
        y = F.pad(slab, rest, value=fill) if any(rest) else slab
        return self.mark(y, _Band(2, out_rows))

    def upsample(self, x, size=None, scale_factor=None, mode="nearest", align_corners=None,
                 recompute_scale_factor=None, antialias=False):
        band = self.band(x)
        factor = _pair(scale_factor)[0] if scale_factor is not None else None
        if (mode != "nearest" or size is not None or factor is None or factor != int(factor)
                or band.axis != 2 or x.dim() != 4):
            raise self.refuse(f"interpolate (mode {mode!r}, size {size}, scale {scale_factor})")
        f = int(factor)
        out_rows = band.rows * f
        out_bounds = self.bounds(out_rows)

        def need(j):
            lo, hi = out_bounds[j]
            return (lo // f, (hi - 1) // f + 1) if hi > lo else (0, 0)

        slab = self.fetch(x, band.rows, need, 0.0)
        lo, hi = out_bounds[self.sharding.index]
        y = F.interpolate(slab, scale_factor=scale_factor, mode="nearest")
        y = y.narrow(2, lo - (lo // f) * f if hi > lo else 0, hi - lo)
        return self.mark(y, _Band(2, out_rows))

    def resize_nearest(self, x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
        """``models.layers.resize_nearest`` to the shape of a banded map, as
        read inside the module: ``out_hw[0]`` is this rank's band of the
        target's rows, so the whole target is the group's bands together.
        Source row ``floor(i * rows / out_rows)``."""
        band = self.band(x)
        if band.axis != 2 or x.dim() != 4:
            raise self.refuse("resize_nearest off the rows of NCHW")
        mine = torch.tensor([int(out_hw[0])], dtype=torch.long, device=x.device)
        out_rows = sum(int(t) for t in _all_gather(mine, self.sharding.group,
                                                   self.sharding.parts))
        out_bounds = self.bounds(out_rows)
        lo, hi = out_bounds[self.sharding.index]
        if hi - lo != int(out_hw[0]):
            raise self.refuse(f"resize_nearest to {tuple(out_hw)}, which is not a band of a map")
        src = lambda i: i * band.rows // out_rows  # noqa: E731

        def need(j):
            lo, hi = out_bounds[j]
            return (src(lo), src(hi - 1) + 1) if hi > lo else (0, 0)

        slab = self.fetch(x, band.rows, need, 0.0)
        rows = torch.tensor([src(i) - src(lo) for i in range(lo, hi)], dtype=torch.long,
                            device=x.device)
        w = x.shape[3]
        cols = torch.arange(int(out_hw[1]), device=x.device) * w // int(out_hw[1])
        y = slab.index_select(2, rows).index_select(3, cols)
        return self.mark(y.contiguous(memory_format=torch.channels_last), _Band(2, out_rows))

    def group_norm(self, x, num_groups, weight=None, bias=None, eps=1e-5, cudnn_enabled=True):
        band = self.band(x)
        if band.axis != 2 or x.dim() != 4:
            raise self.refuse("group_norm off the rows of NCHW")
        b, c, h, w = x.shape
        g = x.float().reshape(b, num_groups, -1)
        count = (c // num_groups) * band.rows * w
        group = self.sharding.group
        mean = self.chained(_SumOverGroup, g.sum(-1), group) / count
        centred = g - mean[..., None]
        var = self.chained(_SumOverGroup, (centred * centred).sum(-1), group) / count
        y = (centred * torch.rsqrt(var + eps)[..., None]).reshape(b, c, h, w)
        if weight is not None:
            y = y * weight.float()[None, :, None, None]
        if bias is not None:
            y = y + bias.float()[None, :, None, None]
        return self.mark(y.to(x.dtype), band)

    def permute(self, x, *dims):
        dims = tuple(dims[0]) if len(dims) == 1 and not isinstance(dims[0], int) else dims
        band = self.band(x)
        dims = tuple(d % x.dim() for d in dims)
        return self.mark(x.permute(*dims), _Band(dims.index(band.axis), band.rows))

    def elementwise(self, func, args, kwargs):
        """``func`` on bands of one map and on tensors that broadcast along
        the rows (a size of 1 there, or fewer dims)."""
        band = None
        flat = list(args) + list(kwargs.values())
        for a in flat:
            if isinstance(a, (list, tuple)):
                flat += list(a)
        for a in flat:
            b = self.band(a)
            if b is not None:
                if band is not None and (b != band):
                    raise self.refuse(f"{_name(func)} on bands of two maps")
                band = b
        ref = next(a for a in flat if self.band(a) is not None)
        for a in flat:
            if isinstance(a, Tensor) and self.band(a) is None and a.dim() > 0:
                at = a.dim() - (ref.dim() - band.axis)
                if at >= 0 and a.shape[at] != 1:
                    raise self.refuse(f"{_name(func)} with a whole tensor along the rows")
        out = func(*args, **kwargs)
        for t in (out if isinstance(out, (list, tuple)) else (out,)):
            if isinstance(t, Tensor) and t.dim() == ref.dim():
                self.mark(t, band)
        return out

    def split(self, func, args, kwargs):
        x = args[0]
        band = self.band(x)
        dim = kwargs.get("dim", args[2] if len(args) > 2 else 0)
        if dim % x.dim() == band.axis:
            raise self.refuse(f"{_name(func)} along the rows")
        out = func(*args, **kwargs)
        for t in out:
            self.mark(t, band)
        return out

    def cat(self, func, args, kwargs):
        tensors = args[0]
        dim = kwargs.get("dim", args[1] if len(args) > 1 else 0)
        bands = [self.band(t) for t in tensors]
        if any(b is None for b in bands) or len(set(bands)) != 1 or dim % tensors[0].dim() == \
                bands[0].axis:
            raise self.refuse(f"{_name(func)} of bands and whole tensors, or along the rows")
        return self.mark(func(*args, **kwargs), bands[0])

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = [t for a in list(args) + list(kwargs.values())
                  for t in (a if isinstance(a, (list, tuple)) else (a,))]
        if self.passthrough or not any(self.band(t) is not None for t in leaves):
            return func(*args, **kwargs)
        if self.root_done:
            raise self.refuse(f"{_name(func)} after its module returned")
        rule = _RULES.get(func)
        if rule is not None:
            return rule(self, *args, **kwargs)
        if func in _KEEP or getattr(func, "__name__", None) == "__get__":
            out = func(*args, **kwargs)
            if isinstance(out, Tensor):
                self.mark(out, self.band(args[0]))
            return out
        if func in _ELEMENTWISE:
            return self.elementwise(func, args, kwargs)
        if func in _SPLITS:
            return self.split(func, args, kwargs)
        if func in _CATS:
            return self.cat(func, args, kwargs)
        raise self.refuse(_name(func))

    # the module the bands run in
    def pre_hook(self, module: nn.Module, inputs) -> None:
        if self.root is None:
            if not any(self.band(a) is not None for a in inputs):
                return
            self.root = module
            self.names = {id(m): n for n, m in module.named_modules()}
        if self.root_done:
            return
        name = self.names.get(id(module), type(module).__name__)
        self.modules.append(f"{name or 'the model'} ({type(module).__name__})")

    def post_hook(self, module: nn.Module, inputs, output):
        if self.root is None or self.root_done:
            return None
        self.modules.pop()
        if module is not self.root:
            return None
        self.passthrough += 1
        try:
            output = _map_leaves(output, self.whole)
        finally:
            self.passthrough -= 1
        self.root_done = True
        return output

    def whole(self, t: Any) -> Any:
        band = self.band(t)
        if band is None:
            return t
        return self.chained(_GatherRows, t, band.axis, self.bounds(band.rows),
                            self.sharding.index, self.sharding.group)


def _pair(v) -> Tuple:
    if isinstance(v, (list, tuple)):
        return (v[0], v[1]) if len(v) > 1 else (v[0], v[0])
    return (v, v)


def _name(func) -> str:
    return getattr(func, "__qualname__", None) or getattr(func, "__name__", None) or str(func)


def _map_leaves(x, fn):
    if isinstance(x, tuple) and hasattr(x, "_fields"):  # a NamedTuple
        return type(x)(*(_map_leaves(v, fn) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_map_leaves(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map_leaves(v, fn) for k, v in x.items()}
    return fn(x)


_T = torch.Tensor
_RULES: Dict[Any, Callable] = {
    torch.conv2d: _BandMode.conv2d, F.conv2d: _BandMode.conv2d,
    F.max_pool2d: _BandMode.max_pool2d, torch.max_pool2d: _BandMode.max_pool2d,
    F.pad: _BandMode.pad, F.interpolate: _BandMode.upsample,
    torch.group_norm: _BandMode.group_norm, F.group_norm: _BandMode.group_norm,
    _T.permute: _BandMode.permute, torch.permute: _BandMode.permute,
}
# the same band out as in
_KEEP = {_T.contiguous, _T.to, _T.float, _T.half, _T.bfloat16, _T.type_as, _T.clone, _T.detach,
         _T.requires_grad_, _T.dim, _T.size, _T.numel, _T.__len__, _T.is_contiguous,
         _T.data_ptr, _T.element_size, _T.__hash__, torch.clone}
_ELEMENTWISE = {
    F.relu, torch.relu, _T.relu, torch.relu_, _T.relu_, F.relu6, F.hardtanh, F.silu, F.gelu,
    F.leaky_relu, torch.sigmoid, _T.sigmoid, torch.tanh, _T.tanh, F.hardswish, F.hardsigmoid,
    torch.add, _T.add, _T.add_, _T.__add__, _T.__radd__, _T.__iadd__, torch.sub, _T.sub,
    _T.__sub__, _T.__rsub__, torch.mul, _T.mul, _T.mul_, _T.__mul__, _T.__rmul__, torch.div,
    _T.div, _T.__truediv__, torch.addcmul, _T.addcmul, torch.where, torch.clamp, _T.clamp,
    torch.neg, _T.neg, _T.__neg__, torch.exp, _T.exp, torch.abs, _T.abs, torch.maximum,
    torch.minimum, F.dropout,
}
_SPLITS = {torch.chunk, _T.chunk, torch.split, _T.split}
_CATS = {torch.cat, torch.concat}


# ------------------------------------------------------------------------------ the context
_ACTIVE = False


@contextlib.contextmanager
def bands(batch: RowBatch) -> Iterator[None]:
    """Within: ``batch``'s banded leaves are bands, and the first module
    called on one runs on bands, its output gathered whole (module
    docstring). Every rank of the group must enter with its own band of
    the same batch."""
    global _ACTIVE
    if _ACTIVE:
        raise RuntimeError("bands() does not nest")
    from ..models.layers import resize_nearest  # here: the models import this package

    _RULES[resize_nearest] = _BandMode.resize_nearest  # the layer's own torch function
    mode = _BandMode(batch.sharding)
    for key, rows in batch.rows.items():
        mode.mark(batch[key], _Band(1, rows))
    pre = nn.modules.module.register_module_forward_pre_hook(mode.pre_hook)
    post = nn.modules.module.register_module_forward_hook(mode.post_hook)
    _ACTIVE = True
    try:
        with mode:
            yield
    finally:
        _ACTIVE = False
        pre.remove()
        post.remove()


def check_no_tensor_parallel(params) -> None:
    """Row partitioning and tensor parallelism share the ``model`` axis, a
    combination neither the reference's entry points nor its tests reach:
    raise by name where one of ``params`` is a tensor-parallel shard."""
    from .mesh import is_sharded

    for p in params:
        if is_sharded(p) and "model" in (p.device_mesh.mesh_dim_names or ()):
            raise NotImplementedError(
                "spatial=True with tensor parallelism on the same model axis (a parameter of "
                f"shape {tuple(p.shape)} is sharded over it): not ported")


__all__ = ["RowBatch", "RowSharding", "band_batch", "bands",
           "check_no_tensor_parallel", "row_bounds"]
