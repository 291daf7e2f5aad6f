"""FPN RoIAlign (NHWC) and level routing, with its CUDA kernels.

Counterpart of ``torch_detection_tpu/ops/roi_align.py`` and of the custom
VJP of ``roi_align_pallas.py``. The pieces:

* ``map_rois_to_levels``: the mmdet level router;
* ``multilevel_roi_align``: the plain PyTorch forward, the gather
  formulation of the JAX oracle with the same expressions; it runs on CPU
  tensors and is the reference the forward kernel is held against;
* ``multilevel_roi_align_cuda``: the wrapper of the hand-written forward
  kernel ``csrc/roi_align_fwd.cu`` (K1), for CUDA tensors;
* ``multilevel_roi_align_backward``: the plain PyTorch backward, the
  explicit scatter-add of the forward's bilinear weights;
* ``multilevel_roi_align_backward_cuda``: the wrapper of the hand-written
  backward kernel ``csrc/roi_align_bwd.cu`` (K2), for CUDA tensors;
* ``RoIAlignFunction``: the ``torch.autograd.Function`` that pairs them.

``batched_multilevel_roi_align`` goes through ``RoIAlignFunction``, which
dispatches on the device of its tensors: CPU tensors go to the plain
versions, CUDA tensors to the kernels, which launch or raise. The rois get
no gradient, as the reference gives them zero.

Sampling (as the reference): bins of ``roi_size / out`` with sub-bin centres
at ``(i + 0.5) / ratio``, bilinear with a border clamp, no -0.5 shift, and
each ``ratio x ratio`` group averaged. This is not torchvision's
``aligned`` variant.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
from torch import Tensor

from .. import kernels


def map_rois_to_levels(
    rois: Tensor,  # (..., 4)
    num_levels: int,
    finest_scale: float = 56.0,
    offset: float = 1.0,
) -> Tensor:
    """level = floor(log2(sqrt(wh) / finest_scale + 1e-6)), clamped to
    [0, num_levels - 1]. Returns (...,) int32. A non-finite roi (as a NaN
    image gives) goes to level 0, so the kernels index no level outside the
    table."""
    w = rois[..., 2] - rois[..., 0] + offset
    h = rois[..., 3] - rois[..., 1] + offset
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(torch.log2(scale / _divisor(finest_scale, scale) + 1e-6))
    return torch.clamp(torch.nan_to_num(lvl, nan=0.0), 0, num_levels - 1).to(torch.int32)


def _divisor(value: float, like: Tensor) -> Tensor:
    """``value`` as a 0-d float32 tensor on ``like``'s device, so that a
    division by it is correctly rounded on every device (see
    ``axis_samples``)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def axis_samples(
    lo: Tensor,  # (N,) roi start in image coordinates
    hi: Tensor,  # (N,) roi end
    scale: float,  # 1 / stride
    size: int,  # level extent along this axis
    out_size: int,
    sampling_ratio: int,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Sample positions along one axis: (lower index, upper index, weight of
    the upper cell), each (N, out_size * sampling_ratio).

    The weight comes from the unclamped floor; the indices are clamped to
    [0, size - 1], the upper one as the clamped lower index + 1. The
    divisors are tensors on the rois' device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal, one rounding off the
    correctly rounded quotient that the CPU and the kernel compute, and at
    a few hundred cells one ulp of a coordinate moves a sample by 3e-5."""
    lo = lo * scale
    extent = torch.clamp(hi * scale - lo, min=1.0)
    n = out_size * sampling_ratio
    grid = (torch.arange(n, dtype=torch.float32, device=lo.device) + 0.5) / _divisor(
        sampling_ratio, lo
    )
    coords = lo[:, None] + (extent / _divisor(out_size, lo))[:, None] * grid[None, :]
    c0 = torch.floor(coords)
    i0 = torch.clamp(c0.to(torch.int64), 0, size - 1)
    i1 = torch.clamp(i0 + 1, 0, size - 1)
    return i0, i1, coords - c0


def _check_inputs(feats: Sequence[Tensor], rois: Tensor, levels: Tensor,
                  strides: Sequence[int]) -> None:
    if len(feats) != len(strides) or not feats:
        raise ValueError(f"{len(feats)} levels but {len(strides)} strides")
    b, c = feats[0].shape[0], feats[0].shape[-1]
    for f in feats:
        if f.dim() != 4 or f.shape[0] != b or f.shape[-1] != c:
            raise ValueError(f"level maps must be (B, H, W, C) with one B and C, got {tuple(f.shape)}")
        if f.dtype != feats[0].dtype or f.device != feats[0].device:
            raise ValueError("level maps must share one dtype and device")
    if rois.dim() != 3 or rois.shape[0] != b or rois.shape[-1] != 4:
        raise ValueError(f"rois must be (B, R, 4) with B={b}, got {tuple(rois.shape)}")
    if levels.shape != rois.shape[:2]:
        raise ValueError(f"levels {tuple(levels.shape)} do not match rois {tuple(rois.shape)}")


def multilevel_roi_align(
    feats: Sequence[Tensor],  # per level (B, H_l, W_l, C)
    rois: Tensor,  # (B, R, 4) image coordinates, float32
    levels: Tensor,  # (B, R) routed levels (``map_rois_to_levels``)
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> Tensor:
    """Plain PyTorch RoIAlign: (B, R, out, out, C) in the feature dtype.

    Each roi is sampled on its routed level only. The JAX oracle aligns on
    every level and blends with a one-hot weight; with finite features the
    unused levels add exact zeros, so the two are equal."""
    _check_inputs(feats, rois, levels, strides)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    s = sampling_ratio
    out = torch.zeros((b, r, out_size, out_size, c), dtype=torch.float32, device=rois.device)
    for lvl, (feat, stride) in enumerate(zip(feats, strides)):
        bi, ri = torch.nonzero(levels == lvl, as_tuple=True)
        if bi.numel() == 0:
            continue
        box = rois[bi, ri]  # (N, 4)
        h, w = feat.shape[1:3]
        y0, y1, wy = axis_samples(box[:, 1], box[:, 3], 1.0 / stride, h, out_size, s)
        x0, x1, wx = axis_samples(box[:, 0], box[:, 2], 1.0 / stride, w, out_size, s)
        # (N, S, S, C): rows over y, columns over x
        bb = bi[:, None, None]
        f00 = feat[bb, y0[:, :, None], x0[:, None, :]]
        f01 = feat[bb, y0[:, :, None], x1[:, None, :]]
        f10 = feat[bb, y1[:, :, None], x0[:, None, :]]
        f11 = feat[bb, y1[:, :, None], x1[:, None, :]]
        wy = wy[:, :, None, None]
        wx = wx[:, None, :, None]
        samples = (
            f00 * (1 - wy) * (1 - wx)
            + f01 * (1 - wy) * wx
            + f10 * wy * (1 - wx)
            + f11 * wy * wx
        )
        n = samples.shape[0]
        out[bi, ri] = samples.reshape(n, out_size, s, out_size, s, c).mean(dim=(2, 4))
    return out.to(feats[0].dtype)


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def multilevel_roi_align_cuda(
    feats: Sequence[Tensor],  # per level (B, H_l, W_l, C), contiguous, on one GPU
    rois: Tensor,  # (B, R, 4) float32
    levels: Tensor,  # (B, R) routed levels (``map_rois_to_levels``)
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> Tensor:
    """The RoIAlign kernel ``csrc/roi_align_fwd.cu``: (B, R, out, out, C) in
    the feature dtype (float32 or bfloat16), one launch for the batch and
    every level. ``multilevel_roi_align_cuda.launches`` counts launches."""
    _check_inputs(feats, rois, levels, strides)
    _check_cuda("multilevel_roi_align_cuda", feats[0], rois, len(feats), out_size, sampling_ratio)
    if not all(f.is_contiguous() for f in feats):
        raise ValueError("level maps must be contiguous NHWC tensors")
    dtype, device = feats[0].dtype, feats[0].device
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    out = torch.empty((b, r, out_size, out_size, c), dtype=dtype, device=device)
    if b * r == 0:
        return out
    rois = rois.contiguous()
    levels = levels.to(torch.int32).contiguous()
    pairs = c % 2 == 0 and all(f.data_ptr() % (2 * f.element_size()) == 0 for f in feats)
    geometry = _level_geometry(feats, [f.shape[1:3] for f in feats], strides)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = _kernel("roi_align_fwd")(
            _DTYPE_CODES[dtype], len(feats), *geometry,
            rois.data_ptr(), levels.data_ptr(), b, r, c, out_size, sampling_ratio,
            int(pairs), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"roi_align_fwd failed to launch: CUDA error {rc}")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def _check_cuda(name: str, x: Tensor, rois: Tensor, num_levels: int, out_size: int,
                sampling_ratio: int) -> None:
    """What both kernels refuse: another device, dtype, level count or size."""
    if x.device.type != "cuda" or rois.device != x.device:
        raise ValueError(f"{name} takes CUDA tensors on one device")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"feature dtype {x.dtype} is not float32 or bfloat16")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if num_levels > 8:
        raise ValueError("the kernels take at most 8 levels")
    if out_size < 1 or sampling_ratio < 1:
        raise ValueError("out_size and sampling_ratio must be positive")


def _level_geometry(maps: Sequence[Tensor], shapes, strides: Sequence[int]):
    """The per-level host arrays of the kernels' C interface: device
    pointers, heights, widths and 1 / stride."""
    num = len(maps)
    return (
        (ctypes.c_void_p * num)(*[m.data_ptr() for m in maps]),
        (ctypes.c_int * num)(*[int(hw[0]) for hw in shapes]),
        (ctypes.c_int * num)(*[int(hw[1]) for hw in shapes]),
        (ctypes.c_float * num)(*[1.0 / s for s in strides]),
    )


def _kernel(name: str):
    """``roi_align_fwd`` or ``roi_align_bwd`` from its library; the two
    share one C signature."""
    fn = getattr(kernels.load(name), name)
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def multilevel_roi_align_backward(
    grad: Tensor,  # (B, R, out, out, C) cotangent of the forward's output
    rois: Tensor,  # (B, R, 4) float32
    levels: Tensor,  # (B, R) routed levels, as the forward used them
    level_shapes: Sequence[Tuple[int, int]],  # per level (H_l, W_l)
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> List[Tensor]:
    """Plain PyTorch backward of RoIAlign: per level (B, H_l, W_l, C) in
    ``grad``'s dtype.

    The explicit scatter-add of the forward's weights: every sample's four
    bilinear corners receive ``grad[bin] / ratio**2`` times their weight
    (``index_put_(..., accumulate=True)`` in float32), then one cast."""
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    s = sampling_ratio
    g = grad.float() / _divisor(s * s, grad)
    outs = []
    for lvl, ((h, w), stride) in enumerate(zip(level_shapes, strides)):
        acc = torch.zeros((b, h, w, c), dtype=torch.float32, device=grad.device)
        bi, ri = torch.nonzero(levels == lvl, as_tuple=True)
        if bi.numel():
            box = rois[bi, ri]
            y0, y1, wy = axis_samples(box[:, 1], box[:, 3], 1.0 / stride, h, out_size, s)
            x0, x1, wx = axis_samples(box[:, 0], box[:, 2], 1.0 / stride, w, out_size, s)
            # each sample's share of its bin's cotangent: (N, S, S, C)
            gs = g[bi, ri].repeat_interleave(s, dim=1).repeat_interleave(s, dim=2)
            n, samples = gs.shape[:2]
            bb = bi[:, None, None].expand(n, samples, samples)
            wy, wx = wy[:, :, None, None], wx[:, None, :, None]
            for ys, ky in ((y0, 1 - wy), (y1, wy)):
                for xs, kx in ((x0, 1 - wx), (x1, wx)):
                    index = (bb, ys[:, :, None].expand(n, samples, samples),
                             xs[:, None, :].expand(n, samples, samples))
                    acc.index_put_(index, gs * ky * kx, accumulate=True)
        outs.append(acc.to(grad.dtype))
    return outs


def multilevel_roi_align_backward_cuda(
    grad: Tensor,  # (B, R, out, out, C) float32 or bfloat16, on one GPU
    rois: Tensor,  # (B, R, 4) float32
    levels: Tensor,  # (B, R) routed levels, as the forward used them
    level_shapes: Sequence[Tuple[int, int]],  # per level (H_l, W_l)
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
) -> List[Tensor]:
    """The RoIAlign backward kernel ``csrc/roi_align_bwd.cu``: per level
    (B, H_l, W_l, C) in ``grad``'s dtype, one launch for the batch and every
    level. The kernel adds into one zero-filled float32 buffer that holds
    every level; for bfloat16 one cast follows, and the levels are views of
    the cast buffer. ``multilevel_roi_align_backward_cuda.launches`` counts
    launches."""
    num = len(level_shapes)
    if len(strides) != num or not num:
        raise ValueError(f"{num} levels but {len(strides)} strides")
    _check_cuda("multilevel_roi_align_backward_cuda", grad, rois, num, out_size, sampling_ratio)
    b, r = rois.shape[:2]
    c = grad.shape[-1]
    if grad.shape != (b, r, out_size, out_size, c) or levels.shape != (b, r):
        raise ValueError(f"grad {tuple(grad.shape)} and levels {tuple(levels.shape)} do not "
                         f"match rois {tuple(rois.shape)} at out_size {out_size}")
    sizes = [b * int(h) * int(w) * c for h, w in level_shapes]
    flat = torch.zeros(sum(sizes), dtype=torch.float32, device=grad.device)
    accums = list(torch.split(flat, sizes))
    if b * r:
        grad, rois = grad.contiguous(), rois.contiguous()
        levels = levels.to(torch.int32).contiguous()
        pairs = c % 2 == 0 and grad.data_ptr() % (2 * grad.element_size()) == 0
        geometry = _level_geometry(accums, level_shapes, strides)
        with torch.cuda.device(grad.device):
            stream = torch.cuda.current_stream(grad.device).cuda_stream
            rc = _kernel("roi_align_bwd")(
                _DTYPE_CODES[grad.dtype], num, *geometry,
                rois.data_ptr(), levels.data_ptr(), b, r, c, out_size, sampling_ratio,
                int(pairs), grad.data_ptr(), stream,
            )
        if rc != 0:
            raise RuntimeError(f"roi_align_bwd failed to launch: CUDA error {rc}")
        multilevel_roi_align_backward_cuda.launches += 1
    out = flat.to(grad.dtype)
    return [part.view(b, int(h), int(w), c)
            for part, (h, w) in zip(torch.split(out, sizes), level_shapes)]


multilevel_roi_align_backward_cuda.launches = 0


class RoIAlignFunction(torch.autograd.Function):
    """RoIAlign whose backward is the scatter-add: the kernels K1 and K2
    for CUDA tensors, the two plain versions for CPU tensors. The routed
    levels are computed once in the forward and saved, so both passes route
    a boundary roi alike. The rois get no gradient (the reference's VJP
    returns zeros for them)."""

    @staticmethod
    def forward(ctx, rois, strides, out_size, sampling_ratio, finest_scale, *feats):
        device = feats[0].device
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"no RoIAlign for device {device}")
        levels = map_rois_to_levels(rois, len(feats), finest_scale)
        forward = multilevel_roi_align_cuda if device.type == "cuda" else multilevel_roi_align
        out = forward(feats, rois, levels, strides, out_size, sampling_ratio)
        ctx.save_for_backward(rois, levels)
        ctx.geometry = ([tuple(f.shape[1:3]) for f in feats], tuple(strides), out_size,
                        sampling_ratio)
        return out

    @staticmethod
    def backward(ctx, grad):
        rois, levels = ctx.saved_tensors
        backward = (multilevel_roi_align_backward_cuda if grad.device.type == "cuda"
                    else multilevel_roi_align_backward)
        grads = backward(grad.contiguous(), rois, levels, *ctx.geometry)
        return (None, None, None, None, None, *grads)


def batched_multilevel_roi_align(
    feats: Sequence[Tensor],  # per level (B, H_l, W_l, C)
    rois: Tensor,  # (B, R, 4)
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
) -> Tensor:
    """(B, R, out, out, C) aligned features through ``RoIAlignFunction``:
    the plain versions for CPU tensors, the CUDA kernels for CUDA tensors."""
    return RoIAlignFunction.apply(rois, tuple(strides), out_size, sampling_ratio, finest_scale,
                                  *feats)
