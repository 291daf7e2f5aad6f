"""FPN RoIAlign (NHWC) and level routing, with its CUDA kernel.

Counterpart of ``torch_detection_tpu/ops/roi_align.py``. Three pieces:

* ``map_rois_to_levels``: the mmdet level router;
* ``multilevel_roi_align``: the plain PyTorch version, the gather
  formulation of the JAX oracle with the same expressions; it runs on CPU
  tensors and is the reference the kernel is held against;
* ``multilevel_roi_align_cuda``: the wrapper of the hand-written kernel
  ``csrc/roi_align_fwd.cu``, for CUDA tensors.

``batched_multilevel_roi_align`` dispatches on the device of its tensors: a
CPU tensor goes to the plain version, a CUDA tensor to the kernel, which
launches or raises.

Sampling (as the reference): bins of ``roi_size / out`` with sub-bin centres
at ``(i + 0.5) / ratio``, bilinear with a border clamp, no -0.5 shift, and
each ``ratio x ratio`` group averaged. This is not torchvision's
``aligned`` variant.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

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
    [0, num_levels - 1]. Returns (...,) int32."""
    w = rois[..., 2] - rois[..., 0] + offset
    h = rois[..., 3] - rois[..., 1] + offset
    scale = torch.sqrt(torch.clamp(w * h, min=1e-6))
    lvl = torch.floor(torch.log2(scale / _divisor(finest_scale, scale) + 1e-6))
    return torch.clamp(lvl, 0, num_levels - 1).to(torch.int32)


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


def _check_inputs(feats: Sequence[Tensor], rois: Tensor, strides: Sequence[int]) -> None:
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


def multilevel_roi_align(
    feats: Sequence[Tensor],  # per level (B, H_l, W_l, C)
    rois: Tensor,  # (B, R, 4) image coordinates, float32
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
) -> Tensor:
    """Plain PyTorch RoIAlign: (B, R, out, out, C) in the feature dtype.

    Each roi is sampled on its routed level only. The JAX oracle aligns on
    every level and blends with a one-hot weight; with finite features the
    unused levels add exact zeros, so the two are equal."""
    _check_inputs(feats, rois, strides)
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    s = sampling_ratio
    levels = map_rois_to_levels(rois, len(feats), finest_scale)
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
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
) -> Tensor:
    """The RoIAlign kernel ``csrc/roi_align_fwd.cu``: (B, R, out, out, C) in
    the feature dtype (float32 or bfloat16), one launch for the batch and
    every level. ``multilevel_roi_align_cuda.launches`` counts launches."""
    _check_inputs(feats, rois, strides)
    dtype = feats[0].dtype
    device = feats[0].device
    if device.type != "cuda" or rois.device != device:
        raise ValueError("multilevel_roi_align_cuda takes CUDA tensors on one device")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"feature dtype {dtype} is not float32 or bfloat16")
    if rois.dtype != torch.float32:
        raise TypeError(f"rois must be float32, got {rois.dtype}")
    if not all(f.is_contiguous() for f in feats):
        raise ValueError("level maps must be contiguous NHWC tensors")
    if len(feats) > 8:
        raise ValueError("the kernel takes at most 8 levels")
    if out_size < 1 or sampling_ratio < 1:
        raise ValueError("out_size and sampling_ratio must be positive")
    b, r = rois.shape[:2]
    c = feats[0].shape[-1]
    out = torch.empty((b, r, out_size, out_size, c), dtype=dtype, device=device)
    if b * r == 0:
        return out
    rois = rois.contiguous()
    levels = map_rois_to_levels(rois, len(feats), finest_scale).contiguous()
    pairs = c % 2 == 0 and all(f.data_ptr() % (2 * f.element_size()) == 0 for f in feats)

    num = len(feats)
    ptrs = (ctypes.c_void_p * num)(*[f.data_ptr() for f in feats])
    heights = (ctypes.c_int * num)(*[f.shape[1] for f in feats])
    widths = (ctypes.c_int * num)(*[f.shape[2] for f in feats])
    scales = (ctypes.c_float * num)(*[1.0 / s for s in strides])
    fn = _kernel()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(
            _DTYPE_CODES[dtype], num, ptrs, heights, widths, scales,
            rois.data_ptr(), levels.data_ptr(), b, r, c, out_size, sampling_ratio,
            int(pairs), out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"roi_align_fwd failed to launch: CUDA error {rc}")
    multilevel_roi_align_cuda.launches += 1
    return out


multilevel_roi_align_cuda.launches = 0


def _kernel():
    fn = kernels.load("roi_align_fwd").roi_align_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    return fn


def batched_multilevel_roi_align(
    feats: Sequence[Tensor],  # per level (B, H_l, W_l, C)
    rois: Tensor,  # (B, R, 4)
    strides: Sequence[int],
    out_size: int = 7,
    sampling_ratio: int = 2,
    finest_scale: float = 56.0,
) -> Tensor:
    """(B, R, out, out, C) aligned features: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    device = feats[0].device
    if device.type == "cuda":
        fn = multilevel_roi_align_cuda
    elif device.type == "cpu":
        fn = multilevel_roi_align
    else:
        raise ValueError(f"no RoIAlign for device {device}")
    return fn(feats, rois, strides, out_size, sampling_ratio, finest_scale)
