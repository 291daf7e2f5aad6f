"""On-device image preprocessing: the uint8 wire to normalized images.

Counterpart of ``torch_detection_tpu/ops/preprocess.py``. The host places
each image on a uint8 canvas (for an ``stem_s2d`` backbone already relaid
2x2 space-to-depth by ``space_to_depth_2x2_np``), so four times fewer bytes
cross to the device than in float32; on the device one expression
normalizes, zeroes the padding beyond each image's (h, w) and casts to the
compute dtype. The op order is the reference's, ``(x - mean) * inv_std``
with ``inv_std`` the float32 reciprocal, so both give the same bits.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import Tensor

MEAN = (123.675, 116.28, 103.53)
STD = (58.395, 57.12, 57.375)


def _normalize_masked(x: Tensor, mean: Tensor, inv_std: Tensor, mask: Tensor,
                      out_dtype: torch.dtype) -> Tensor:
    y = (x.to(torch.float32) - mean) * inv_std
    return torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=y.device)).to(out_dtype)


def _stats(mean: Sequence[float], std: Sequence[float], repeats: int, device):
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device).repeat(repeats)
    inv_t = (1.0 / torch.tensor(std, dtype=torch.float32, device=device)).repeat(repeats)
    return mean_t, inv_t


def fused_normalize_pad(
    images_u8: Tensor,  # (B, H, W, C) uint8, zero-padded canvases
    img_shapes: Tensor,  # (B, 2) valid (h, w) of each image
    mean: Sequence[float] = MEAN,
    std: Sequence[float] = STD,
    out_dtype: torch.dtype = torch.bfloat16,
) -> Tensor:
    """(B, H, W, C) ``out_dtype`` normalized images, zero outside each
    image's (h, w)."""
    _, h, w, c = images_u8.shape
    device = images_u8.device
    mean_t, inv_t = _stats(mean, std, 1, device)
    sh = img_shapes.to(device=device, dtype=torch.int32)
    rows = torch.arange(h, dtype=torch.int32, device=device)[None, :, None, None]
    cols = torch.arange(w, dtype=torch.int32, device=device)[None, None, :, None]
    mask = (rows < sh[:, 0, None, None, None]) & (cols < sh[:, 1, None, None, None])
    return _normalize_masked(images_u8, mean_t, inv_t, mask, out_dtype)


def fused_normalize_pad_s2d(
    images_s2d_u8: Tensor,  # (B, H/2, W/2, 4C) uint8 space-to-depth canvases
    img_shapes: Tensor,  # (B, 2) valid (h, w) in the ORIGINAL coordinates
    mean: Sequence[float] = MEAN,
    std: Sequence[float] = STD,
    out_dtype: torch.dtype = torch.bfloat16,
) -> Tensor:
    """(B, H/2, W/2, 4C) ``out_dtype`` normalized space-to-depth images.

    Channel ``ch`` holds sub-row ``p = ch // 2C`` and sub-column
    ``q = (ch % 2C) // C`` of its 2x2 cell, so it is valid where
    ``2 * row + p < h`` and ``2 * col + q < w`` in the original frame."""
    _, h2, w2, c4 = images_s2d_u8.shape
    c = c4 // 4
    device = images_s2d_u8.device
    mean_t, inv_t = _stats(mean, std, 4, device)
    sh = img_shapes.to(device=device, dtype=torch.int32)
    ch = torch.arange(c4, dtype=torch.int32, device=device)
    p = (ch // (2 * c))[None, None, None, :]
    q = ((ch % (2 * c)) // c)[None, None, None, :]
    rows = torch.arange(h2, dtype=torch.int32, device=device)[None, :, None, None]
    cols = torch.arange(w2, dtype=torch.int32, device=device)[None, None, :, None]
    mask = (2 * rows + p < sh[:, 0, None, None, None]) & (2 * cols + q < sh[:, 1, None, None, None])
    return _normalize_masked(images_s2d_u8, mean_t, inv_t, mask, out_dtype)


def space_to_depth_2x2_np(x: np.ndarray) -> np.ndarray:
    """(B, H, W, C) -> (B, H/2, W/2, 4C) on the host, channel order (p, q, c):
    the wire of an ``stem_s2d`` backbone."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs an even canvas, got {h} x {w}")
    return (x.reshape(b, h // 2, 2, w // 2, 2, c)
            .transpose(0, 1, 3, 2, 4, 5)
            .reshape(b, h // 2, w // 2, 4 * c))
