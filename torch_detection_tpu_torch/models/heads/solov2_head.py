"""SOLOv2 heads: per-grid class scores and dynamic kernels, and the
unified stride-4 mask features.

Counterpart of ``torch_detection_tpu/models/heads/solov2_head.py``, with
the reference's names (``cls_tower{i}``, ``kernel_tower{i}``, ``cls_out``,
``kernel_out``; ``lateral{l}``, ``out_conv``). NHWC in and out; NCHW
channels_last inside.

* ``coord_channels``: the coordconv trick, x then y in [-1, 1], with the
  values ``jnp.linspace`` takes under jit (where the reference runs): XLA
  compiles its ``iota / (n - 1)`` as a product by float32's 1 / (n - 1),
  so the port takes that product, on every device the same bits.
* ``resize_bilinear``: ``jax.image.resize(..., "bilinear")``, which
  antialiases: a downsampled axis is filtered by the triangle kernel
  stretched by the ratio (the head takes P2's 200 x 336 to 40 x 40), an
  upsampled one is plain bilinear with half-pixel centres. That is
  ``F.interpolate(mode="bilinear", antialias=True, align_corners=False)``,
  which also handles an axis of each kind; where no axis shrinks (the mask
  features' P3-P5 to P2) the plain bilinear mode gives the same weights,
  and its backward is the cheaper kernel. It runs in float32 and rounds
  once to the map's dtype: the CPU's antialiased kernel has no bfloat16
  version, and CUDA's takes bf16 but rounds the intermediate of its two
  separable passes to bf16 (on an H100, 561 933 of the 1.65 M values of
  P2's b4 resize to 40 x 40 part from the float32 resize by more than a
  bf16 ulp) and is no faster (0.90 against 0.92 ms).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import HEADS
from ..inits import bias_init_with_prob
from ..layers import ConvModule


def _linspace(n: int, device) -> Tensor:
    """``jnp.linspace(-1, 1, n)`` under jit: ``-(1 - t) + t`` for ``t =
    i * fl(1 / (n - 1))``, then 1."""
    if n == 1:
        return torch.full((1,), -1.0, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(n - 1))
    return torch.cat([t - (1.0 - t), torch.ones(1, device=device)])


def coord_channels(batch: int, h: int, w: int, dtype: torch.dtype, device) -> Tensor:
    """(B, 2, h, w) normalised coordinates, x then y, in ``dtype``."""
    ys, xs = _linspace(h, device), _linspace(w, device)
    grid = torch.stack([xs[None, :].expand(h, w), ys[:, None].expand(h, w)])
    return grid.to(dtype)[None].expand(batch, 2, h, w)


def resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """NCHW ``x`` to ``size`` as ``jax.image.resize`` bilinear (module
    docstring), in float32, channels_last out in ``x``'s dtype."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    shrinks = size[0] < x.shape[2] or size[1] < x.shape[3]
    out = F.interpolate(x.float(), size, mode="bilinear", align_corners=False, antialias=shrinks)
    return out.to(x.dtype).contiguous(memory_format=torch.channels_last)


def _gn_conv(cin: int, cout: int, kernel: int, groups: int, dtype, device) -> ConvModule:
    return ConvModule(cin, cout, kernel, padding=kernel // 2,
                      norm_cfg=dict(type="GN", num_groups=groups), act="relu", dtype=dtype,
                      device=device)


@HEADS.register_module
class SOLOV2Head(nn.Module):
    """Per level: (B, S, S, C) class logits and (B, S, S, E) dynamic
    kernels. Each level is resized to its (S, S) grid; the kernel branch
    also sees the two coordinate channels (resized with the level: one
    resize of the level and its coordinates, whose first channels are the
    class branch's input). ``cls_out`` carries the 0.01 focal prior."""

    def __init__(self, num_classes: int = 80, in_channels: int = 256, feat_channels: int = 256,
                 kernel_channels: int = 128, stacked_convs: int = 4,
                 grid_numbers: Sequence[int] = (40, 36, 24, 16, 12), norm_groups: int = 32,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.grid_numbers = tuple(grid_numbers)
        self.stacked_convs = stacked_convs
        for i in range(stacked_convs):
            cin = in_channels if i == 0 else feat_channels
            self.add_module(f"cls_tower{i}", _gn_conv(cin, feat_channels, 3, norm_groups, dtype,
                                                      device))
            cin = in_channels + 2 if i == 0 else feat_channels
            self.add_module(f"kernel_tower{i}", _gn_conv(cin, feat_channels, 3, norm_groups,
                                                         dtype, device))
        self.cls_out = nn.Conv2d(feat_channels, num_classes, 3, padding=1, dtype=dtype,
                                 device=device)
        self.cls_out.init_bias = bias_init_with_prob(0.01)  # read by inits.init_weights
        self.kernel_out = nn.Conv2d(feat_channels, kernel_channels, 3, padding=1, dtype=dtype,
                                    device=device)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        if len(feats) != len(self.grid_numbers):
            raise ValueError(f"{len(feats)} levels vs {len(self.grid_numbers)} grids")
        cls_scores, kernels = [], []
        for f, s in zip(feats, self.grid_numbers):
            x = f.permute(0, 3, 1, 2)
            b, c, h, w = x.shape
            x = torch.cat([x, coord_channels(b, h, w, x.dtype, x.device)], dim=1)
            kf = resize_bilinear(x.contiguous(memory_format=torch.channels_last), (s, s))
            cf = kf[:, :c]
            for i in range(self.stacked_convs):
                kf = getattr(self, f"kernel_tower{i}")(kf)
                cf = getattr(self, f"cls_tower{i}")(cf)
            cls_scores.append(self.cls_out(cf).permute(0, 2, 3, 1))
            kernels.append(self.kernel_out(kf).permute(0, 2, 3, 1))
        return tuple(cls_scores), tuple(kernels)


@HEADS.register_module
class MaskFeatHead(nn.Module):
    """(B, H/4, W/4, E) mask features from the first ``num_inputs`` levels:
    each through ``lateral{l}`` (the deepest with the coordinate channels),
    resized to the first level's size and summed, then ``out_conv`` (1 x 1,
    GN, ReLU)."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 128, out_channels: int = 128,
                 num_inputs: int = 4, norm_groups: int = 32,
                 dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.num_inputs = num_inputs
        for lvl in range(num_inputs):
            cin = in_channels + 2 if lvl == num_inputs - 1 else in_channels
            self.add_module(f"lateral{lvl}", _gn_conv(cin, feat_channels, 3, norm_groups, dtype,
                                                      device))
        self.out_conv = _gn_conv(feat_channels, out_channels, 1, norm_groups, dtype, device)

    def forward(self, feats: Sequence[Tensor]) -> Tensor:
        feats = [f.permute(0, 3, 1, 2) for f in feats[: self.num_inputs]]
        size = tuple(feats[0].shape[2:])
        acc = None
        for lvl, x in enumerate(feats):
            if lvl == self.num_inputs - 1:
                b, _, h, w = x.shape
                x = torch.cat([x, coord_channels(b, h, w, x.dtype, x.device)], dim=1)
                x = x.contiguous(memory_format=torch.channels_last)
            x = resize_bilinear(getattr(self, f"lateral{lvl}")(x), size)
            acc = x if acc is None else acc + x
        return self.out_conv(acc).permute(0, 2, 3, 1)
