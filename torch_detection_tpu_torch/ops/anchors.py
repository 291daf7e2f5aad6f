"""Multi-level anchor generation.

Counterpart of ``torch_detection_tpu/ops/anchors.py``: the RetinaNet and
R-CNN ``AnchorGenerator``, YOLOv3's ``YOLOAnchorGenerator`` and SSD's
``SSDAnchorGenerator``. Anchors flatten in ``(H, W, A)`` order, the order
of a ``(B, H, W, A, ...)`` head output reshaped to ``(B, -1, ...)``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch import Tensor


def base_anchors(
    base_size: float,
    ratios: Sequence[float],
    scales: Sequence[float],
    center_offset: float = 0.0,
    device=None,
) -> Tensor:
    """(A, 4) xyxy anchors centred on cell (0, 0); for each ratio, all scales."""
    w = h = float(base_size)
    cx = center_offset * w
    cy = center_offset * h
    ratios_t = torch.tensor(ratios, dtype=torch.float32, device=device)
    scales_t = torch.tensor(scales, dtype=torch.float32, device=device)
    h_ratios = torch.sqrt(ratios_t)
    w_ratios = 1.0 / h_ratios
    ws = (w * w_ratios[:, None] * scales_t[None, :]).reshape(-1)
    hs = (h * h_ratios[:, None] * scales_t[None, :]).reshape(-1)
    return torch.stack([cx - 0.5 * ws, cy - 0.5 * hs, cx + 0.5 * ws, cy + 0.5 * hs], dim=-1)


def grid_anchors(base: Tensor, featmap_size: Tuple[int, int], stride: int) -> Tensor:
    """Tile (A, 4) base anchors over an H x W grid -> (H*W*A, 4), row-major
    over (y, x) then anchor."""
    h, w = featmap_size
    shift_x = torch.arange(w, dtype=torch.float32, device=base.device) * stride
    shift_y = torch.arange(h, dtype=torch.float32, device=base.device) * stride
    sx = shift_x[None, :].expand(h, w).reshape(-1)
    sy = shift_y[:, None].expand(h, w).reshape(-1)
    shifts = torch.stack([sx, sy, sx, sy], dim=-1)  # (H*W, 4)
    return (base[None, :, :] + shifts[:, None, :]).reshape(-1, 4)


class _LevelGrid:
    """What every generator here does with its ``strides`` and
    ``base_anchors_for_level``: the per-level grids, their concatenation,
    and the feature-map sizes of a canvas."""

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def grid_anchors(self, featmap_sizes: Sequence[Tuple[int, int]], device=None) -> List[Tensor]:
        """Per-level (H_i*W_i*A, 4) anchors for the given feature-map sizes."""
        if len(featmap_sizes) != self.num_levels:
            raise ValueError(f"{len(featmap_sizes)} feature maps for {self.num_levels} levels")
        return [
            grid_anchors(self.base_anchors_for_level(i, device), featmap_sizes[i], self.strides[i])
            for i in range(self.num_levels)
        ]

    def flat_anchors(self, featmap_sizes: Sequence[Tuple[int, int]], device=None) -> Tensor:
        """All levels concatenated: (sum_i H_i*W_i*A, 4)."""
        return torch.cat(self.grid_anchors(featmap_sizes, device), dim=0)

    def featmap_sizes_for(self, pad_shape: Tuple[int, int]) -> List[Tuple[int, int]]:
        """The feature-map sizes of a (h, w) canvas, ceil(size / stride)."""
        h, w = pad_shape
        return [(int(math.ceil(h / s)), int(math.ceil(w / s))) for s in self.strides]


def _centred(c: float, whs: Sequence[Tuple[float, float]], device) -> Tensor:
    """(A, 4) float32 boxes of sizes ``whs`` centred on (c, c)."""
    return torch.tensor([(c - 0.5 * w, c - 0.5 * h, c + 0.5 * w, c + 0.5 * h) for w, h in whs],
                        dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class AnchorGenerator(_LevelGrid):
    """Multi-level anchor generator: explicit ``scales`` (Faster R-CNN), or
    ``octave_base_scale`` with ``scales_per_octave`` (RetinaNet). ``strides``
    double as base sizes unless ``base_sizes`` is given."""

    strides: Tuple[int, ...] = (8, 16, 32, 64, 128)
    ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    scales: Optional[Tuple[float, ...]] = None
    octave_base_scale: Optional[float] = 4.0
    scales_per_octave: int = 3
    base_sizes: Optional[Tuple[int, ...]] = None
    center_offset: float = 0.0

    def __post_init__(self):
        if self.scales is None and self.octave_base_scale is None:
            raise ValueError("need scales or octave_base_scale")

    @property
    def resolved_scales(self) -> Tuple[float, ...]:
        if self.scales is not None:
            return tuple(self.scales)
        return tuple(
            self.octave_base_scale * 2 ** (i / self.scales_per_octave)
            for i in range(self.scales_per_octave)
        )

    @property
    def num_base_anchors(self) -> int:
        return len(self.ratios) * len(self.resolved_scales)

    def base_anchors_for_level(self, level: int, device=None) -> Tensor:
        sizes = self.base_sizes if self.base_sizes is not None else self.strides
        return base_anchors(
            sizes[level], self.ratios, self.resolved_scales, self.center_offset, device
        )


@dataclasses.dataclass(frozen=True)
class YOLOAnchorGenerator(_LevelGrid):
    """YOLOv3's anchors: explicit (w, h) base sizes a level, centred on
    ``(i + 0.5) * stride``; levels coarse to fine, as the YOLOv3 neck's
    outputs."""

    strides: Tuple[int, ...] = (32, 16, 8)
    base_sizes: Tuple[Tuple[Tuple[float, float], ...], ...] = (
        ((116.0, 90.0), (156.0, 198.0), (373.0, 326.0)),
        ((30.0, 61.0), (62.0, 45.0), (59.0, 119.0)),
        ((10.0, 13.0), (16.0, 30.0), (33.0, 23.0)),
    )

    @property
    def num_base_anchors(self) -> int:
        return len(self.base_sizes[0])

    def base_anchors_for_level(self, level: int, device=None) -> Tensor:
        return _centred(0.5 * float(self.strides[level]), self.base_sizes[level], device)

    def flat_strides(self, featmap_sizes: Sequence[Tuple[int, int]], device=None) -> Tensor:
        """(N,) float32 stride of each flat anchor (the box coding's scale)."""
        return torch.cat([torch.full((h * w * self.num_base_anchors,), float(s),
                                     dtype=torch.float32, device=device)
                          for (h, w), s in zip(featmap_sizes, self.strides)])

    def responsible_flags(
        self,
        featmap_sizes: Sequence[Tuple[int, int]],
        gt_boxes: Tensor,  # (B, G, 4) xyxy
        gt_valid: Tensor,  # (B, G) bool
    ) -> Tensor:
        """(B, N) bool: at every level, the anchors of each cell that holds
        a valid gt's centre (floor(centre / stride), clipped to the grid).
        A cell is responsible as a whole, for every gt whose centre it
        holds, as the reference's per-cell union."""
        cx = 0.5 * (gt_boxes[..., 0] + gt_boxes[..., 2])
        cy = 0.5 * (gt_boxes[..., 1] + gt_boxes[..., 3])
        flags = []
        for (h, w), s in zip(featmap_sizes, self.strides):
            gx = torch.floor(cx / s).to(torch.int64).clamp(0, w - 1)
            gy = torch.floor(cy / s).to(torch.int64).clamp(0, h - 1)
            hits = torch.zeros((gt_boxes.shape[0], h * w), dtype=torch.int32,
                               device=gt_boxes.device)
            hits.scatter_add_(1, gy * w + gx, gt_valid.to(torch.int32))
            flags.append((hits > 0).repeat_interleave(self.num_base_anchors, dim=1))
        return torch.cat(flags, dim=1)


@dataclasses.dataclass(frozen=True)
class SSDAnchorGenerator(_LevelGrid):
    """SSD's anchors (mmdetection's ``SSDAnchorGenerator`` geometry): each
    level's ``min_size`` square, its sqrt(min * max) square, and for each
    ratio r of the level ``min_size`` boxes at r and 1 / r, centred on
    ``(i + 0.5) * stride``: 4 or 6 anchors a cell, so the count is a
    level's own (``num_base_anchors_per_level``)."""

    strides: Tuple[int, ...] = (8, 16, 32, 64, 100, 300)
    min_sizes: Tuple[float, ...] = (21.0, 45.0, 99.0, 153.0, 207.0, 261.0)
    max_sizes: Tuple[float, ...] = (45.0, 99.0, 153.0, 207.0, 261.0, 315.0)
    ratios: Tuple[Tuple[float, ...], ...] = ((2.0,), (2.0, 3.0), (2.0, 3.0), (2.0, 3.0), (2.0,),
                                             (2.0,))

    @property
    def num_base_anchors_per_level(self) -> Tuple[int, ...]:
        return tuple(2 + 2 * len(r) for r in self.ratios)

    def base_anchors_for_level(self, level: int, device=None) -> Tensor:
        s = float(self.min_sizes[level])
        big = math.sqrt(s * float(self.max_sizes[level]))
        whs = [(s, s), (big, big)]
        for r in self.ratios[level]:
            sr = math.sqrt(r)
            whs += [(s * sr, s / sr), (s / sr, s * sr)]
        return _centred(0.5 * float(self.strides[level]), whs, device)
