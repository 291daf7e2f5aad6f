"""Multi-level anchor generation.

Counterpart of ``torch_detection_tpu/ops/anchors.py``. Anchors flatten in
``(H, W, A)`` order, the order of a ``(B, H, W, A, ...)`` head output
reshaped to ``(B, -1, ...)``.
"""

from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class AnchorGenerator:
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

    @property
    def num_levels(self) -> int:
        return len(self.strides)

    def base_anchors_for_level(self, level: int, device=None) -> Tensor:
        sizes = self.base_sizes if self.base_sizes is not None else self.strides
        return base_anchors(
            sizes[level], self.ratios, self.resolved_scales, self.center_offset, device
        )

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
