"""Per-sample transform pipelines (host side).

Counterpart of ``torch_detection_tpu/data/transforms.py``: ImageTransforms
(read -> normalize -> keep-ratio resize -> flip -> pad-to-divisor, HWC),
BboxTransforms (resize + flip), MaskTransforms (nearest resize + flip + pad
+ stack) and BackgroundErasing (zero grid cells with no gt overlap).
Randomness flows through an injected ``np.random.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .ops.bbox import bbox_flip, bbox_resize
from .ops.image import img_flip, img_normalize, img_pad_size_divisor, img_read, img_resize
from .ops.mask import mask_flip, mask_pad, mask_resize


class ImageTransforms:
    """read -> [normalize] -> keep-ratio resize -> random flip -> pad-to-divisor.

    Returns (img HWC float32, or uint8 with ``normalize_on_device``,
    img_shape, pad_shape, scale_factor, flipped_flag, flipped_direction).
    """

    def __init__(
        self,
        img_means=(0.0, 0.0, 0.0),
        img_stds=(1.0, 1.0, 1.0),
        size_divisor: Optional[int] = None,
        normalize_on_device: bool = False,
    ):
        self.img_means = np.asarray(img_means, np.float32)
        self.img_stds = np.asarray(img_stds, np.float32)
        self.size_divisor = size_divisor
        self.normalize_on_device = normalize_on_device

    def __call__(
        self,
        img_path: str,
        expected_size,
        flip_ratio: float = 0.0,
        rng: Optional[np.random.Generator] = None,
    ):
        img = img_read(img_path)
        if not self.normalize_on_device:
            img = img_normalize(img, self.img_means, self.img_stds)
        img, scale_factor = img_resize(img, size=expected_size, return_scale=True)
        img_shape = img.shape
        img, flipped_flag, flipped_direction = img_flip(img, flip_ratio, rng=rng)
        if self.size_divisor is not None:
            img = img_pad_size_divisor(img, size_divisor=self.size_divisor)
            pad_shape = img.shape
        else:
            pad_shape = img_shape
        img = np.ascontiguousarray(img, np.float32 if not self.normalize_on_device else np.uint8)
        return img, img_shape, pad_shape, scale_factor, flipped_flag, flipped_direction


class BboxTransforms:
    """Resize by the image's scale factor, then mirror if the image flipped."""

    def __call__(self, bbox, img_shape, scale_factor, flipped_flag, flipped_direction):
        bbox = bbox_resize(bbox, scale_factor)
        return bbox_flip(bbox, tuple(img_shape[:2]), flipped_flag=flipped_flag, direction=flipped_direction)


class MaskTransforms:
    """Resize each mask by the image's scale factor (nearest), mirror it if
    the image flipped, pad it to the image's ``pad_shape``; stack (K, H, W)
    uint8."""

    def __call__(self, masks, scale_factor, pad_shape, flipped_flag, flipped_direction):
        out = [
            mask_pad(mask_flip(mask_resize(m, scale_factor=scale_factor), flipped_flag=flipped_flag,
                               direction=flipped_direction), expected_shape=tuple(pad_shape[:2]))
            for m in masks
        ]
        if not out:
            return np.zeros((0,) + tuple(pad_shape[:2]), np.uint8)
        return np.stack(out, axis=0)


class BackgroundErasing:
    """Zero out a random fraction of grid cells containing no ground truth.

    Cells are ``cell_size`` squares; gt boxes are expanded by cell_size/2
    before the overlap test so objects keep a margin. Operates on HWC.
    """

    def __call__(
        self,
        img: np.ndarray,  # HWC
        img_shape,
        bbox: np.ndarray,
        cell_size: int = 32,
        random_ratio: float = 0.5,
        rng: Optional[np.random.Generator] = None,
    ) -> np.ndarray:
        rand = rng if rng is not None else np.random.default_rng()
        h, w = img_shape[0], img_shape[1]
        ny = int(np.ceil(h / cell_size))
        nx = int(np.ceil(w / cell_size))
        gx, gy = np.meshgrid(np.arange(nx) * cell_size, np.arange(ny) * cell_size)
        starts = np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float64)
        cells = np.concatenate([starts, starts + cell_size - 1], axis=1)
        cells[:, 0::2] = np.clip(cells[:, 0::2], 0, w - 1)
        cells[:, 1::2] = np.clip(cells[:, 1::2], 0, h - 1)

        expanded = np.asarray(bbox, np.float64).copy()
        if expanded.size == 0:
            background = np.ones(len(cells), bool)
        else:
            expanded[..., :2] -= cell_size // 2 - 1
            expanded[..., 2:4] += cell_size // 2 - 1
            expanded[..., 0::2] = np.clip(expanded[..., 0::2], 0, w - 1)
            expanded[..., 1::2] = np.clip(expanded[..., 1::2], 0, h - 1)
            background = ~self._any_overlap(cells, expanded)

        bg_cells = cells[background]
        if len(bg_cells) > 0:
            n_erase = int(np.ceil(len(bg_cells) * random_ratio))
            chosen = bg_cells[rand.choice(len(bg_cells), size=n_erase, replace=False)]
            for c in chosen:
                img[int(c[1]) : int(c[3]) + 1, int(c[0]) : int(c[2]) + 1, :] = 0
        return img

    @staticmethod
    def _any_overlap(cells: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        lt = np.maximum(cells[:, None, :2], boxes[None, :, :2])
        rb = np.minimum(cells[:, None, 2:4], boxes[None, :, 2:4])
        wh = np.clip(rb - lt, 0, None)
        return ((wh[..., 0] > 0) & (wh[..., 1] > 0)).any(axis=1)
