"""Box geometry: pairwise IoU, delta encoding and decoding, clipping.

Counterpart of ``torch_detection_tpu/ops/boxes.py``. Boxes are xyxy with
the +1 inclusive-pixel offset. Every function broadcasts over leading
batch dimensions.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import Tensor


def bbox_areas(boxes: Tensor, offset: float = 1.0) -> Tensor:
    return (boxes[..., 2] - boxes[..., 0] + offset) * (boxes[..., 3] - boxes[..., 1] + offset)


def bbox_overlaps(
    boxes1: Tensor,  # (..., N, 4)
    boxes2: Tensor,  # (..., G, 4)
    mode: str = "iou",
    offset: float = 1.0,
    eps: float = 1e-6,
) -> Tensor:
    """Pairwise overlaps -> (..., N, G). ``mode='iou'``: intersection over
    union; ``'iof'``: intersection over the first box's area."""
    if mode not in ("iou", "iof"):
        raise ValueError(f"unknown mode {mode!r}")
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:4], boxes2[..., None, :, 2:4])
    wh = torch.clamp(rb - lt + offset, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = bbox_areas(boxes1, offset)
    if mode == "iof":
        union = area1[..., :, None]
    else:
        union = area1[..., :, None] + bbox_areas(boxes2, offset)[..., None, :] - inter
    return inter / torch.clamp(union, min=eps)


def bbox2delta(
    proposals: Tensor,  # (..., 4)
    gt: Tensor,  # (..., 4)
    means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    stds: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
    offset: float = 1.0,
) -> Tensor:
    """Encode gt boxes as (dx, dy, dw, dh) deltas relative to proposals,
    normalised by (means, stds)."""
    pw = proposals[..., 2] - proposals[..., 0] + offset
    ph = proposals[..., 3] - proposals[..., 1] + offset
    px = proposals[..., 0] + 0.5 * (pw - offset)
    py = proposals[..., 1] + 0.5 * (ph - offset)

    gw = gt[..., 2] - gt[..., 0] + offset
    gh = gt[..., 3] - gt[..., 1] + offset
    gx = gt[..., 0] + 0.5 * (gw - offset)
    gy = gt[..., 1] + 0.5 * (gh - offset)

    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                          torch.log(gh / ph)], dim=-1)
    means_t = torch.tensor(means, dtype=deltas.dtype, device=deltas.device)
    stds_t = torch.tensor(stds, dtype=deltas.dtype, device=deltas.device)
    return (deltas - means_t) / stds_t


def delta2bbox(
    rois: Tensor,  # (..., 4)
    deltas: Tensor,  # (..., 4) or class-specific (..., 4C)
    means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0),
    stds: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0),
    max_shape: Optional[Tuple[int, int]] = None,
    wh_ratio_clip: float = 16.0 / 1000.0,
    offset: float = 1.0,
) -> Tensor:
    """Decode (dx, dy, dw, dh) deltas to xyxy boxes of ``deltas``' shape.
    ``wh_ratio_clip`` bounds the exp(); ``max_shape`` (h, w) clips."""
    # each coordinate by its Python scalars, rounded to ``deltas``' dtype as
    # the reference's (4,) arrays are, without copying a tensor to the
    # device (a host sync on CUDA)
    def rounded(x: float) -> float:
        return torch.tensor(x, dtype=deltas.dtype).item()

    dx, dy, dw, dh = (deltas[..., i::4] * rounded(stds[i]) + rounded(means[i]) for i in range(4))
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = torch.clamp(dw, -max_ratio, max_ratio)
    dh = torch.clamp(dh, -max_ratio, max_ratio)

    pw = (rois[..., 2] - rois[..., 0] + offset)[..., None]
    ph = (rois[..., 3] - rois[..., 1] + offset)[..., None]
    px = rois[..., 0][..., None] + 0.5 * (pw - offset)
    py = rois[..., 1][..., None] + 0.5 * (ph - offset)

    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy

    x1 = gx - 0.5 * (gw - offset)
    y1 = gy - 0.5 * (gh - offset)
    x2 = gx + 0.5 * (gw - offset)
    y2 = gy + 0.5 * (gh - offset)
    if max_shape is not None:
        x1 = torch.clamp(x1, 0, max_shape[1] - offset)
        y1 = torch.clamp(y1, 0, max_shape[0] - offset)
        x2 = torch.clamp(x2, 0, max_shape[1] - offset)
        y2 = torch.clamp(y2, 0, max_shape[0] - offset)
    return torch.stack([x1, y1, x2, y2], dim=-1).reshape(deltas.shape)


def clip_boxes(boxes: Tensor, img_shapes: Tensor, offset: float = 1.0) -> Tensor:
    """Clip xyxy boxes (B, ..., 4) to per-image (h, w) given as (B, 2)."""
    view = (img_shapes.shape[0],) + (1,) * (boxes.dim() - 1)
    h = img_shapes[:, 0].reshape(view).to(boxes.dtype)
    w = img_shapes[:, 1].reshape(view).to(boxes.dtype)
    x = torch.minimum(torch.clamp(boxes[..., 0::2], min=0), w - offset)
    y = torch.minimum(torch.clamp(boxes[..., 1::2], min=0), h - offset)
    return torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
