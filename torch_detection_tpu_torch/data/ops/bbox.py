"""Host-side bbox ops (numpy).

The port's own copy of ``torch_detection_tpu/data/ops/bbox.py``: COCO xywh
to xyxy with the inclusive-pixel ``-1`` convention, crowd boxes routed to
the ignore list, resize, the horizontal flip ``x' = w - x - 1`` with
clipping, pad to ``max_gts``, crop, the degenerate-box filter and the
xyxy/xywh conversion. Randomness is injected (``rng``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


def bbox_parse(
    annotation: Dict,
    gt_bboxes: List,
    gt_labels: List,
    gt_bboxes_ignore: List,
    cat2label: Dict,
    gt_labels_ignore: Optional[List] = None,
    gt_areas: Optional[List] = None,
) -> bool:
    """Append one COCO-style annotation to the accumulator lists.

    Returns False (and appends nothing) for ignored or degenerate boxes;
    crowd boxes go to ``gt_bboxes_ignore`` (their classes to
    ``gt_labels_ignore``), the others' annotation areas to ``gt_areas``:
    COCO evaluation scores size buckets on the annotation's area."""
    assert len(gt_bboxes) == len(gt_labels)
    if annotation.get("ignore", False):
        return False
    x1, y1, w, h = annotation["bbox"]
    if annotation.get("area", w * h) <= 0 or w < 1 or h < 1:
        return False
    bbox = [x1, y1, x1 + w - 1, y1 + h - 1]
    if annotation.get("iscrowd", 0):
        gt_bboxes_ignore.append(bbox)
        if gt_labels_ignore is not None:
            gt_labels_ignore.append(cat2label[annotation["category_id"]])
    else:
        gt_bboxes.append(bbox)
        gt_labels.append(cat2label[annotation["category_id"]])
        if gt_areas is not None:
            gt_areas.append(float(annotation.get("area", w * h)))
    return True


def bbox_resize(bbox: np.ndarray, scale_factor: float) -> np.ndarray:
    assert isinstance(scale_factor, (int, float, np.floating))
    return bbox * scale_factor


def bbox_flip(
    bbox: np.ndarray,
    img_shape: Tuple[int, int],
    flipped_flag: bool = True,
    direction: str = "horizontal",
) -> np.ndarray:
    """Mirror xyxy boxes with the inclusive-pixel convention x' = dim - x - 1."""
    assert bbox.shape[-1] == 4
    assert isinstance(img_shape, tuple) and len(img_shape) == 2
    assert direction in ("horizontal", "vertical")
    if not flipped_flag:
        return bbox
    flipped = bbox.copy()
    if direction == "horizontal":
        w = img_shape[1]
        flipped[..., 0] = w - bbox[..., 2] - 1
        flipped[..., 2] = w - bbox[..., 0] - 1
        flipped[..., 0::2] = np.clip(flipped[..., 0::2], 0, img_shape[1])
    else:
        h = img_shape[0]
        flipped[..., 1] = h - bbox[..., 3] - 1
        flipped[..., 3] = h - bbox[..., 1] - 1
        flipped[..., 1::2] = np.clip(flipped[..., 1::2], 0, img_shape[0])
    return flipped


def bbox_pad(bbox: np.ndarray, max_num_gts: int) -> np.ndarray:
    """Zero-pad (k, 4) to (max_num_gts, 4)."""
    padded = np.zeros((max_num_gts, 4), dtype=np.float32)
    n = min(bbox.shape[0], max_num_gts)
    padded[:n] = bbox[:n]
    return padded


def bbox_crop(
    bbox: np.ndarray,
    img: np.ndarray,
    size_crop: Tuple[int, int],
    rng: Optional[np.random.Generator] = None,
) -> Tuple[np.ndarray, int, int]:
    """Choose a (width, height) crop window covering as many gts as possible;
    returns (shifted and clipped boxes, min_w, min_h)."""
    assert bbox.shape[-1] == 4
    rand = rng if rng is not None else np.random.default_rng()

    min_bw, max_bw = np.min(bbox[..., 0]), np.max(bbox[..., 2])
    min_bh, max_bh = np.min(bbox[..., 1]), np.max(bbox[..., 3])
    bw = max_bw - min_bw + 1
    bh = max_bh - min_bh + 1

    img_h, img_w = img.shape[:2]
    cw, ch = size_crop
    if cw < bw:
        min_w = int(min_bw)
    else:
        lo = max(max_bw - cw + 1, 0)
        hi = min(img_w - cw, min_bw)
        min_w = int(rand.integers(int(lo), int(hi) + 1))
    if ch < bh:
        min_h = int(min_bh)
    else:
        lo = max(max_bh - ch + 1, 0)
        hi = min(img_h - ch, min_bh)
        min_h = int(rand.integers(int(lo), int(hi) + 1))

    cropped = bbox.copy()
    cropped[..., 0::2] = np.clip(cropped[..., 0::2] - min_w, 0, cw - 1)
    cropped[..., 1::2] = np.clip(cropped[..., 1::2] - min_h, 0, ch - 1)
    return cropped, min_w, min_h


def bbox_valid(bbox: np.ndarray, label: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Drop degenerate boxes (x1 >= x2 or y1 >= y2) after a flip or crop."""
    invalid = (bbox[..., 0] >= bbox[..., 2]) | (bbox[..., 1] >= bbox[..., 3])
    valid = np.nonzero(~invalid)[0]
    if len(valid) < len(bbox):
        bbox = bbox[valid]
        label = label[valid]
    return bbox, label


def bbox_convert_mode(bbox: np.ndarray, mode: str = "xywh2xyxy") -> np.ndarray:
    """xywh <-> xyxy with the inclusive-pixel -1/+1 convention."""
    assert mode in ("xywh2xyxy", "xyxy2xywh")
    a = bbox[..., :2]
    b = bbox[..., 2:4]
    if mode == "xyxy2xywh":
        return np.concatenate([a, b - a + 1], axis=-1)
    return np.concatenate([a, a + b - 1], axis=-1)
