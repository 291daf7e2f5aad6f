"""Host-side bbox ops (numpy).

The port's own copy of ``torch_detection_tpu/data/ops/bbox.py``: COCO xywh
to xyxy with the inclusive-pixel ``-1`` convention, crowd boxes routed to
the ignore list, resize, the horizontal flip ``x' = w - x - 1`` with
clipping, pad to ``max_gts``, crop, the degenerate-box filter and the
xyxy/xywh conversion, ``bbox_normalize``/``bbox_denormalize``, and
``bbox_visualize``, which draws in numpy (the card's machine has no
OpenCV): the rectangles are ``cv2.rectangle``'s pixels, the labels come from
a 3 x 5 bitmap font of the port's own where the reference draws Hershey
text. Randomness is injected (``rng``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

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


# ---------------------------------------------------------------- visualize
# 3 x 5 glyphs, one octal digit a row from the top, the high bit the left column;
# upper case draws as lower case, any other character as "?"
_GLYPHS = {
    "0": "75557", "1": "26227", "2": "71747", "3": "71717", "4": "55711", "5": "74717",
    "6": "74757", "7": "71111", "8": "75757", "9": "75717", "a": "25755", "b": "65656",
    "c": "34443", "d": "65556", "e": "74647", "f": "74644", "g": "34553", "h": "55755",
    "i": "72227", "j": "11152", "k": "55655", "l": "44447", "m": "57755", "n": "65555",
    "o": "25552", "p": "65644", "q": "25563", "r": "65655", "s": "34216", "t": "72222",
    "u": "55557", "v": "55552", "w": "55775", "x": "55255", "y": "55222", "z": "71247",
    " ": "00000", "|": "22222", ".": "00002", "_": "00007", "-": "00700", ":": "02020",
    "?": "71202",
}


_CELL = 2  # pixels a glyph cell: 6 x 10 glyphs, about the height of the reference's text


def text_size(text: str) -> Tuple[int, int]:
    """(width, height) in pixels of ``text`` as ``draw_text`` draws it:
    glyphs of 3 x 5 cells of ``_CELL`` pixels, one cell apart."""
    return max(len(text) * 4 - 1, 0) * _CELL, 5 * _CELL


def draw_text(img: np.ndarray, text: str, org: Tuple[int, int], color) -> np.ndarray:
    """Draw ``text`` into ``img`` in place with its bottom-left pixel at
    ``org`` (x, y), as ``cv2.putText``'s baseline origin; clipped to the
    image."""
    h, w = img.shape[:2]
    top, x = org[1] - 5 * _CELL + 1, org[0]
    for ch in text:
        rows = _GLYPHS.get(ch.lower(), _GLYPHS["?"])
        bits = np.array([[(int(r) >> (2 - c)) & 1 for c in range(3)] for r in rows], bool)
        ys, xs = np.nonzero(np.kron(bits, np.ones((_CELL, _CELL), bool)))
        ys, xs = ys + top, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        img[ys[keep], xs[keep]] = color
        x += 4 * _CELL
    return img


def draw_rectangle(img: np.ndarray, pt1: Tuple[int, int], pt2: Tuple[int, int], color) -> None:
    """``cv2.rectangle(img, pt1, pt2, color, thickness=1)`` in place: the
    four one-pixel sides between the corners, in either order, clipped to
    the image."""
    h, w = img.shape[:2]
    (xa, xb), (ya, yb) = sorted((pt1[0], pt2[0])), sorted((pt1[1], pt2[1]))
    x0, x1, y0, y1 = max(xa, 0), min(xb, w - 1), max(ya, 0), min(yb, h - 1)
    if x0 <= x1:
        for y in (ya, yb):
            if 0 <= y < h:
                img[y, x0:x1 + 1] = color
    if y0 <= y1:
        for x in (xa, xb):
            if 0 <= x < w:
                img[y0:y1 + 1, x] = color


def box_label(label: int, score: Optional[float], class_names: Optional[Sequence[str]]) -> str:
    """The reference's label text: the class name (or ``cls <label>``) and
    ``|<score>`` with two decimals."""
    text = class_names[label] if class_names is not None else f"cls {label}"
    return text if score is None else text + f"|{score:.02f}"


def bbox_visualize(
    img_array: np.ndarray,
    bboxes: np.ndarray,
    labels: np.ndarray,
    class_names: Optional[Sequence[str]] = None,
    score_thr: float = 0.0,
    bbox_color=(0, 255, 0),
    text_color=(0, 255, 0),
    out_file: Optional[str] = None,
):
    """Draw (n, 4|5) boxes and their labels on ``img_array`` in place;
    returns (img, kept): with ``score_thr > 0`` only boxes scoring above it
    (``kept``). Each box is cast to int32 (toward zero) and drawn as
    ``cv2.rectangle`` with thickness 1, the reference's, its label text at
    (x1, y1 - 2) as the reference's ``cv2.putText`` origin, in the port's
    bitmap font. ``out_file`` writes the result as a PNG."""
    from .image import img_write

    if bboxes.ndim != 2 or labels.ndim != 1 or bboxes.shape[0] != labels.shape[0] or \
            bboxes.shape[1] not in (4, 5):
        raise ValueError(f"bboxes (n, 4|5) and labels (n,), got {bboxes.shape} and {labels.shape}")
    inds = np.ones(bboxes.shape[0], dtype=bool)
    if score_thr > 0:
        if bboxes.shape[1] != 5:
            raise ValueError("score_thr needs (n, 5) boxes with scores")
        inds = bboxes[:, -1] > score_thr
        bboxes, labels = bboxes[inds], labels[inds]
    for bbox, label in zip(bboxes, labels):
        b = bbox.astype(np.int32)
        draw_rectangle(img_array, (int(b[0]), int(b[1])), (int(b[2]), int(b[3])), bbox_color)
        score = float(bbox[-1]) if len(bbox) > 4 else None
        draw_text(img_array, box_label(int(label), score, class_names),
                  (int(b[0]), int(b[1]) - 2), text_color)
    if out_file is not None:
        img_write(img_array, out_file)
    return img_array, inds


# ---------------------------------------------------------------- normalize
def bbox_normalize(bbox: np.ndarray, means=(0.0, 0.0, 0.0, 0.0),
                   stds=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """(x - mean) / std per coordinate."""
    if not bbox.shape[-1] == len(means) == len(stds) == 4:
        raise ValueError(f"bbox_normalize takes (..., 4) boxes, got {bbox.shape}")
    return (bbox - np.asarray(means, bbox.dtype)) / np.asarray(stds, bbox.dtype)


def bbox_denormalize(bbox: np.ndarray, means=(0.0, 0.0, 0.0, 0.0),
                     stds=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """x * std + mean; a class-specific (n, 4C) layout takes the four
    values once a class."""
    if bbox.shape[-1] % 4:
        raise ValueError(f"bbox_denormalize takes (..., 4C) boxes, got {bbox.shape}")
    reps = bbox.shape[-1] // 4
    return (bbox * np.tile(np.asarray(stds, bbox.dtype), reps)
            + np.tile(np.asarray(means, bbox.dtype), reps))
