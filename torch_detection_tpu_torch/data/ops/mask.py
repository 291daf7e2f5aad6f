"""Host-side mask ops (numpy), without OpenCV or pycocotools.

Counterpart of ``torch_detection_tpu/data/ops/mask.py``:

* the COCO RLE codec: uncompressed ``{'counts': [int...], 'size': [h, w]}``
  (column-major runs, zeros first) and COCO's compressed LEB128-style
  strings, decoded and encoded with numpy; run-native areas and IoUs;
* ``poly_to_mask``: the reference rasterises polygons with
  ``cv2.fillPoly`` on vertices rounded by ``np.round``; the card's machine
  has no OpenCV, so this module fills them the way OpenCV 5's drawing code
  does (``CollectPolyEdges`` then ``FillEdgeCollection``, 16.16 fixed
  point, even-odd spans between the sorted active edges, plus every edge's
  8-connected Bresenham outline, both clipped to the image), bit for bit
  (``tests/test_torch_mask_data.py`` holds it to the installed cv2);
* resize (nearest, cv2's ``INTER_NEAREST`` floor mapping), flip, crop and
  pad of a mask;
* ``mask_visualize``, the reference's overlay in numpy.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .image import img_crop, img_pad, img_resize


# ---------------------------------------------------------------- RLE codec
def rle_decode(rle: Dict) -> np.ndarray:
    """A COCO RLE dict (compressed or uncompressed) -> (H, W) uint8 mask."""
    h, w = rle["size"]
    starts, ends = rle_intervals(rle)
    diff = np.zeros(h * w + 1, dtype=np.int8)
    diff[starts] += 1
    diff[ends] -= 1
    flat = np.cumsum(diff[:-1]).astype(np.uint8)
    return flat.reshape((w, h)).T  # COCO RLE is column-major


def rle_encode(mask: np.ndarray, compress: bool = True) -> Dict:
    """An (H, W) binary mask -> COCO RLE (column-major run lengths, zeros
    first); ``compress`` gives the counts as COCO's byte string."""
    h, w = mask.shape
    flat = np.asfortranarray(np.asarray(mask, np.uint8)).T.reshape(-1)
    if flat.size == 0:
        counts: List[int] = [0]
    else:
        changes = np.nonzero(np.diff(flat))[0] + 1
        runs = np.diff(np.concatenate([[0], changes, [flat.size]])).tolist()
        counts = [0] + runs if flat[0] == 1 else runs
    if compress:
        return {"size": [h, w], "counts": _rle_compress(counts)}
    return {"size": [h, w], "counts": counts}


def _rle_decompress(s: Union[bytes, str]) -> np.ndarray:
    """COCO's LEB128-like RLE string -> run-length counts: 5-bit chunks
    grouped by their continuation bit (0x20), each group's sign from its top
    chunk's 0x10, then the delta ``counts[i] += counts[i - 2]`` (i > 2)
    undone with two strided cumsums."""
    if isinstance(s, str):
        s = s.encode("ascii")
    if not s:
        return np.zeros(0, np.int64)
    a = np.frombuffer(s, np.uint8).astype(np.int64) - 48
    bits = a & 0x1F
    more = (a & 0x20) != 0
    ends = np.nonzero(~more)[0]  # last chunk of each value
    starts = np.concatenate([np.zeros(1, np.int64), ends[:-1] + 1])
    group = np.searchsorted(ends, np.arange(len(a)), side="left")
    k = np.arange(len(a)) - starts[group]
    x = np.add.reduceat(bits << (5 * k), starts)
    neg = (bits[ends] & 0x10) != 0
    x = np.where(neg, x + (-1 << (5 * (ends - starts + 1))), x)
    out = x.copy()
    out[1::2] = np.cumsum(x[1::2])
    out[2::2] = np.cumsum(x[2::2])
    return out


def _rle_compress(counts: Sequence[int]) -> bytes:
    """Counts -> COCO's RLE string, the inverse of ``_rle_decompress``."""
    x = np.asarray(counts, np.int64)
    if x.size == 0:
        return b""
    v = x.copy()
    v[3:] = x[3:] - x[1:-2]  # counts[i] -= counts[i - 2] for i > 2
    # chunks a value: its magnitude's bits and one sign bit, 5 bits a chunk
    w = np.where(v >= 0, v, ~v).astype(np.float64)
    nbits = np.where(w > 0, np.ceil(np.log2(w + 1.0)), 0).astype(np.int64) + 1
    k = np.maximum((nbits + 4) // 5, 1)
    offs = np.concatenate([np.zeros(1, np.int64), np.cumsum(k)])
    idx = np.repeat(np.arange(len(v)), k)
    j = np.arange(offs[-1]) - offs[idx]
    chunk = (v[idx] >> (5 * j)) & 0x1F
    cont = np.where(j < k[idx] - 1, 0x20, 0)
    return ((chunk | cont) + 48).astype(np.uint8).tobytes()


def _rle_counts(rle: Dict) -> Sequence[int]:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        counts = _rle_decompress(counts)
    return counts


def rle_intervals(rle: Dict) -> Tuple[np.ndarray, np.ndarray]:
    """The 1-runs of an RLE as sorted disjoint ``[start, end)`` intervals in
    flat column-major pixel order."""
    counts = np.asarray(_rle_counts(rle), np.int64)
    bounds = np.concatenate([np.zeros(1, np.int64), np.cumsum(counts)])
    starts, ends = bounds[1::2], bounds[2::2]
    return starts[: len(ends)], ends


def rle_area(rle: Dict) -> int:
    """Foreground pixels of an RLE, without decoding it."""
    starts, ends = rle_intervals(rle)
    return int((ends - starts).sum())


def _interval_intersection(sa: np.ndarray, ea: np.ndarray, sb: np.ndarray, eb: np.ndarray) -> int:
    """Total overlap of two sorted disjoint interval sets: for each a-interval
    the overlapping b-range by ``searchsorted``; only its first and last
    b-intervals can be clipped."""
    if len(sa) == 0 or len(sb) == 0:
        return 0
    i0 = np.searchsorted(eb, sa, side="right")
    i1 = np.searchsorted(sb, ea, side="left")
    cum = np.concatenate([np.zeros(1, np.int64), np.cumsum(eb - sb)])
    base = cum[i1] - cum[i0]
    lo = np.maximum(0, sa - sb[np.minimum(i0, len(sb) - 1)])
    hi = np.maximum(0, eb[np.maximum(i1 - 1, 0)] - ea)
    return int((base - lo - hi)[i1 > i0].sum())


def rle_iou_matrix(dt_rles: Sequence[Dict], gt_rles: Sequence[Dict], crowd: bool = False) -> np.ndarray:
    """Pairwise mask IoU of two RLE lists, on their runs. ``crowd=True``
    takes COCO's iscrowd rule: intersection / detection area."""
    d_ints = [rle_intervals(r) for r in dt_rles]
    g_ints = [rle_intervals(r) for r in gt_rles]
    d_areas = np.array([float((e - s).sum()) for s, e in d_ints])
    g_areas = np.array([float((e - s).sum()) for s, e in g_ints])
    iou = np.zeros((len(dt_rles), len(gt_rles)))
    for i, (sa, ea) in enumerate(d_ints):
        for j, (sb, eb) in enumerate(g_ints):
            inter = _interval_intersection(sa, ea, sb, eb)
            denom = d_areas[i] if crowd else d_areas[i] + g_areas[j] - inter
            iou[i, j] = inter / max(denom, 1e-9)
    return iou


# ---------------------------------------------------------------- polygon fill
_XY_SHIFT = 16
_XY_CEIL = (1 << _XY_SHIFT) - 1


def _clip_line(w: int, h: int, x1: int, y1: int, x2: int, y2: int):
    """OpenCV's ``clipLine`` on a (w, h) image: Cohen-Sutherland with the
    intercepts truncated toward zero from doubles. Returns whether any of
    the segment is inside, and the endpoints, moved as OpenCV moves them
    (even when the answer is no)."""
    right, bottom = w - 1, h - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * (x2 - x1) / (y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * (x2 - x1) / (y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * (y2 - y1) / (x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * (y2 - y1) / (x2 - x1))
                x2 = a
                c2 = 0
    return (c1 | c2) == 0, x1, y1, x2, y2


def _line_pixels(x0: int, y0: int, x1: int, y1: int) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels of OpenCV's 8-connected ``LineIterator`` from (x0, y0) to
    (x1, y1), walked left to right: Bresenham with ``err = dx - 2 dy``, whose
    minor-axis offset after i major steps is ceil((2 dy i - dx) / (2 dx))."""
    if x1 < x0:
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = 1 if dy >= 0 else -1
    dy = abs(dy)
    major, minor = (dy, dx) if dy > dx else (dx, dy)
    i = np.arange(major + 1, dtype=np.int64)
    m = -((major - 2 * minor * i) // (2 * major)) if major else np.zeros(1, np.int64)
    if dy > dx:
        return x0 + m, y0 + sy * i
    return x0 + i, y0 + sy * m


def _collect_edges(mask: np.ndarray, pts: np.ndarray, edges: List[Tuple[int, int, int, int]]) -> None:
    """OpenCV's ``CollectPolyEdges`` for one closed polygon of integer
    vertices (shift 0): draws each edge's outline into ``mask`` and appends
    the non-horizontal edges as (y0, y1, x, dx), x and dx in 16.16 fixed
    point, x at row y0, dx floored. An edge with an endpoint off the image
    takes the line through its clipped endpoints; clipped to one row, it
    stands upright at its clipped x."""
    h, w = mask.shape
    for i in range(len(pts)):
        xa, ya = (int(v) for v in pts[i - 1])
        xb, yb = (int(v) for v in pts[i])
        if 0 <= xa < w and 0 <= xb < w and 0 <= ya < h and 0 <= yb < h:
            xs, ys = _line_pixels(xa, ya, xb, yb)
            mask[ys, xs] = 1
            ca, cya, cb, cyb = xa, ya, xb, yb
        else:
            ok, ca, cya, cb, cyb = _clip_line(w, h, xa, ya, xb, yb)
            if ok:
                xs, ys = _line_pixels(ca, cya, cb, cyb)
                mask[ys, xs] = 1
        if ya == yb:
            continue
        lo, hi = min(ya, yb), max(ya, yb)
        if cya == cyb:
            edges.append((lo, hi, ca << _XY_SHIFT, 0))
            continue
        dx = ((cb - ca) << _XY_SHIFT) // (cyb - cya)
        x0, y0 = (ca, cya) if ya < yb else (cb, cyb)  # the upper end, as clipped
        edges.append((lo, hi, (x0 << _XY_SHIFT) + (lo - y0) * dx, dx))


def _fill_edges(mask: np.ndarray, edges: List[Tuple[int, int, int, int]]) -> None:
    """OpenCV's ``FillEdgeCollection`` over all rows at once: at row y an
    active edge (y0 <= y < y1) lies at x + (y - y0) * dx; the active x's,
    sorted, pair up into spans from the ceiling of the left x to the floor
    of the right x, those inside the image clipped to it."""
    h, w = mask.shape
    e = np.asarray(edges, np.int64)
    y0, y1, x0, dx = e[:, 0], e[:, 1], e[:, 2], e[:, 3]
    ends = x0 + (y1 - y0) * dx
    if (int(y1.max()) < 0 or int(y0.min()) >= h or max(x0.max(), ends.max()) < 0
            or min(x0.min(), ends.min()) >= (w << _XY_SHIFT)):
        return
    rows = np.arange(max(int(y0.min()), 0), min(int(y1.max()), h), dtype=np.int64)[:, None]
    on = (rows >= y0[None]) & (rows < y1[None])
    xs = np.sort(np.where(on, x0[None] + (rows - y0[None]) * dx[None], np.iinfo(np.int64).max), axis=1)
    pairs = xs.shape[1] // 2
    left = (xs[:, 0:2 * pairs:2] + _XY_CEIL) >> _XY_SHIFT
    right = xs[:, 1:2 * pairs:2] >> _XY_SHIFT
    live = (np.arange(pairs)[None] < (on.sum(axis=1) // 2)[:, None]) & (left < w) & (right >= 0)
    starts = np.broadcast_to(rows, left.shape)[live] * w + np.clip(left[live], 0, w - 1)
    lens = np.maximum(np.clip(right[live], 0, w - 1) + 1 - np.clip(left[live], 0, w - 1), 0)
    ends = np.cumsum(lens)
    flat = np.arange(ends[-1] if len(ends) else 0) + np.repeat(starts - (ends - lens), lens)
    np.put(mask, flat, 1)


def fill_poly(mask: np.ndarray, polygons: Sequence[np.ndarray]) -> np.ndarray:
    """``cv2.fillPoly(mask, polygons, 1)`` (8-connected, shift 0) for
    (n, 2) integer vertex arrays, into ``mask`` in place."""
    edges: List[Tuple[int, int, int, int]] = []
    for pts in polygons:
        _collect_edges(mask, np.asarray(pts, np.int64).reshape(-1, 2), edges)
    if len(edges) >= 2:
        _fill_edges(mask, edges)
    return mask


# ---------------------------------------------------------------- parsing
def poly_to_mask(polygons: Sequence[Sequence[float]], height: int, width: int) -> np.ndarray:
    """Rasterise COCO polygons ([x0, y0, x1, y1, ...] lists) to a binary
    mask; vertices are rounded by ``np.round``, parts under 3 points are
    skipped."""
    mask = np.zeros((height, width), dtype=np.uint8)
    pts = [np.asarray(p, dtype=np.float64).reshape(-1, 2).round().astype(np.int32)
           for p in polygons if len(p) >= 6]
    if pts:
        fill_poly(mask, pts)
    return mask


def segm_to_mask(segmentation, height: int, width: int) -> np.ndarray:
    """COCO 'segmentation' field (polygons or RLE) -> (H, W) uint8 mask."""
    if isinstance(segmentation, list):
        return poly_to_mask(segmentation, height, width)
    if isinstance(segmentation, dict):
        return rle_decode(segmentation)
    raise TypeError(f"unsupported segmentation type {type(segmentation)}")


def mask_parse(annotation: Dict, gt_masks: List, gt_mask_polys: List, gt_poly_lens: List,
               img_height: int, img_width: int) -> None:
    """Append an annotation's mask and its valid polygons to the
    accumulators."""
    segm = annotation["segmentation"]
    gt_masks.append(segm_to_mask(segm, img_height, img_width))
    mask_polys = [p for p in segm if len(p) >= 6] if isinstance(segm, list) else []
    gt_mask_polys.append(mask_polys)
    gt_poly_lens.extend(len(p) for p in mask_polys)


# ---------------------------------------------------------------- geometry
def mask_resize(mask: np.ndarray, scale_factor=None, return_scale: bool = False,
                interpolation: str = "nearest"):
    assert mask.ndim == 2
    return img_resize(np.asarray(mask, np.uint8), scale_factor=scale_factor,
                      return_scale=return_scale, interpolation=interpolation)


def mask_flip(mask: np.ndarray, flipped_flag: bool = True, direction: str = "horizontal") -> np.ndarray:
    assert mask.ndim == 2
    mask = np.asarray(mask, np.uint8)
    if not flipped_flag:
        return mask
    return np.flip(mask, 1 if direction == "horizontal" else 0)


def mask_crop(mask: np.ndarray, size_crop: Tuple[int, int], min_w: int = 0, min_h: int = 0) -> np.ndarray:
    assert mask.ndim == 2
    return img_crop(np.asarray(mask, np.uint8), size_crop, min_w=min_w, min_h=min_h)


def mask_pad(mask: np.ndarray, expected_shape: Tuple[int, int], pad_val=0) -> np.ndarray:
    assert mask.ndim == 2
    return img_pad(np.asarray(mask, np.uint8), expected_shape, pad_val=pad_val)


# ---------------------------------------------------------------- visualize
def blend_weighted(src1: np.ndarray, alpha: float, src2: np.ndarray, beta: float) -> np.ndarray:
    """``cv2.addWeighted(src1, alpha, src2, beta, 0)`` on uint8: the float32
    ``src2 * beta`` rounded, then ``src1 * alpha`` added with one rounding to
    float32, then rounded half to even and saturated. Another dtype is
    blended in float64."""
    if src1.dtype != np.uint8:
        return (src1 * alpha + src2 * beta).astype(src1.dtype)
    a, b = np.float32(alpha), np.float32(beta)
    t = src1.astype(np.float64) * float(a) + (src2.astype(np.float32) * b).astype(np.float64)
    return np.clip(np.rint(t.astype(np.float32)), 0, 255).astype(np.uint8)


def mask_visualize(
    img_array: np.ndarray,
    masks: np.ndarray,
    inds: Optional[np.ndarray],
    mask_color=(0, 255, 0),
    alpha: float = 0.5,
    out_file: Optional[str] = None,
) -> np.ndarray:
    """Overlay (n, H, W) masks on a uint8 image with opacity ``alpha``;
    returns the blended image (``img_array`` is not changed). The reference
    fills the masks' contours (``cv2.findContours`` with ``RETR_TREE``, then
    ``cv2.fillPoly`` of every contour): that paints exactly each mask's
    nonzero pixels after ``astype(uint8)``, holes left open by the even-odd
    fill of their own contours (held to cv2 in
    ``tests/test_torch_visualize.py``), so the fill here is the mask
    itself. ``inds`` selects masks when not empty; ``out_file`` writes a
    PNG."""
    from .image import img_write

    if masks.ndim != 3:
        raise ValueError(f"masks must be (n, H, W), got {masks.shape}")
    masks = masks.astype(np.uint8)
    if inds is not None and len(inds) > 0:
        masks = masks[inds, ...]
    overlay = img_array.copy()
    if len(masks):
        overlay[masks.any(axis=0)] = mask_color
    out = blend_weighted(overlay, alpha, img_array, 1 - alpha)
    if out_file is not None:
        img_write(out, out_file)
    return out
