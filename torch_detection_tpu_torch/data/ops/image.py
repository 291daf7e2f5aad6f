"""Host-side image ops (numpy, torch on the CPU).

Counterpart of ``torch_detection_tpu/data/ops/image.py`` without OpenCV:

* ``img_read`` decodes PNG itself (zlib and numpy: 8-bit gray, RGB or RGBA,
  not interlaced, all five row filters) and baseline JPEG with the port's
  own decoder (``data/ops/jpeg.py``: libjpeg-turbo's pixels, as cv2 gives
  them); each format has one decoder and no fallback;
* ``img_resize`` resizes bilinearly with ``torch.nn.functional.interpolate``
  (``align_corners=False``, no antialias) on a float32 CPU tensor, the
  sampling of ``cv2.resize(..., INTER_LINEAR)``; a uint8 image is rounded
  back to uint8, within one grey level of cv2's 11-bit fixed-point weights.
  ``interpolation="nearest"`` (the masks') is cv2's ``INTER_NEAREST``
  exactly: source index ``floor(i / (new / old))`` in doubles, clamped;
* sizes, flips, pads and the aspect-ratio flag are numpy copies, so
  ``img_shape``, ``pad_shape`` and ``scale_factor`` are the reference's
  exactly;
* ``img_write`` encodes PNG itself (zlib, unfiltered rows), and
  ``img_rotate`` is ``cv2.warpAffine``'s bilinear sampling with a constant
  border: on uint8 images within one grey level of OpenCV 5's, a pixel in
  thousands one level apart (``tests/test_torch_visualize.py``).

Randomness comes from an injected ``np.random.Generator``.
"""

from __future__ import annotations

import math
import os
import os.path as osp
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.misc import file_is_exist, is_str
from .jpeg import jpeg_read

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> samples a pixel: gray, RGB, RGBA


# ---------------------------------------------------------------- io
def _unfilter_average(line: bytes, prior: bytes, bpp: int) -> bytes:
    out = bytearray(line)
    for x in range(len(out)):
        left = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((left + prior[x]) >> 1)) & 0xFF
    return bytes(out)


def _unfilter_paeth(line: bytes, prior: bytes, bpp: int) -> bytes:
    out = bytearray(line)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        out[x] = (out[x] + (a if pa <= pb and pa <= pc else b if pb <= pc else c)) & 0xFF
    return bytes(out)


def png_decode(data: bytes) -> np.ndarray:
    """An 8-bit, non-interlaced gray, RGB or RGBA PNG as (H, W, C) uint8 in
    the file's channel order. Sub and Up rows are unfiltered with numpy,
    Average and Paeth rows along the row in Python."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, color type {color}, interlace "
                         f"{interlace} (8-bit gray, RGB or RGBA without interlace only)")
    bpp = _PNG_CHANNELS[color]
    stride = w * bpp
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {h * (stride + 1)}")
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum along the row, per channel, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(line.tobytes(), prior.tobytes(), bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(line.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out.reshape(h, w, bpp)


def img_read(img_path: str, img_mode: str = "rgb") -> np.ndarray:
    """Read an image as HWC uint8 with three channels, RGB unless
    ``img_mode='bgr'``, as ``cv2.imread(path, IMREAD_COLOR)`` does: gray
    repeats to three channels, alpha is dropped, a JPEG's EXIF orientation
    is applied. ``.png`` and ``.jpg``/``.jpeg`` are decoded by the port; any
    other extension raises."""
    if not is_str(img_path):
        raise TypeError("image path must be a string")
    if not file_is_exist(img_path):
        raise FileNotFoundError(f"{img_path} does not exist")
    if img_mode not in ("rgb", "bgr"):
        raise ValueError(f"img_mode must be 'rgb' or 'bgr', got {img_mode!r}")
    ext = osp.splitext(img_path)[1].lower()
    if ext == ".png":
        with open(img_path, "rb") as f:
            img = png_decode(f.read())
        img = np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img[..., :3]
        return np.ascontiguousarray(img if img_mode == "rgb" else img[..., ::-1])
    if ext in (".jpg", ".jpeg"):
        return jpeg_read(img_path, rgb=img_mode == "rgb")
    raise ValueError(f"unsupported image format {ext!r} ({img_path}): PNG or JPEG only")


def png_encode(img: np.ndarray) -> bytes:
    """An (H, W) gray or (H, W, 3|4) RGB(A) uint8 image as an 8-bit PNG,
    every row unfiltered."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3
                                                         and img.shape[2] not in (1, 3, 4)):
        raise ValueError(f"PNG takes (H, W) or (H, W, 1|3|4) uint8, not {img.shape} {img.dtype}")
    img = img.reshape(img.shape[0], img.shape[1], -1)
    h, w, c = img.shape
    color = {1: 0, 3: 2, 4: 6}[c]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * c)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def img_write(img: np.ndarray, file_path: str, auto_mkdir: bool = True,
              img_mode: str = "rgb") -> None:
    """Write an HWC uint8 image as a PNG; ``img_mode`` names ``img``'s
    channel order (a ``bgr`` image is stored as RGB), as the reference's
    ``cv2.imwrite`` round trip. Only ``.png`` is written: another extension
    raises ``ValueError`` naming it."""
    if img_mode not in ("rgb", "bgr"):
        raise ValueError(f"img_mode must be 'rgb' or 'bgr', got {img_mode!r}")
    ext = osp.splitext(file_path)[1].lower()
    if ext != ".png":
        raise ValueError(f"img_write writes PNG only, not {ext!r} ({file_path})")
    if auto_mkdir:
        os.makedirs(osp.dirname(osp.abspath(file_path)), exist_ok=True)
    if img_mode == "bgr" and img.ndim == 3 and img.shape[2] >= 3:
        img = np.concatenate([img[..., 2::-1], img[..., 3:]], axis=2)
    with open(file_path, "wb") as f:
        f.write(png_encode(np.ascontiguousarray(img)))


# ---------------------------------------------------------------- normalize
def img_normalize(img: np.ndarray, img_mean, img_std) -> np.ndarray:
    mean = np.asarray(img_mean, dtype=np.float64)
    std = np.asarray(img_std, dtype=np.float64)
    return ((img - mean) / std).astype(np.float32)


# ---------------------------------------------------------------- resize
def rescale_size(old_size: Tuple[int, int], scale) -> Tuple[Tuple[int, int], float]:
    """The (h, w) after a keep-ratio rescale and the scale factor. ``scale``
    is an int (short-edge target), a (long, short) tuple (cap both edges)
    or a float factor."""
    h, w = old_size
    if isinstance(scale, (float, np.floating)):
        scale_factor = float(scale)
    elif isinstance(scale, (int, np.integer)):
        scale_factor = scale / min(h, w)
    elif isinstance(scale, tuple):
        scale_factor = min(min(scale) / min(h, w), max(scale) / max(h, w))
    else:
        raise TypeError(f"scale must be float/int/tuple, got {type(scale)}")
    new_h = int(np.round(h * scale_factor))
    new_w = int(np.round(w * scale_factor))
    return (new_h, new_w), scale_factor


def resize_bilinear(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """(H, W[, C]) -> (new_h, new_w[, C]) by half-pixel bilinear sampling in
    float32; uint8 images are rounded to nearest and clipped."""
    x = torch.from_numpy(np.ascontiguousarray(img)).to(torch.float32)
    x = x.permute(2, 0, 1)[None] if img.ndim == 3 else x[None, None]
    y = F.interpolate(x, size=(new_h, new_w), mode="bilinear", align_corners=False,
                      antialias=False)[0]
    out = (y.permute(1, 2, 0) if img.ndim == 3 else y[0]).numpy()
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype, copy=False)


def resize_nearest(img: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """(H, W[, C]) -> (new_h, new_w[, C]) as ``cv2.resize(..., INTER_NEAREST)``
    picks its pixels: output pixel i reads source pixel
    ``min(floor(i * (1 / (new / old))), old - 1)`` along each axis, the scale
    and its inverse in doubles as cv2 computes them."""
    h, w = img.shape[:2]
    if (new_h, new_w) == (h, w):
        return img.copy()
    sy = np.minimum(np.floor(np.arange(new_h) * (1.0 / (new_h / h))).astype(np.int64), h - 1)
    sx = np.minimum(np.floor(np.arange(new_w) * (1.0 / (new_w / w))).astype(np.int64), w - 1)
    return np.take(img, sx, axis=1)[sy]  # the narrower gather first


_RESIZERS = {"bilinear": resize_bilinear, "nearest": resize_nearest}


def img_resize(
    img: np.ndarray,
    size=None,
    scale_factor=None,
    return_scale: bool = False,
    interpolation: str = "bilinear",
    rng: Optional[np.random.Generator] = None,
):
    """Resize by target ``size`` (int short-edge or (long, short) caps) or by
    ``scale_factor`` (float, or a sequence to sample from via ``rng``).
    Bilinear or nearest."""
    if (size is None) == (scale_factor is None):
        raise ValueError("exactly one of size / scale_factor must be given")
    if interpolation not in _RESIZERS:
        raise NotImplementedError(f"interpolation {interpolation!r} is not ported "
                                  "(bilinear and nearest only)")
    h, w = img.shape[:2]
    if size is not None:
        if not return_scale:
            raise ValueError("must return scale_factor when resizing by size")
        (new_h, new_w), sf = rescale_size((h, w), size)
    else:
        if isinstance(scale_factor, (tuple, list)):
            rand = rng if rng is not None else np.random.default_rng()
            scale_factor = float(rand.choice(scale_factor))
        (new_h, new_w), sf = rescale_size((h, w), float(scale_factor))
    resized = _RESIZERS[interpolation](img, new_h, new_w)
    if return_scale:
        return resized, sf
    return resized


# ---------------------------------------------------------------- flip
def img_flip(
    img: np.ndarray,
    flip_prob: float = 0.0,
    direction: str = "horizontal",
    rng: Optional[np.random.Generator] = None,
):
    """Randomly flip; returns (img, flipped_flag, direction)."""
    assert direction in ("horizontal", "vertical")
    assert 0.0 <= flip_prob <= 1.0
    rand = rng if rng is not None else np.random.default_rng()
    flipped = flip_prob > 0 and float(rand.random()) < flip_prob
    if flipped:
        img = np.flip(img, 1 if direction == "horizontal" else 0)
    return img, flipped, direction


def img_denormalize(img: np.ndarray, img_mean, img_std) -> np.ndarray:
    """``img * std + mean`` in float64, ``img_normalize``'s inverse."""
    mean = np.asarray(img_mean, dtype=np.float64)
    std = np.asarray(img_std, dtype=np.float64)
    return np.asarray(img * std + mean)


# ---------------------------------------------------------------- rotate
def _rotation_matrix(center: Tuple[float, float], angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D``: (2, 3), counter-clockwise by ``angle``
    degrees about ``center`` (x, y)."""
    a = math.radians(angle)
    alpha, beta = math.cos(a) * scale, math.sin(a) * scale
    cx, cy = center
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform``, in its order of operations."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]], np.float64)


def _warp_affine_bilinear(img: np.ndarray, matrix: np.ndarray, size: Tuple[int, int],
                         border_value=0) -> np.ndarray:
    """``cv2.warpAffine(img, matrix, size=(w, h), INTER_LINEAR,
    BORDER_CONSTANT, border_value)``: each output pixel samples the source at
    the inverse map of its centre (float64), bilinearly from its four
    neighbours in float32 (``lerp`` along x, then along y), a neighbour
    outside the source taking the border value; uint8 is rounded half to
    even. A scalar ``border_value`` is cv2's ``Scalar(v)``: ``v`` in the
    first channel, 0 in the others."""
    w, h = size
    inv = _invert_affine(np.asarray(matrix, np.float64))
    ys, xs = np.mgrid[:h, :w].astype(np.float64)
    sx = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
    sy = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
    x0, y0 = np.floor(sx), np.floor(sy)
    ax = (sx - x0).astype(np.float32)[..., None]
    ay = (sy - y0).astype(np.float32)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    src = img.reshape(img.shape[0], img.shape[1], -1).astype(np.float32)
    sh, sw, c = src.shape
    border = np.zeros(c, np.float32)
    values = np.asarray(border_value, np.float32).reshape(-1)[:c]
    border[:len(values)] = values

    def tap(dx: int, dy: int) -> np.ndarray:
        x, y = x0 + dx, y0 + dy
        inside = (x >= 0) & (x < sw) & (y >= 0) & (y < sh)
        v = src[np.clip(y, 0, sh - 1), np.clip(x, 0, sw - 1)]
        return np.where(inside[..., None], v, border)

    v00, v01, v10, v11 = tap(0, 0), tap(1, 0), tap(0, 1), tap(1, 1)
    top = v00 + ax * (v01 - v00)
    out = top + ay * (v10 + ax * (v11 - v10) - top)
    if img.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255)
    return out.astype(img.dtype).reshape((h, w) + img.shape[2:])


def img_rotate(
    img: np.ndarray,
    angle: float,
    center: Optional[Tuple[float, float]] = None,
    scale: float = 1.0,
    border_value=0,
    auto_bound: bool = False,
) -> np.ndarray:
    """Rotate clockwise by ``angle`` degrees about ``center`` (default the
    image's centre, ((w - 1) / 2, (h - 1) / 2)), bilinearly with a constant
    border (``_warp_affine_bilinear``); ``auto_bound`` grows the canvas to
    hold the whole rotated image."""
    if center is not None and auto_bound:
        raise ValueError("auto_bound conflicts with an explicit center")
    h, w = img.shape[:2]
    if center is None:
        center = ((w - 1) * 0.5, (h - 1) * 0.5)
    matrix = _rotation_matrix(center, -angle, scale)
    if auto_bound:
        cos, sin = abs(matrix[0, 0]), abs(matrix[0, 1])
        new_w, new_h = h * sin + w * cos, h * cos + w * sin
        matrix[0, 2] += (new_w - w) * 0.5
        matrix[1, 2] += (new_h - h) * 0.5
        w, h = int(np.round(new_w)), int(np.round(new_h))
    return _warp_affine_bilinear(img, matrix, (w, h), border_value)


# ---------------------------------------------------------------- crop
def img_crop(img: np.ndarray, size_crop: Tuple[int, int], min_w: int = 0, min_h: int = 0) -> np.ndarray:
    """Crop a (width, height) = ``size_crop`` window anchored at (min_w, min_h)."""
    assert isinstance(size_crop, tuple) and len(size_crop) == 2
    assert min_w >= 0 and min_h >= 0
    cw, ch = size_crop
    h, w = img.shape[:2]
    assert min_h + ch <= h and min_w + cw <= w, "crop window exceeds image bounds"
    return img[min_h: min_h + ch, min_w: min_w + cw, ...]


# ---------------------------------------------------------------- pad
def img_pad(img: np.ndarray, expected_shape: Tuple[int, ...], pad_val=0) -> np.ndarray:
    """Pad bottom/right to ``expected_shape`` (H, W[, C]) with ``pad_val``."""
    if not isinstance(pad_val, (int, float)):
        assert len(pad_val) == img.shape[-1]
    if len(expected_shape) < img.ndim:
        expected_shape = tuple(expected_shape) + (img.shape[-1],)
    assert len(expected_shape) == img.ndim
    assert all(e >= s for e, s in zip(expected_shape, img.shape))
    padded = np.empty(expected_shape, dtype=img.dtype)
    padded[...] = pad_val
    padded[: img.shape[0], : img.shape[1], ...] = img
    return padded


def img_pad_size_divisor(img: np.ndarray, size_divisor: int, pad_val=0) -> np.ndarray:
    """Pad so H and W are multiples of ``size_divisor``."""
    assert isinstance(size_divisor, int) and size_divisor >= 1
    return img_pad(img, pad_shape_divisor(img.shape[:2], size_divisor), pad_val=pad_val)


def pad_shape_divisor(shape: Tuple[int, int], size_divisor: int) -> Tuple[int, int]:
    h, w = shape
    return (
        int(np.ceil(h / size_divisor) * size_divisor),
        int(np.ceil(w / size_divisor) * size_divisor),
    )


# ---------------------------------------------------------------- aspect ratio
def img_aspect_ratio(width: Union[int, float], height: Union[int, float]) -> float:
    return width / float(height)


def img_aspect_ratio_flag(width: Union[int, float], height: Union[int, float]) -> int:
    """1 for landscape (w/h > 1) else 0: the grouping key of the samplers."""
    return int(img_aspect_ratio(width, height) > 1)
