"""Host-side image ops (numpy, torch on the CPU).

Counterpart of ``torch_detection_tpu/data/ops/image.py`` without OpenCV:

* ``img_read`` decodes PNG itself (zlib and numpy: 8-bit gray, RGB or RGBA,
  not interlaced, all five row filters) and hands JPEG to cv2, imported
  when a JPEG is read; each format has one decoder and no fallback;
* ``img_resize`` resizes bilinearly with ``torch.nn.functional.interpolate``
  (``align_corners=False``, no antialias) on a float32 CPU tensor, the
  sampling of ``cv2.resize(..., INTER_LINEAR)``; a uint8 image is rounded
  back to uint8, within one grey level of cv2's 11-bit fixed-point weights.
  ``interpolation="nearest"`` (the masks') is cv2's ``INTER_NEAREST``
  exactly: source index ``floor(i / (new / old))`` in doubles, clamped;
* sizes, flips, pads and the aspect-ratio flag are numpy copies, so
  ``img_shape``, ``pad_shape`` and ``scale_factor`` are the reference's
  exactly.

Randomness comes from an injected ``np.random.Generator``.
"""

from __future__ import annotations

import os.path as osp
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ...utils.misc import file_is_exist, is_str

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


def _jpeg_decode_bgr(img_path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError as e:
        raise ImportError(f"reading the JPEG {img_path} needs OpenCV (pip install "
                          "opencv-python); PNG needs nothing") from e
    img = cv2.imread(img_path, cv2.IMREAD_COLOR)
    if img is None:
        raise IOError(f"cv2 failed to decode {img_path}")
    return img


def img_read(img_path: str, img_mode: str = "rgb") -> np.ndarray:
    """Read an image as HWC uint8 with three channels, RGB unless
    ``img_mode='bgr'``, as ``cv2.imread(path, IMREAD_COLOR)`` does: gray
    repeats to three channels, alpha is dropped. ``.png`` is decoded here,
    ``.jpg``/``.jpeg`` by cv2; any other extension raises."""
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
        img = _jpeg_decode_bgr(img_path)
        return np.ascontiguousarray(img[..., ::-1] if img_mode == "rgb" else img)
    raise ValueError(f"unsupported image format {ext!r} ({img_path}): PNG or JPEG only")


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
