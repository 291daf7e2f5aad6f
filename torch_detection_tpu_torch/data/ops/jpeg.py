"""JPEG decoding without OpenCV: the pixels of ``cv2.imread(path, IMREAD_COLOR)``.

The entropy decode, the integer IDCT, the upsampling and the colour
conversion are ``native/jpeg.cpp``, built with g++ at first use and called
through ctypes (the call releases the GIL). They follow libjpeg-turbo's
defaults, which OpenCV uses: the "islow" IDCT, fancy upsampling and the
fixed-point YCbCr tables, so a baseline file decodes to cv2's array bit for
bit. The EXIF orientation of the first APP1 segment (1-8) is applied here
with numpy, as ``IMREAD_COLOR`` applies it.

What it decodes: sequential Huffman JPEG, 8-bit, gray or three components
(YCbCr, or RGB by the Adobe flag or the component ids), sampling 4:4:4,
4:2:2, 4:2:0 and 4:4:0, restart intervals. Progressive, arithmetic-coded,
lossless and 12-bit files, four components (CMYK/YCCK) and other sampling
factors raise ``ValueError`` naming the kind.

Where it differs from libjpeg on purpose: a truncated or corrupt entropy
stream (data ending inside a scan, a bad Huffman code, a missing restart
marker) raises ``IOError``, where libjpeg warns, fills the rest of the
image with grey and cv2 returns it.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from ... import native

_ERR_LEN = 512


def _lib() -> ctypes.CDLL:
    lib = native.load("jpeg")
    if not getattr(lib, "_typed", False):
        u8p, i64p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_long)
        lib.td_jpeg_info.argtypes = [ctypes.c_char_p, ctypes.c_long, i64p, ctypes.c_char_p,
                                     ctypes.c_int]
        lib.td_jpeg_info.restype = ctypes.c_int
        lib.td_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_long, u8p, ctypes.c_long,
                                       ctypes.c_long, ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
        lib.td_jpeg_decode.restype = ctypes.c_int
        lib._typed = True
    return lib


def _check(status: int, err: ctypes.Array) -> None:
    if status == 1:
        raise ValueError(err.value.decode())
    if status:
        raise IOError(err.value.decode())


def exif_orientation(app1: bytes) -> int:
    """The orientation tag (0x0112) of IFD0 in an APP1 payload, as OpenCV's
    ``ExifReader`` reads it: the TIFF header 6 bytes in, byte order ``II``
    or ``MM``; 1 when there is none or the payload does not parse."""
    tiff = app1[6:]
    if len(tiff) < 8 or tiff[:2] not in (b"II", b"MM"):
        return 1
    end = "<" if tiff[:2] == b"II" else ">"
    if struct.unpack(end + "H", tiff[2:4])[0] != 0x2A:
        return 1
    (ifd,) = struct.unpack(end + "I", tiff[4:8])
    if ifd + 2 > len(tiff):
        return 1
    (count,) = struct.unpack(end + "H", tiff[ifd:ifd + 2])
    for i in range(count):
        entry = ifd + 2 + 12 * i
        if entry + 12 > len(tiff):
            return 1
        if struct.unpack(end + "H", tiff[entry:entry + 2])[0] == 0x0112:
            return struct.unpack(end + "H", tiff[entry + 8:entry + 10])[0]
    return 1


def apply_orientation(img: np.ndarray, orientation: int) -> np.ndarray:
    """Turn a decoded (H, W, C) image upright for EXIF orientation 1-8, as
    OpenCV's ``ApplyExifOrientation`` does; other values leave it as is."""
    if orientation in (5, 6, 7, 8):
        img = img.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}.get(orientation, ())
    for axis in flips:
        img = np.flip(img, axis)
    return np.ascontiguousarray(img)


def jpeg_decode(data: bytes, rgb: bool = False) -> np.ndarray:
    """A JPEG file's bytes as (H, W, 3) uint8 BGR (RGB with ``rgb``), upright
    by its EXIF orientation: ``cv2.imread(path, IMREAD_COLOR)``'s array."""
    lib = _lib()
    err = ctypes.create_string_buffer(_ERR_LEN)
    info = (ctypes.c_long * 5)()
    _check(lib.td_jpeg_info(data, len(data), info, err, _ERR_LEN), err)
    width, height, _, app1_offset, app1_length = info
    out = np.empty((height, width, 3), np.uint8)
    _check(lib.td_jpeg_decode(data, len(data), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                              width, height, int(rgb), err, _ERR_LEN), err)
    if app1_offset >= 0:
        out = apply_orientation(out, exif_orientation(data[app1_offset:app1_offset + app1_length]))
    return out


def jpeg_read(path: str, rgb: bool = False) -> np.ndarray:
    with open(path, "rb") as f:
        return jpeg_decode(f.read(), rgb)
