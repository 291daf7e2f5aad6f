"""The port's JPEG decoder against ``cv2.imread(path, IMREAD_COLOR)``, bit for bit.

Files written by ``cv2.imwrite`` (libjpeg-turbo) at qualities 50-100, each
sampling, gray, restart intervals, COCO's and VOC's sizes and odd sizes;
EXIF orientations 1-8 spliced into APP1 in either byte order; the colour
space rules of three components (JFIF, Adobe's transform flag, component ids
``RGB``); the committed fixtures against their manifest and cv2; the
refusals by kind, a truncated file, a failed build; ``img_read`` against the
reference's.
"""

import hashlib
import json
import os
import struct
import threading

import cv2
import numpy as np
import pytest

from torch_detection_tpu.data.ops import image as jax_image
from torch_detection_tpu_torch import native
from torch_detection_tpu_torch.data.ops import image
from torch_detection_tpu_torch.data.ops.jpeg import (apply_orientation, exif_orientation,
                                                     jpeg_decode)

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440}
# (width, height): COCO's landscape and square sizes, VOC's, a portrait
SIZES = ((640, 480), (640, 427), (500, 375), (612, 612), (500, 333), (375, 500))
ODD = ((1, 1), (2, 3), (5, 2), (17, 31), (31, 17), (333, 501))


def _synthetic(seed, h, w, noise=6.0):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    (x + y) * 127 / max(w + h - 2, 1)], -1)
    for _ in range(4):
        y0, x0 = int(rng.integers(0, h)), int(rng.integers(0, w))
        img[y0:y0 + int(rng.integers(1, h + 1)), x0:x0 + int(rng.integers(1, w + 1))] = \
            rng.uniform(0, 255, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _write(tmp_path, img, name="f.jpg", quality=95, sampling="420", restart=0, prefix=b""):
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, restart])
    assert ok
    data = buf.tobytes()
    data = data[:2] + prefix + data[2:]
    path = tmp_path / name
    path.write_bytes(data)
    return str(path), data


def _assert_cv2(path, data):
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = jpeg_decode(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    bad = np.argwhere(got != want)
    assert bad.size == 0, f"{len(bad)} values differ, first at {bad[:4].tolist()}"


@pytest.mark.parametrize("quality", (50, 75, 90, 95, 100))
@pytest.mark.parametrize("sampling", tuple(SAMPLING))
def test_each_quality_and_sampling_equals_cv2(tmp_path, quality, sampling):
    path, data = _write(tmp_path, _synthetic(quality, 61, 83), quality=quality, sampling=sampling)
    _assert_cv2(path, data)


@pytest.mark.parametrize("quality", (50, 95))
@pytest.mark.parametrize("restart", (0, 1, 7))
def test_gray_and_restart_intervals_equal_cv2(tmp_path, quality, restart):
    img = _synthetic(restart, 45, 70)
    for name, pixels in (("gray.jpg", img[..., 1]), ("color.jpg", img)):
        path, data = _write(tmp_path, pixels, name, quality=quality, restart=restart)
        _assert_cv2(path, data)


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_coco_and_voc_sizes_equal_cv2(tmp_path, size):
    w, h = size
    for sampling in ("420", "444"):
        path, data = _write(tmp_path, _synthetic(w + h, h, w), quality=90, sampling=sampling)
        _assert_cv2(path, data)


@pytest.mark.parametrize("size", ODD, ids=lambda s: f"{s[0]}x{s[1]}")
def test_odd_sizes_equal_cv2(tmp_path, size):
    """Widths of one and two chroma samples take the box upsampler, wider
    ones the triangle filter; partial MCUs at both edges."""
    w, h = size
    for sampling in SAMPLING:
        path, data = _write(tmp_path, _synthetic(w * h, h, w), sampling=sampling, restart=3)
        _assert_cv2(path, data)


def _exif(orientation, order):
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 2)
            + struct.pack(e + "HHII", 0x010F, 2, 4, 0)  # a tag before the orientation
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0" + struct.pack(e + "I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientations_equal_cv2(tmp_path, orientation):
    img = _synthetic(orientation, 37, 53)
    for order in ("II", "MM"):
        path, data = _write(tmp_path, img, f"o{order}.jpg", prefix=_exif(orientation, order))
        _assert_cv2(path, data)
        assert exif_orientation(_exif(orientation, order)[4:]) == orientation
    upright = jpeg_decode(_write(tmp_path, img, "plain.jpg")[1])
    want_shape = upright.shape[1::-1] if orientation >= 5 else upright.shape[:2]
    assert jpeg_decode(data).shape[:2] == want_shape


def test_orientation_outside_1_to_8_and_bad_app1_leave_the_image(tmp_path):
    img = _synthetic(9, 20, 30)
    for prefix in (_exif(0, "II"), _exif(9, "MM"),
                   b"\xff\xe1\x00\x0ahttp:/\x00\x00"):  # an APP1 that is not EXIF
        path, data = _write(tmp_path, img, prefix=prefix)
        _assert_cv2(path, data)
    assert np.array_equal(apply_orientation(img, 9), img)


def _strip_jfif(data: bytes) -> bytes:
    assert data[2:4] == b"\xff\xe0"
    (length,) = struct.unpack(">H", data[4:6])
    return data[:2] + data[4 + length:]


def _set_ids(data: bytes, ids: bytes) -> bytes:
    out = bytearray(data)
    sof, sos = out.find(b"\xff\xc0"), out.find(b"\xff\xda")
    for k, cid in enumerate(ids):
        out[sof + 10 + 3 * k] = cid
        out[sos + 5 + 2 * k] = cid
    return bytes(out)


@pytest.mark.parametrize("case", ("ids_rgb", "ids_rgb_with_jfif", "adobe_0", "adobe_1", "adobe_2",
                                  "ids_unknown"))
def test_colour_space_rules_equal_cv2(tmp_path, case):
    """JFIF means YCbCr; else Adobe's transform flag (0 RGB, 1 YCbCr, other
    values YCbCr); else ids 'R', 'G', 'B' mean RGB and others YCbCr."""
    img = _synthetic(5, 33, 47)
    _, data = _write(tmp_path, img, sampling="444")
    if case == "ids_rgb":
        data = _set_ids(_strip_jfif(data), b"RGB")
    elif case == "ids_rgb_with_jfif":
        data = _set_ids(data, b"RGB")
    elif case == "ids_unknown":
        data = _set_ids(_strip_jfif(data), b"\x07\x08\x09")
    else:
        payload = b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([int(case[-1])])
        data = data[:2] + b"\xff\xee" + struct.pack(">H", len(payload) + 2) + payload + \
            _strip_jfif(data)[2:]
    path = tmp_path / "cs.jpg"
    path.write_bytes(data)
    _assert_cv2(str(path), data)


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_committed_fixtures_match_their_manifest_and_cv2(name):
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        data = f.read()
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    assert list(want.shape) == entry["shape"]
    assert hashlib.sha256(want.tobytes()).hexdigest() == entry["sha256"]
    if entry["refused"]:
        with pytest.raises(ValueError, match=entry["refused"]):
            jpeg_decode(data)
        return
    got = jpeg_decode(data)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256"]


def _patched_sof(tmp_path, marker=None, precision=None, components=None):
    _, data = _write(tmp_path, _synthetic(3, 16, 16), sampling="444")
    out = bytearray(data)
    sof = out.find(b"\xff\xc0")
    if marker is not None:
        out[sof + 1] = marker
    if precision is not None:
        out[sof + 4] = precision
    if components is not None:
        out[sof + 9] = components
    return bytes(out)


@pytest.mark.parametrize("marker, kind", [(0xC2, "progressive"), (0xC3, "lossless"),
                                          (0xC5, "differential"), (0xC9, "arithmetic"),
                                          (0xCA, "arithmetic-coded progressive"),
                                          (0xCB, "arithmetic-coded lossless")])
def test_refused_kinds_are_named(tmp_path, marker, kind):
    with pytest.raises(ValueError, match=kind):
        jpeg_decode(_patched_sof(tmp_path, marker=marker))


def test_refusals_of_precision_components_and_sampling(tmp_path):
    with pytest.raises(ValueError, match="12-bit"):
        jpeg_decode(_patched_sof(tmp_path, precision=12))
    with pytest.raises(ValueError, match="four-component"):
        jpeg_decode(_patched_sof(tmp_path, components=4))
    img = _synthetic(4, 32, 48)
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411])
    with pytest.raises(ValueError, match="sampling factors 4x1,1x1,1x1"):
        jpeg_decode(buf.tobytes())
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive"):
        jpeg_decode(buf.tobytes())


def test_truncated_and_corrupt_streams_raise_ioerror(tmp_path):
    """libjpeg would warn and fill with grey; the port raises."""
    _, data = _write(tmp_path, _synthetic(6, 64, 64), quality=90, restart=2)
    for cut in (len(data) // 2, len(data) - 40):
        with pytest.raises(IOError, match="premature end"):
            jpeg_decode(data[:cut])
    rst = data.find(b"\xff\xd1")
    with pytest.raises(IOError, match="restart marker"):
        jpeg_decode(data[:rst + 1] + b"\xd5" + data[rst + 2:])
    with pytest.raises(IOError, match="not a JPEG"):
        jpeg_decode(b"\x89PNG" + data[4:])
    # the EOI alone missing: every bit is there, so the image equals cv2's
    assert np.array_equal(jpeg_decode(data[:-2]),
                          cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR))


def test_img_read_equals_the_reference(tmp_path):
    img = _synthetic(7, 75, 101)
    path, _ = _write(tmp_path, img, "r.jpeg", prefix=_exif(6, "II"))
    for mode in ("rgb", "bgr"):
        assert np.array_equal(image.img_read(path, mode), jax_image.img_read(path, mode))
    for name in ("landscape_500x333_0.jpg", "gray_45x61.jpg", "exif_orientation_8.jpg"):
        path = os.path.join(FIXTURES, name)
        assert np.array_equal(image.img_read(path), jax_image.img_read(path))


def test_threads_decode_in_parallel_to_the_same_pixels(tmp_path):
    _, data = _write(tmp_path, _synthetic(8, 96, 128), quality=90)
    want = jpeg_decode(data)
    results = [None] * 4

    def work(i):
        results[i] = [jpeg_decode(data) for _ in range(3)]

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(np.array_equal(r, want) for rs in results for r in rs)


def test_build_without_gpp_or_with_a_failing_compile_raises(tmp_path, monkeypatch):
    """No fallback: the build raises with the compiler's log."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.build("jpeg")
    monkeypatch.undo()
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SRC", tmp_path)
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for native/broken.cpp"):
        native.build("broken")
