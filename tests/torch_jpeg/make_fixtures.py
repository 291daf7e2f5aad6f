"""Write the JPEG fixtures of the port's decoder and their manifest.

    python tests/torch_jpeg/make_fixtures.py

Needs OpenCV: every file but one is written by ``cv2.imwrite`` from a seeded
synthetic image (smooth gradients, filled rectangles, light noise). The
arithmetic-coded file is written here by hand, since cv2 writes Huffman
only: one 8x8 gray block whose DC difference and EOB decisions take the
QM coder's first state, so its entropy-coded segment is empty. The machine
with the GPU has no encoder, so the files are committed.

``manifest.json`` holds, for each file, the shape and sha256 of
``cv2.imread(path, IMREAD_COLOR)``'s array, and for a file the decoder
refuses the kind its error names.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import cv2
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# (width, height) of COCO's and VOC's landscape images, four files a size
LANDSCAPE = ((640, 480), (640, 427), (500, 375), (612, 612), (500, 333))
PER_SIZE = 4
PORTRAIT = (375, 500)
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}


def synthetic(rng: np.random.Generator, h: int, w: int, noise: float = 2.0) -> np.ndarray:
    """(h, w, 3) uint8: per-channel gradients, 3-8 filled rectangles, light noise."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    u, v = 2 * x / max(w - 1, 1) - 1, 2 * y / max(h - 1, 1) - 1  # both in [-1, 1]
    img = np.stack([127.5 + 80 * (np.cos(a) * u + np.sin(a) * v)
                    for a in rng.uniform(0, 2 * np.pi, 3)], -1)
    for _ in range(int(rng.integers(3, 9))):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        x1, y1 = x0 + int(rng.integers(1, max(2, w // 2))), y0 + int(rng.integers(1, max(2, h // 2)))
        img[y0:y1, x0:x1] = rng.uniform(0, 255, 3)
    img += rng.normal(0, noise, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def exif_app1(orientation: int, order: str = "II") -> bytes:
    """An APP1 segment whose IFD0 holds the orientation tag alone."""
    e = "<" if order == "II" else ">"
    tiff = (order.encode() + struct.pack(e + "HI", 42, 8) + struct.pack(e + "H", 1)
            + struct.pack(e + "HHIH", 0x0112, 3, 1, orientation) + b"\0\0" + struct.pack(e + "I", 0))
    payload = b"Exif\0\0" + tiff
    return b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload


def arithmetic_block() -> bytes:
    """An 8x8 gray arithmetic-coded (SOF9) JPEG of one all-zero block."""
    def seg(marker, payload):
        return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload
    dqt = bytes([0]) + bytes([1] * 64)
    sof = bytes([8]) + struct.pack(">HH", 8, 8) + bytes([1, 1, 0x11, 0])
    sos = bytes([1, 1, 0x00, 0, 63, 0])
    return b"\xff\xd8" + seg(0xDB, dqt) + seg(0xC9, sof) + seg(0xDA, sos) + b"\xff\xd9"


def encode(img: np.ndarray, quality: int = 90, sampling: str = "420", restart: int = 0,
           progressive: bool = False) -> bytes:
    ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, quality,
                                         cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling],
                                         cv2.IMWRITE_JPEG_RST_INTERVAL, restart,
                                         cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


def fixtures(rng: np.random.Generator):
    """(name, bytes, refused kind or None) of every fixture."""
    out = []
    for w, h in LANDSCAPE:
        for i in range(PER_SIZE):
            out.append((f"landscape_{w}x{h}_{i}.jpg", encode(synthetic(rng, h, w), quality=88),
                        None))
    w, h = PORTRAIT
    out.append((f"portrait_{w}x{h}.jpg", encode(synthetic(rng, h, w), quality=88), None))
    small = synthetic(rng, 45, 61, noise=6.0)
    out.append(("gray_45x61.jpg", encode(small[..., 0]), None))
    for s in ("444", "422", "420", "440"):
        out.append((f"sampling_{s}_45x61.jpg", encode(small, sampling=s), None))
    for q in (50, 75, 95, 100):
        out.append((f"quality_{q}_45x61.jpg", encode(small, quality=q), None))
    for r in (1, 7):
        out.append((f"restart_{r}_45x61.jpg", encode(small, restart=r), None))
    for w, h in ((1, 1), (17, 31), (333, 501)):
        out.append((f"odd_{w}x{h}.jpg", encode(synthetic(rng, h, w, noise=6.0), sampling="420"),
                    None))
    base = encode(synthetic(rng, 24, 40, noise=6.0))
    for o in range(1, 9):
        out.append((f"exif_orientation_{o}.jpg", base[:2] + exif_app1(o, "MM" if o % 2 else "II")
                    + base[2:], None))
    out.append(("refused_progressive.jpg", encode(small, progressive=True), "progressive"))
    out.append(("refused_arithmetic.jpg", arithmetic_block(), "arithmetic"))
    out.append(("refused_sampling_411.jpg", encode(small, sampling="411"), "sampling"))
    return out


def main() -> None:
    rng = np.random.default_rng(20261017)
    manifest = {}
    for name, data, refused in fixtures(rng):
        path = os.path.join(HERE, name)
        with open(path, "wb") as f:
            f.write(data)
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        manifest[name] = {"shape": list(img.shape),
                          "sha256": hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest(),
                          "refused": refused}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    total = sum(os.path.getsize(os.path.join(HERE, n)) for n in manifest)
    print(f"wrote {len(manifest)} files, {total} bytes")


if __name__ == "__main__":
    main()
