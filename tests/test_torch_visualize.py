"""The port's visualiser against the JAX package's cv2 one.

``bbox_visualize`` must give the reference's pixels bit for bit outside the
label text (the reference draws Hershey text, the port a bitmap font of its
own; each label's box from ``cv2.getTextSize`` and the port's
``text_size`` is left out), ``mask_visualize`` bit for bit everywhere, on
noise masks, masks with holes and discs, at two opacities. ``img_write``
round-trips through ``img_read``; ``img_rotate`` stays within one grey
level of the reference's ``cv2.warpAffine`` on uint8 images (at most 1% of
the pixels a level apart) and within 4e-3 on float32 ones of values up to
85; ``img_denormalize`` and ``bbox_normalize``/``bbox_denormalize`` equal
the reference's. ``tools.visualize`` draws a tiny Faster R-CNN's boxes and
a tiny Mask R-CNN's masks on the CPU.
"""

import os

import cv2
import numpy as np
import pytest
import torch

from test_torch_data import write_png_coco
from test_torch_segm_eval import _write_mask_config
from test_torch_tools import _write_config
from torch_detection_tpu.data.ops import bbox as jax_bbox
from torch_detection_tpu.data.ops import image as jax_image
from torch_detection_tpu.data.ops import mask as jax_mask
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.data.ops import bbox, image, mask
from torch_detection_tpu_torch.engine.checkpoint import save_checkpoint
from torch_detection_tpu_torch.tools import visualize as visualize_cli
from torch_detection_tpu_torch.utils.config import Config

JPEG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_jpeg",
                    "landscape_640x480_0.jpg")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _label_boxes(h, w, boxes, labels, names=None):
    """Where either font may have drawn a label: the union of cv2's and the
    port's text boxes at each label's origin, with a margin."""
    out = np.zeros((h, w), bool)
    for b, label in zip(boxes, labels):
        x, y = int(b[0]), int(b[1]) - 2
        text = bbox.box_label(int(label), float(b[4]) if len(b) > 4 else None, names)
        (tw, th), base = cv2.getTextSize(text, cv2.FONT_HERSHEY_COMPLEX, 0.5, 1)
        pw, ph = bbox.text_size(text)
        out[max(y - max(th, ph) - 3, 0):max(y + base + 3, 0),
            max(x - 2, 0):max(x + max(tw, pw) + 3, 0)] = True
    return out


@pytest.mark.parametrize("seed", range(4))
def test_bbox_visualize_equals_the_reference_outside_the_labels(seed):
    rng = np.random.default_rng(seed)
    h, w = (int(v) for v in rng.integers(40, 220, 2))
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    n = int(rng.integers(1, 9))
    xy = rng.uniform(-20, 0.8 * min(h, w), (n, 2))  # some past the image's edges
    boxes = np.concatenate([xy, xy + rng.uniform(0, 90, (n, 2)), rng.random((n, 1))],
                           1).astype(np.float32)
    boxes[0, :] = [10.7, 30.2, 35.9, 38.4, 0.95]  # one inside, above the threshold
    labels = rng.integers(0, 80, n)
    names = [f"class_{i}" for i in range(80)] if seed % 2 else None
    thr = 0.3 if seed < 2 else 0.0
    want, want_kept = jax_bbox.bbox_visualize(img.copy(), boxes, labels, class_names=names,
                                              score_thr=thr)
    got, got_kept = bbox.bbox_visualize(img.copy(), boxes, labels, class_names=names,
                                        score_thr=thr)
    np.testing.assert_array_equal(got_kept, want_kept)
    outside = ~_label_boxes(h, w, boxes[want_kept], labels[want_kept], names)
    np.testing.assert_array_equal(got[outside], want[outside])
    drawn = np.any(got != img, axis=-1)
    assert drawn[outside].any() and drawn[~outside].any()  # rectangles and text both drawn


def _masks(rng, kind, n, h, w):
    if kind == "noise":
        return (rng.random((n, h, w)) < 0.4).astype(np.uint8)
    yy, xx = np.mgrid[:h, :w]
    out = np.zeros((n, h, w), np.uint8)
    for k in range(n):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(3, min(h, w) / 2)
        d = np.hypot(yy - cy, xx - cx)
        out[k] = (d < r) & ((d > r / 3) if kind == "holes" else True)
    return out


@pytest.mark.parametrize("kind", ["noise", "holes", "discs"])
@pytest.mark.parametrize("alpha", [0.5, 0.3])
def test_mask_visualize_equals_the_reference(kind, alpha):
    rng = np.random.default_rng(len(kind))
    img = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
    masks = _masks(rng, kind, 3, 70, 90)
    for inds in (None, np.array([0, 2])):
        want = jax_mask.mask_visualize(img, masks, inds, alpha=alpha)
        got = mask.mask_visualize(img, masks, inds, alpha=alpha)
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, img)


def test_img_write_round_trips_and_refuses_other_formats(tmp_path):
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (13, 17, 3)).astype(np.uint8)
    image.img_write(rgb, str(tmp_path / "a" / "rgb.png"))
    np.testing.assert_array_equal(image.img_read(str(tmp_path / "a" / "rgb.png")), rgb)
    image.img_write(rgb[..., ::-1], str(tmp_path / "bgr.png"), img_mode="bgr")
    np.testing.assert_array_equal(image.img_read(str(tmp_path / "bgr.png")), rgb)
    np.testing.assert_array_equal(cv2.imread(str(tmp_path / "bgr.png")), rgb[..., ::-1])
    gray = rgb[..., 0]
    image.img_write(gray, str(tmp_path / "gray.png"))
    np.testing.assert_array_equal(image.img_read(str(tmp_path / "gray.png")),
                                  np.repeat(gray[..., None], 3, axis=2))
    with pytest.raises(ValueError, match="'.jpg'"):
        image.img_write(rgb, str(tmp_path / "x.jpg"))


@pytest.mark.parametrize("auto_bound", [False, True])
def test_img_rotate_within_its_tolerance_of_the_reference(auto_bound):
    rng = np.random.default_rng(int(auto_bound))
    worst, apart, total = 0, 0, 0
    for _ in range(8):
        h, w = (int(v) for v in rng.integers(5, 80, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        kw = dict(angle=float(rng.uniform(-180, 180)), scale=float(rng.choice([1.0, 0.8, 1.2])),
                  border_value=int(rng.choice([0, 9])), auto_bound=auto_bound)
        want, got = jax_image.img_rotate(img, **kw), image.img_rotate(img, **kw)
        assert got.shape == want.shape and got.dtype == np.uint8
        diff = np.abs(got.astype(int) - want)
        worst, apart, total = max(worst, diff.max()), apart + (diff > 0).sum(), total + diff.size
        f = img.astype(np.float32) / 3
        np.testing.assert_allclose(image.img_rotate(f, **kw), jax_image.img_rotate(f, **kw),
                                   rtol=0, atol=4e-3)
    assert worst <= 1 and apart <= 0.01 * total
    with pytest.raises(ValueError, match="auto_bound"):
        image.img_rotate(img, 30, center=(1.0, 1.0), auto_bound=True)


def test_normalizers_equal_the_reference():
    rng = np.random.default_rng(0)
    img = rng.normal(size=(5, 6, 3)).astype(np.float32)
    means, stds = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
    np.testing.assert_array_equal(image.img_denormalize(img, means, stds),
                                  jax_image.img_denormalize(img, means, stds))
    boxes = rng.uniform(0, 50, (7, 4)).astype(np.float32)
    kw = dict(means=(1.0, 2.0, 3.0, 4.0), stds=(0.1, 0.2, 0.3, 0.4))
    np.testing.assert_array_equal(bbox.bbox_normalize(boxes, **kw),
                                  jax_bbox.bbox_normalize(boxes, **kw))
    per_class = rng.uniform(0, 50, (7, 12)).astype(np.float32)
    np.testing.assert_array_equal(bbox.bbox_denormalize(per_class, **kw),
                                  jax_bbox.bbox_denormalize(per_class, **kw))


@pytest.mark.parametrize("segm", [False, True])
def test_visualize_cli_draws_on_the_cpu(tmp_path, segm):
    """``tools.visualize`` on two PNGs and a JPEG: one PNG an image at its
    size, with the detections drawn (``--score-thr 0``: the random weights
    score low)."""
    coco = write_png_coco(tmp_path / "coco")
    write = _write_mask_config if segm else _write_config
    config = write(tmp_path / "cfg.py", coco)
    cfg = Config.fromfile(config)
    model = build_detector(cfg["model"], "float32", "cpu", seed=0)
    save_checkpoint(str(tmp_path / "ckpt"), model)
    pngs = sorted(os.path.join(coco["img_prefix"], f) for f in os.listdir(coco["img_prefix"])
                  if f.endswith(".png"))[:2]
    args = [config, str(tmp_path / "ckpt"), *pngs, JPEG, "--out-dir", str(tmp_path / "vis"),
            "--score-thr", "0", "--device", "cpu"] + (["--segm"] if segm else [])
    written = visualize_cli.main(args)
    assert [os.path.basename(p) for p in written] == [
        os.path.splitext(os.path.basename(p))[0] + ".png" for p in pngs + [JPEG]]
    changed = 0
    for src, out in zip(pngs + [JPEG], written):
        raw, drawn = image.img_read(src), image.img_read(out)
        assert drawn.shape == raw.shape
        changed += int((drawn != raw).any())
    assert changed == len(written)
