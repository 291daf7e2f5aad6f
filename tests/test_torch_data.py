"""The port's host data tier against the JAX package's.

The PNG decoder against ``cv2.imread`` bit for bit (files written by cv2 at
several compression levels, and files that use one row filter each); the
bilinear resize within one grey level of cv2's; the grouped sampler's order,
the train and test samples of the ``data_fixtures.make_coco`` layout
(written as PNG), ``collate`` and ``collate_test``, ``get_datasets``' fan-out
and the loader's ``skip_batches`` against the reference's. Boxes, labels,
crowd boxes, proposals and every meta field are held exactly; the images,
which both sides resize in float32 with their own libraries, within one
grey level before the normalisation. Nothing here jits.
"""

import json
import os
import struct
import sys
import threading
import zlib

import cv2
import numpy as np
import pytest
import torch

from data_fixtures import make_coco
from torch_detection_tpu.data import DataContainer as JaxDataContainer
from torch_detection_tpu.data import GroupSampler as JaxGroupSampler
from torch_detection_tpu.data import build_dataloader as jax_build_dataloader
from torch_detection_tpu.data import collate as jax_collate
from torch_detection_tpu.data import collate_test as jax_collate_test
from torch_detection_tpu.data import get_datasets as jax_get_datasets
from torch_detection_tpu.data.ops import image as jax_image
from torch_detection_tpu.utils import dump as jax_dump
from torch_detection_tpu_torch.data import (
    CocoDataset,
    ConcatDataset,
    DataContainer,
    GroupSampler,
    build_dataloader,
    collate,
    collate_test,
    get_datasets,
    prefetch_to_device,
)
from torch_detection_tpu_torch.data.ops import image

MEANS, STDS = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


# ---------------------------------------------------------------- PNG
def _png(img: np.ndarray, filter_type: int) -> bytes:
    """An 8-bit PNG of ``img`` (H, W[, C]) with every row filtered by
    ``filter_type`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    h, w = img.shape[:2]
    c = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        cur = x[y]
        up = x[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), up[:-c]])
        if filter_type == 4:
            p = left + up - up_left
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
        else:
            pred = [0 * cur, left, up, (left + up) // 2][filter_type]
        rows.append(bytes([filter_type]) + ((cur - pred) % 256).astype(np.uint8).tobytes())

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    color = {1: 0, 3: 2, 4: 6}[c]
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


def _smooth(rng, shape):
    """A gradient image with noise: cv2's writer picks every filter on it."""
    ramp = np.add.outer(np.arange(shape[0]), 2 * np.arange(shape[1]))
    ramp = ramp.reshape(shape[:2] + (1,) * (len(shape) - 2))
    return ((ramp + rng.integers(0, 9, shape)) % 256).astype(np.uint8)


SHAPES = {"gray": (13, 17), "rgb": (21, 31, 3), "rgba": (9, 11, 4), "rgb_odd": (40, 33, 3)}


@pytest.mark.parametrize("level", (0, 1, 9))
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_png_decoder_equals_cv2_on_cv2_files(tmp_path, kind, level):
    rng = np.random.default_rng(level)
    path = str(tmp_path / f"{kind}.png")
    for img in (rng.integers(0, 256, SHAPES[kind], np.uint8), _smooth(rng, SHAPES[kind])):
        assert cv2.imwrite(path, img, [cv2.IMWRITE_PNG_COMPRESSION, level])
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        got = image.img_read(path, "bgr")
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert np.array_equal(image.img_read(path), jax_image.img_read(path))


@pytest.mark.parametrize("filter_type", range(5))
@pytest.mark.parametrize("kind", ("gray", "rgb_odd", "rgba"))
def test_png_decoder_reads_each_row_filter(tmp_path, kind, filter_type):
    img = _smooth(np.random.default_rng(filter_type), SHAPES[kind])
    data = _png(img, filter_type)
    decoded = image.png_decode(data)
    assert np.array_equal(decoded.reshape(img.shape), img)
    path = tmp_path / "f.png"
    path.write_bytes(data)
    assert np.array_equal(image.img_read(str(path), "bgr"), cv2.imread(str(path)))


def test_img_read_refuses_what_it_does_not_decode(tmp_path, monkeypatch):
    deep = tmp_path / "deep.png"
    assert cv2.imwrite(str(deep), np.full((4, 5, 3), 300, np.uint16))
    with pytest.raises(ValueError, match="bit depth 16"):
        image.img_read(str(deep))
    bmp = tmp_path / "x.bmp"
    assert cv2.imwrite(str(bmp), np.zeros((4, 5, 3), np.uint8))
    with pytest.raises(ValueError, match="PNG or JPEG"):
        image.img_read(str(bmp))
    jpg = tmp_path / "x.jpg"
    assert cv2.imwrite(str(jpg), np.full((8, 8, 3), 77, np.uint8))
    want = jax_image.img_read(str(jpg))
    assert np.array_equal(image.img_read(str(jpg)), want)
    monkeypatch.setitem(sys.modules, "cv2", None)  # an install without OpenCV decodes it too
    assert np.array_equal(image.img_read(str(jpg)), want)
    progressive = tmp_path / "p.jpg"
    progressive.write_bytes(cv2.imencode(".jpg", np.zeros((8, 8, 3), np.uint8),
                                         [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tobytes())
    with pytest.raises(ValueError, match="progressive"):
        image.img_read(str(progressive))


@pytest.mark.parametrize("size", [(1333, 800), (50, 30), (200, 120), 0.37, 2.5])
def test_img_resize_within_one_grey_level(size):
    img = np.random.default_rng(1).integers(0, 256, (60, 100, 3), np.uint8)
    kwargs = dict(scale_factor=size) if isinstance(size, float) else dict(size=size)
    got, sf = image.img_resize(img, return_scale=True, **kwargs)
    want, want_sf = jax_image.img_resize(img, return_scale=True, **kwargs)
    assert got.shape == want.shape and got.dtype == np.uint8 and sf == want_sf
    assert np.abs(got.astype(int) - want).max() <= 1


# ---------------------------------------------------------------- samplers
class _Flags:
    def __init__(self, flag):
        self.flag = np.asarray(flag, np.uint8)

    def __len__(self):
        return len(self.flag)


@pytest.mark.parametrize("seed", (0, 7))
def test_group_sampler_order_equals_the_reference(seed):
    ds = _Flags(np.random.default_rng(seed).integers(0, 2, 23))
    for epoch in (0, 1):
        got, want = GroupSampler(ds, 4, seed=seed), JaxGroupSampler(ds, 4, seed=seed)
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert len(got) == len(want) > len(ds)
        assert list(got) == list(want) and len(list(got)) == len(got)


# ---------------------------------------------------------------- datasets
def write_png_coco(root) -> dict:
    """``make_coco``'s layout under ``root`` (a landscape image with a box
    and a crowd box, a portrait one with a box, one without annotations;
    categories 11 and 13) with PNG files, and a pickle of five scored
    proposals an image: the paths as dataset config keys."""
    ann_file, img_dir = make_coco(str(root), with_mask=False)
    with open(ann_file) as f:
        ann = json.load(f)
    for info in ann["images"]:
        jpg = os.path.join(img_dir, info["file_name"])
        info["file_name"] = info["file_name"].replace(".jpg", ".png")
        assert cv2.imwrite(os.path.join(img_dir, info["file_name"]), cv2.imread(jpg))
    png_ann = os.path.join(str(root), "ann_png.json")
    with open(png_ann, "w") as f:
        json.dump(ann, f)
    rng = np.random.default_rng(3)
    proposals = []
    for _ in sorted(ann["images"], key=lambda i: i["id"]):
        xy = rng.uniform(0, 30, (5, 2))
        wh = rng.uniform(5, 25, (5, 2))
        proposals.append(np.concatenate([xy, xy + wh, rng.uniform(0, 1, (5, 1))], 1)
                         .astype(np.float32))
    prop_file = os.path.join(str(root), "proposals.pkl")
    jax_dump(proposals, prop_file)
    return dict(ann_file=png_ann, img_prefix=img_dir, proposal_file=prop_file)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return write_png_coco(tmp_path_factory.mktemp("coco"))


TRAIN_SETTINGS = {
    "multiscale_flip_crowd_proposals": dict(
        img_expected_sizes=[(120, 80), (96, 64)], size_mode="range", flip_ratio=0.5,
        with_crowd=True, proposal_file=True, seed=5),
    "background_erasing": dict(img_expected_sizes=(100, 70), flip_ratio=0.5,
                               with_background_erasing=True, be_cell_size=8, seed=2),
}


def _cfg(coco, **kw):
    cfg = dict(type="CocoDataset", ann_file=coco["ann_file"], img_prefix=coco["img_prefix"],
               img_means=MEANS, img_stds=STDS, size_divisor=32)
    if kw.pop("proposal_file", False):
        cfg["proposal_file"] = coco["proposal_file"]
    return dict(cfg, **kw)


def _same_image(got, want):
    """Equal shapes; within one grey level before the normalisation."""
    assert got.shape == want.shape and got.dtype == want.dtype
    assert np.abs((got - want) * np.asarray(STDS, np.float32)).max() <= 1.0


@pytest.mark.parametrize("setting", sorted(TRAIN_SETTINGS))
def test_train_samples_equal_the_reference(coco, setting):
    got_ds = get_datasets(_cfg(coco, **TRAIN_SETTINGS[setting]))
    want_ds = jax_get_datasets(_cfg(coco, **TRAIN_SETTINGS[setting]))
    assert isinstance(got_ds, CocoDataset) and len(got_ds) == len(want_ds) == 2
    assert np.array_equal(got_ds.flag, want_ds.flag) and got_ds.cat2label == want_ds.cat2label
    for epoch in (0, 1):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        for idx in range(len(got_ds)):
            got, want = got_ds[idx], want_ds[idx]
            assert sorted(got) == sorted(want)
            assert got["img_meta"].data == want["img_meta"].data
            _same_image(got["img"].data, want["img"].data)
            for key in sorted(set(got) - {"img", "img_meta"}):
                assert got[key].data.dtype == want[key].data.dtype, key
                assert np.array_equal(got[key].data, want[key].data), key
            assert got_ds.get_ann_info(idx).keys() == want_ds.get_ann_info(idx).keys()
            for key, value in got_ds.get_ann_info(idx).items():
                assert np.array_equal(value, want_ds.get_ann_info(idx)[key]), key


def test_test_samples_equal_the_reference(coco):
    kw = dict(img_expected_sizes=[(120, 80), (96, 64)], flip_ratio=0.5, test_mode=True,
              proposal_file=True)
    got_ds, want_ds = get_datasets(_cfg(coco, **kw)), jax_get_datasets(_cfg(coco, **kw))
    assert len(got_ds) == len(want_ds) == 3  # test mode keeps the image without annotations
    for idx in range(3):
        got, want = got_ds[idx], want_ds[idx]
        assert len(got["img"]) == 4  # two scales, each plain and flipped
        assert [m.data for m in got["img_meta"]] == [m.data for m in want["img_meta"]]
        for g, w in zip(got["img"], want["img"]):
            _same_image(g, w)
        for g, w in zip(got["proposals"], want["proposals"]):
            assert np.array_equal(g, w)


def _as_jax(sample):
    """The same sample in the reference's containers."""
    out = {}
    for k, v in sample.items():
        if isinstance(v, list):
            out[k] = [JaxDataContainer(x.data, cpu_only=True) if isinstance(x, DataContainer)
                      else x for x in v]
        else:
            out[k] = JaxDataContainer(v.data, stack=v.stack, cpu_only=v.cpu_only)
    return out


def _equal_batches(got, want):
    assert sorted(got) == sorted(want)
    for k in got:
        if k == "img_meta":
            assert got[k] == want[k]
        else:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kwargs", [
    dict(), dict(canvas=(128, 160)), dict(canvas_buckets=[(64, 64), (128, 128), (160, 192)]),
    dict(s2d=True, max_gts=1), dict(max_proposals=8, size_divisor=64)])
def test_collate_equals_the_reference(coco, kwargs):
    ds = get_datasets(_cfg(coco, **TRAIN_SETTINGS["multiscale_flip_crowd_proposals"]))
    samples = [ds[0], ds[1]]
    _equal_batches(collate(samples, **kwargs), jax_collate([_as_jax(s) for s in samples], **kwargs))


def test_collate_test_equals_the_reference(coco):
    ds = get_datasets(_cfg(coco, img_expected_sizes=[(120, 80), (96, 64)], flip_ratio=0.5,
                           test_mode=True))
    samples = [ds[i] for i in range(3)]
    got = collate_test(samples)
    want = jax_collate_test([_as_jax(s) for s in samples])
    assert got["img_metas"] == want["img_metas"] and len(got["imgs"]) == 4
    for g, w in zip(got["imgs"], want["imgs"]):
        assert np.array_equal(g, w)


def test_get_datasets_fans_out_like_the_reference(coco):
    cfg = _cfg(coco, img_expected_sizes=(96, 64), ann_file=[coco["ann_file"]] * 3,
               img_prefix=coco["img_prefix"])
    got, want = get_datasets(cfg), jax_get_datasets(cfg)
    assert isinstance(got, ConcatDataset) and len(got) == len(want) == 6
    assert np.array_equal(got.flag, want.flag) and got.cumulative_sizes == want.cumulative_sizes
    for idx in (0, 3, 5):
        assert got[idx]["img_meta"].data == want[idx]["img_meta"].data
    with pytest.raises(AssertionError):
        get_datasets(dict(cfg, img_prefix=[coco["img_prefix"]] * 2))


def test_loader_order_and_skip_batches(coco):
    cfg = _cfg(coco, img_expected_sizes=(96, 64), flip_ratio=0.5, seed=1,
               ann_file=[coco["ann_file"]] * 2)
    kw = dict(sample_per_replica=2, max_gts=4, canvas=(96, 96), seed=3)
    got_loader = build_dataloader(get_datasets(cfg), **kw)
    want_loader = jax_build_dataloader(jax_get_datasets(cfg), **kw)
    assert len(got_loader) == len(want_loader) == 2
    for epoch in (0, 1):
        got_loader.set_epoch(epoch)
        want_loader.set_epoch(epoch)
        full = list(got_loader.iter_batches())
        for got, want in zip(full, want_loader, strict=True):
            assert got["img_meta"] == want["img_meta"]
            for k in ("gt_boxes", "gt_labels", "gt_valid", "img_shape", "scale_factor"):
                assert np.array_equal(got[k], want[k]), k
        (tail,) = list(got_loader.iter_batches(1))
        _equal_batches(tail, full[1])
        threaded = build_dataloader(get_datasets(cfg), workers=2, **kw)
        threaded.set_epoch(epoch)
        for a, b in zip(threaded, full, strict=True):
            _equal_batches(a, b)


def test_loader_raises_the_thread_error_and_stops_its_thread(coco):
    class Broken:
        flag = np.zeros(4, np.uint8)

        def __len__(self):
            return 4

        def __getitem__(self, idx):
            raise RuntimeError(f"bad sample {idx}")

    with pytest.raises(RuntimeError, match="bad sample"):
        list(build_dataloader(Broken(), sample_per_replica=2))
    loader = build_dataloader(get_datasets(_cfg(coco, img_expected_sizes=(96, 64))),
                              sample_per_replica=1, prefetch=1)
    before = threading.active_count()
    it = loader.iter_batches()
    next(it)
    it.close()  # a consumer that stops early: the prefetch thread ends
    assert threading.active_count() == before


def test_prefetch_to_device_on_the_cpu():
    batches = [dict(image=np.full((1, 2, 2, 3), i, np.float32), img_meta=[{"i": i}],
                    gt_valid=np.ones((1, 2), bool)) for i in range(3)]
    out = list(prefetch_to_device(iter(batches), size=2, device="cpu"))
    assert [b["img_meta"] for b in out] == [[{"i": i}] for i in range(3)]
    for i, b in enumerate(out):
        assert isinstance(b["image"], torch.Tensor) and float(b["image"][0, 0, 0, 0]) == i
        assert b["gt_valid"].dtype == torch.bool


def test_fixed_canvas_cannot_hold_a_portrait_image_pin_r8():
    """R8: the COCO configs' fixed canvas (800, 1344) holds no portrait
    image at ``img_expected_sizes=(1333, 800)``: a 480 x 640 image resizes
    to 1067 x 800. The reference's collate asserts; the port's raises."""
    (h, w), _ = image.rescale_size((640, 480), (1333, 800))
    assert (h, w) == (1067, 800)
    sample = dict(img=DataContainer(np.zeros((1088, 800, 3), np.float32), stack=True),
                  img_meta=DataContainer(dict(img_shape=(h, w, 3), scale_factor=1.0),
                                         cpu_only=True),
                  gt_bboxes=DataContainer(np.zeros((1, 4), np.float32)))
    with pytest.raises(ValueError, match="canvas"):
        collate([sample], canvas=(800, 1344))
    with pytest.raises(AssertionError, match="canvas"):
        jax_collate([_as_jax(sample)], canvas=(800, 1344))
