"""The port's mask tier against the JAX package's cv2-backed one, on the CPU.

The RLE codec and its compressed strings, run-native IoUs, the polygon fill
(the reference calls ``cv2.fillPoly``; the port fills without OpenCV) and
the nearest resize (``cv2.INTER_NEAREST``) must give the reference's bits;
``MaskTransforms``, ``CocoDataset(with_mask=True)`` samples and the
collate's (B, G, H, W) gt masks with G bucketed must equal the reference's.
"""

import json

import numpy as np
import pytest

from data_fixtures import make_coco
from torch_detection_tpu.data import DataContainer as JaxDataContainer
from torch_detection_tpu.data import collate as jax_collate
from torch_detection_tpu.data import get_datasets as jax_get_datasets
from torch_detection_tpu.data.ops import mask as jax_mask
from torch_detection_tpu.data.transforms import MaskTransforms as JaxMaskTransforms
from torch_detection_tpu_torch.data import DataContainer, MaskTransforms, collate, get_datasets
from torch_detection_tpu_torch.data.ops import image, mask

MEANS, STDS = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)


def _random_masks(rng, n=12):
    out = []
    for _ in range(n):
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        kind = rng.integers(3)
        if kind == 0:
            m = (rng.random((h, w)) < rng.uniform(0.05, 0.95)).astype(np.uint8)
        elif kind == 1:  # a blob: long runs
            m = np.zeros((h, w), np.uint8)
            m[rng.integers(h):, rng.integers(w):] = 1
        else:
            m = np.full((h, w), int(rng.integers(2)), np.uint8)
        out.append(m)
    return out


@pytest.mark.parametrize("compress", (True, False))
def test_rle_codec_equals_the_reference(compress):
    rng = np.random.default_rng(0)
    for m in _random_masks(rng, 40):
        got, want = mask.rle_encode(m, compress=compress), jax_mask.rle_encode(m, compress=compress)
        assert got["size"] == want["size"] and list(got["counts"]) == list(want["counts"])
        assert np.array_equal(mask.rle_decode(got), m)
        assert np.array_equal(mask.rle_decode(want), jax_mask.rle_decode(want))
        assert mask.rle_area(got) == int(m.sum())


def test_compressed_strings_equal_the_scalar_oracles():
    """COCO's LEB128-style counts against the reference's scalar codec, with
    large runs and deltas of both signs."""
    rng = np.random.default_rng(1)
    for _ in range(200):
        counts = rng.integers(0, rng.choice([3, 40, 5000, 10 ** 6]), rng.integers(1, 30)).tolist()
        s = jax_mask._rle_compress_py(counts)
        assert mask._rle_compress(counts) == s
        assert mask._rle_decompress(s).tolist() == jax_mask._rle_decompress_py(s) == counts
        assert mask._rle_decompress(s.decode("ascii")).tolist() == counts


@pytest.mark.parametrize("crowd", (False, True))
def test_rle_iou_matrix_equals_the_reference(crowd):
    rng = np.random.default_rng(2)
    dts = [(rng.random((37, 29)) < p).astype(np.uint8) for p in rng.uniform(0, 1, 6)]
    gts = [(rng.random((37, 29)) < p).astype(np.uint8) for p in rng.uniform(0, 1, 4)]
    d_rles = [mask.rle_encode(m, compress=bool(i % 2)) for i, m in enumerate(dts)]
    g_rles = [mask.rle_encode(m, compress=bool(i % 2)) for i, m in enumerate(gts)]
    got = mask.rle_iou_matrix(d_rles, g_rles, crowd=crowd)
    assert np.array_equal(got, jax_mask.rle_iou_matrix(d_rles, g_rles, crowd=crowd))
    assert mask.rle_iou_matrix([], g_rles).shape == (0, 4)


def _star(rng, cx, cy, r, n, jitter):
    a = np.sort(rng.uniform(0, 2 * np.pi, n))
    rr = r * (1 - jitter * rng.uniform(0, 1, n))
    return np.stack([cx + rr * np.cos(a), cy + rr * np.sin(a)], 1).reshape(-1).tolist()


def _polygons(kind, rng, h, w):
    side = max(h, w)
    if kind == "convex":
        return [_star(rng, rng.uniform(0, w), rng.uniform(0, h), rng.uniform(3, 30),
                      int(rng.integers(3, 12)), 0.0)]
    if kind == "concave":
        return [_star(rng, rng.uniform(0, w), rng.uniform(0, h), rng.uniform(3, 30),
                      int(rng.integers(6, 40)), 0.7)]
    if kind == "two_parts":
        return [_star(rng, rng.uniform(0, w), rng.uniform(0, h), rng.uniform(3, 20),
                      int(rng.integers(6, 20)), 0.5) for _ in range(2)]
    if kind == "self_intersecting":
        return [rng.uniform(-10, side + 10, int(rng.integers(3, 15)) * 2).tolist()]
    if kind == "half_coordinates":  # np.round's ties to even
        return [(np.round(rng.uniform(-5, side + 5, int(rng.integers(3, 10)) * 2) * 2) / 2).tolist()]
    if kind == "off_the_border":
        return [_star(rng, rng.uniform(-20, w + 20), rng.uniform(-20, h + 20), rng.uniform(10, 60),
                      int(rng.integers(3, 20)), 0.5)]
    if kind == "on_the_border":  # COCO's vertices at x = w or y = h
        pts = np.asarray(_star(rng, w / 2, h / 2, side, int(rng.integers(4, 12)), 0.3)).reshape(-1, 2)
        return [np.clip(pts, 0, [w, h]).reshape(-1).tolist()]
    raise KeyError(kind)


@pytest.mark.parametrize("kind", ["convex", "concave", "two_parts", "self_intersecting",
                                  "half_coordinates", "off_the_border", "on_the_border"])
def test_poly_to_mask_equals_cv2_fill_poly(kind):
    rng = np.random.default_rng(sorted(["convex", "concave", "two_parts", "self_intersecting",
                                        "half_coordinates", "off_the_border",
                                        "on_the_border"]).index(kind))
    for _ in range(150):
        h, w = (int(v) for v in rng.integers(20, 80, 2))
        polys = _polygons(kind, rng, h, w)
        got, want = mask.poly_to_mask(polys, h, w), jax_mask.poly_to_mask(polys, h, w)
        assert got.dtype == want.dtype == np.uint8
        assert np.array_equal(got, want), (kind, h, w, polys, np.argwhere(got != want)[:8])


def _object_polygons(kind, rng, h, w):
    """Object-sized COCO polygons: 50-300 vertices, edges hundreds of pixels
    long; ``near_horizontal`` alternates edges across the frame that rise
    a few pixels with edges that fall across it."""
    n = int(rng.integers(50, 300))
    if kind == "object":
        return [_star(rng, rng.uniform(0, w), rng.uniform(0, h), rng.uniform(100, 400), n, 0.3)]
    if kind == "two_parts":
        return [_star(rng, rng.uniform(0, w), rng.uniform(0, h), rng.uniform(50, 300), n, 0.8)
                for _ in range(2)]
    if kind == "near_horizontal":
        pts = [(rng.uniform(0, w), rng.uniform(0, h))]
        for i in range(n - 1):
            x, y = pts[-1]
            pts.append((rng.uniform(0, w), y + rng.uniform(-3, 3)) if i % 2
                       else (x + rng.uniform(-3, 3), rng.uniform(0, h)))
        return [np.asarray(pts).reshape(-1).tolist()]
    if kind == "long_self_intersecting":
        return [rng.uniform(-50, max(h, w) + 50, n * 2).tolist()]
    raise KeyError(kind)


@pytest.mark.parametrize("frame", [(480, 640), (427, 640), (612, 612)])
@pytest.mark.parametrize("kind", ["object", "two_parts", "near_horizontal",
                                  "long_self_intersecting"])
def test_poly_to_mask_equals_cv2_fill_poly_at_coco_frames(frame, kind):
    """At COCO's frame sizes a 16.16 step's rounding has hundreds of rows to
    add up along an edge; the fill still equals ``cv2.fillPoly`` bit for bit."""
    h, w = frame
    rng = np.random.default_rng([h, w, len(kind)])
    for i in range(25):
        polys = _object_polygons(kind, rng, h, w)
        if i % 3 == 0:  # quarter-pixel vertices: rounding ties and near-ties
            polys = [(np.round(np.asarray(p) * 4) / 4).tolist() for p in polys]
        got, want = mask.poly_to_mask(polys, h, w), jax_mask.poly_to_mask(polys, h, w)
        assert np.array_equal(got, want), (kind, frame, i, np.argwhere(got != want)[:8])


def test_poly_to_mask_edge_cases():
    for polys, h, w in [([[1, 1, 5, 1]], 8, 8),  # under 3 points: skipped
                        ([[2, 2, 2, 2, 2, 2]], 8, 8),  # one point
                        ([[0, 3, 7, 3, 4, 3]], 8, 8),  # flat
                        ([[-9, -9, -1, -9, -5, -1]], 8, 8),  # all outside
                        ([[1, 1, 6, 1, 6, 6, 1, 6], [2, 2, 5, 2, 5, 5, 2, 5]], 8, 8)]:  # a hole
        assert np.array_equal(mask.poly_to_mask(polys, h, w), jax_mask.poly_to_mask(polys, h, w))


def test_segm_to_mask_and_mask_parse_equal_the_reference():
    rng = np.random.default_rng(4)
    m = (rng.random((23, 31)) < 0.4).astype(np.uint8)
    poly = [[2.0, 3.0, 20.5, 4.0, 15.0, 19.0], [1, 1, 2, 2]]
    for segm in (poly, mask.rle_encode(m), mask.rle_encode(m, compress=False)):
        got, want = ([], [], []), ([], [], [])
        mask.mask_parse({"segmentation": segm}, *got, 23, 31)
        jax_mask.mask_parse({"segmentation": segm}, *want, 23, 31)
        assert np.array_equal(got[0][0], want[0][0]) and got[1:] == want[1:]
    with pytest.raises(TypeError):
        mask.segm_to_mask("no", 2, 2)


COCO_SHAPES = [(480, 640), (427, 640), (375, 500), (612, 612), (640, 480), (333, 500), (424, 640)]


@pytest.mark.parametrize("scale", [(1333, 800), (1000, 600), (800, 480), 0.5, 1.37])
def test_nearest_resize_equals_cv2(scale):
    rng = np.random.default_rng(5)
    for h, w in COCO_SHAPES + [tuple(int(v) for v in rng.integers(20, 700, 2)) for _ in range(20)]:
        m = (rng.random((h, w)) < 0.5).astype(np.uint8)
        _, sf = image.rescale_size((h, w), scale)
        got, got_sf = mask.mask_resize(m, scale_factor=sf, return_scale=True)
        want, want_sf = jax_mask.mask_resize(m, scale_factor=sf, return_scale=True)
        assert got_sf == want_sf and got.dtype == want.dtype and np.array_equal(got, want)
    with pytest.raises(NotImplementedError, match="bicubic"):
        image.img_resize(m, scale_factor=0.5, interpolation="bicubic")


def test_mask_geometry_equals_the_reference():
    rng = np.random.default_rng(6)
    m = (rng.random((30, 40)) < 0.5).astype(np.uint8)
    for direction in ("horizontal", "vertical"):
        assert np.array_equal(mask.mask_flip(m, True, direction), jax_mask.mask_flip(m, True, direction))
    assert np.array_equal(mask.mask_crop(m, (12, 7), 3, 4), jax_mask.mask_crop(m, (12, 7), 3, 4))
    assert np.array_equal(mask.mask_pad(m, (33, 64)), jax_mask.mask_pad(m, (33, 64)))


@pytest.mark.parametrize("flip", [(False, "horizontal"), (True, "horizontal"), (True, "vertical")])
def test_mask_transforms_equal_the_reference(flip):
    rng = np.random.default_rng(7)
    masks = [(rng.random((60, 100)) < 0.3).astype(np.uint8) for _ in range(3)]
    _, sf = image.rescale_size((60, 100), (133, 80))
    args = (sf, (96, 160, 3)) + flip
    got, want = MaskTransforms()(masks, *args), JaxMaskTransforms()(masks, *args)
    assert got.shape == (3, 96, 160) and got.dtype == want.dtype and np.array_equal(got, want)
    assert MaskTransforms()([], *args).shape == (0, 96, 160)


# ---------------------------------------------------------------- datasets
def _extend_coco(ann_file):
    """``make_coco(with_mask=True)`` plus a two-part polygon, a compressed RLE
    and a crowd without a segmentation on the portrait image."""
    with open(ann_file) as f:
        ann = json.load(f)
    rle = jax_mask.rle_encode(np.pad(np.ones((20, 20), np.uint8), ((60, 20), (30, 10))))
    ann["annotations"] += [
        {"id": 4, "image_id": 2, "category_id": 11, "iscrowd": 0, "bbox": [3, 3, 40, 30],
         "area": 500, "segmentation": [[3, 3, 25, 5, 10, 20], [30, 10, 43, 10, 43, 33, 36, 20]]},
        {"id": 5, "image_id": 2, "category_id": 13, "iscrowd": 0, "bbox": [30, 60, 20, 20],
         "area": 400, "segmentation": dict(rle, counts=rle["counts"].decode("ascii"))},
        {"id": 6, "image_id": 2, "category_id": 11, "iscrowd": 1, "bbox": [2.5, 80.2, 20, 9.5],
         "area": 190},
    ]
    path = ann_file.replace(".json", "_more.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return path


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    ann_file, img_dir = make_coco(str(tmp_path_factory.mktemp("coco_masks")), with_mask=True)
    return dict(ann_file=_extend_coco(ann_file), img_prefix=img_dir)


def _cfg(coco, **kw):
    return dict(type="CocoDataset", ann_file=coco["ann_file"], img_prefix=coco["img_prefix"],
                img_means=MEANS, img_stds=STDS, size_divisor=32, with_mask=True, **kw)


def _equal_ann(got, want):
    assert got.keys() == want.keys()
    for key in got:
        if key in ("masks", "masks_ignore"):
            assert len(got[key]) == len(want[key])
            for g, w in zip(got[key], want[key]):
                assert g.dtype == w.dtype and np.array_equal(g, w), key
        elif key in ("mask_polys", "poly_lens"):
            assert got[key] == want[key]
        else:
            assert np.array_equal(got[key], want[key]), key


@pytest.mark.parametrize("seed", (1, 4))
def test_train_samples_with_masks_equal_the_reference(coco, seed):
    kw = dict(img_expected_sizes=[(120, 80), (96, 64)], size_mode="range", flip_ratio=0.5,
              with_crowd=True, seed=seed)
    got_ds, want_ds = get_datasets(_cfg(coco, **kw)), jax_get_datasets(_cfg(coco, **kw))
    assert len(got_ds) == len(want_ds) == 2
    flips = set()
    for epoch in (0, 1, 2):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        for idx in range(len(got_ds)):
            got, want = got_ds[idx], want_ds[idx]
            assert sorted(got) == sorted(want) and got["img_meta"].data == want["img_meta"].data
            flips.add(got["img_meta"].data["flipped_flag"])
            for key in ("gt_masks", "gt_bboxes", "gt_labels", "gt_bboxes_ignore"):
                assert got[key].cpu_only == want[key].cpu_only, key
                assert got[key].data.dtype == want[key].data.dtype, key
                assert np.array_equal(got[key].data, want[key].data), key
            assert got["gt_masks"].data.shape[1:] == got["img"].data.shape[:2]
            _equal_ann(got_ds.get_ann_info(idx), want_ds.get_ann_info(idx))
    assert flips == {False, True}


def test_test_annotations_with_masks_equal_the_reference(coco):
    kw = dict(img_expected_sizes=(120, 80), test_mode=True)
    got_ds, want_ds = get_datasets(_cfg(coco, **kw)), jax_get_datasets(_cfg(coco, **kw))
    assert len(got_ds) == len(want_ds) == 3
    for idx in range(3):
        assert [m.data for m in got_ds[idx]["img_meta"]] == [m.data for m in want_ds[idx]["img_meta"]]
        _equal_ann(got_ds.get_ann_info(idx), want_ds.get_ann_info(idx))
    crowd_window = got_ds.get_ann_info(1)["masks_ignore"][0]
    assert crowd_window.sum() == 21 * 10 and crowd_window[80:90, 2:23].all()


@pytest.mark.parametrize("counts,max_gts,g", [((1, 3), 100, 8), ((8, 2), 100, 8), ((9, 1), 100, 16),
                                              ((17, 40), 100, 64), ((70, 3), 100, 100),
                                              ((20, 1), 16, 16), ((3, 0), 4, 4)])
def test_collate_buckets_gt_masks_like_the_reference(counts, max_gts, g):
    rng = np.random.default_rng(sum(counts))
    samples = []
    for i, n in enumerate(counts):
        h, w = (64, 96) if i == 0 else (64, 64)
        samples.append(dict(
            img=DataContainer(rng.random((h, w, 3)).astype(np.float32), stack=True),
            img_meta=DataContainer(dict(img_shape=(h, w, 3), scale_factor=1.0), cpu_only=True),
            gt_bboxes=DataContainer(rng.uniform(0, 50, (n, 4)).astype(np.float32)),
            gt_labels=DataContainer(rng.integers(1, 5, n)),
            gt_masks=DataContainer((rng.random((n, h, w)) < 0.5).astype(np.uint8), cpu_only=True)))
    jax_samples = [{k: JaxDataContainer(v.data, stack=v.stack, cpu_only=v.cpu_only)
                    for k, v in s.items()} for s in samples]
    got = collate(samples, max_gts=max_gts, canvas=(64, 128))
    want = jax_collate(jax_samples, max_gts=max_gts, canvas=(64, 128))
    assert got["gt_masks"].shape == (2, g, 64, 128) and got["gt_masks"].dtype == np.uint8
    assert sorted(got) == sorted(want)
    for k in got:
        if k != "img_meta":
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
