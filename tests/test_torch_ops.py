"""The port's box, anchor and NMS ops against the JAX package's.

Inputs come from a numpy seed and go through both sides in float32.
Anchors are exact (the same IEEE operations); decoded boxes and IoUs are
held to 1e-6 relative (exp and division may differ by an ulp between the
two runtimes). NMS must select the same candidates in the same order:
identical ``valid``, ``labels`` and ``indices``, boxes and scores to 1e-6.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_detection_tpu.ops import anchors as jax_anchors
from torch_detection_tpu.ops import boxes as jax_boxes
from torch_detection_tpu_torch.ops import anchors, boxes, nms

# the package's ``ops`` namespace exports the function ``nms`` over the module
jax_nms = importlib.import_module("torch_detection_tpu.ops.nms")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _random_boxes(rng, shape, lo=0.0, hi=200.0, max_wh=80.0):
    xy = rng.uniform(lo, hi, (*shape, 2)).astype(np.float32)
    wh = rng.uniform(1.0, max_wh, (*shape, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


@pytest.mark.parametrize(
    "gen_kwargs",
    [
        dict(strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0), scales=(8.0,), octave_base_scale=None),
        dict(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0), octave_base_scale=4.0,
             scales_per_octave=3),
    ],
    ids=["faster_rcnn", "retinanet"],
)
def test_anchors_match(gen_kwargs):
    sizes = [(13, 20), (7, 10), (4, 5), (2, 3), (1, 2)]
    want = jax_anchors.AnchorGenerator(**gen_kwargs).flat_anchors(sizes)
    got = anchors.AnchorGenerator(**gen_kwargs).flat_anchors(sizes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_base_and_grid_anchors_match():
    want = jax_anchors.grid_anchors(jax_anchors.base_anchors(16, (0.5, 1.0, 2.0), (8.0, 16.0), 0.5), (3, 5), 16)
    got = anchors.grid_anchors(anchors.base_anchors(16, (0.5, 1.0, 2.0), (8.0, 16.0), 0.5), (3, 5), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_classes", [1, 3])
@pytest.mark.parametrize("max_shape", [None, (120, 150)])
def test_delta2bbox_matches(rng, num_classes, max_shape):
    rois = _random_boxes(rng, (2, 50))
    deltas = rng.normal(scale=1.0, size=(2, 50, 4 * num_classes)).astype(np.float32)
    deltas[0, :5, 2::4] = 9.0  # beyond the wh_ratio_clip bound log(1000/16)
    deltas[1, :5, 3::4] = -9.0
    kw = dict(means=(0.1, -0.1, 0.0, 0.05), stds=(0.1, 0.1, 0.2, 0.2), max_shape=max_shape)
    want = jax_boxes.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas), **kw)
    got = boxes.delta2bbox(_t(rois), _t(deltas), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("num_classes", [1, 3])
def test_delta2bbox_matches_in_bf16(rng, num_classes):
    """bf16 deltas (a head's) with stds and means that bf16 cannot hold
    exactly: both sides scale by the bf16-rounded stds, so the boxes agree
    bit for bit (float32 rois; each op of the reference run eagerly)."""
    rois = _random_boxes(rng, (2, 200))
    deltas = rng.normal(scale=1.0, size=(2, 200, 4 * num_classes)).astype(np.float32)
    kw = dict(means=(0.1, -0.1, 0.0, 0.05), stds=(0.1, 0.1, 0.2, 0.2))
    want = jax_boxes.delta2bbox(jnp.asarray(rois), jnp.asarray(deltas, jnp.bfloat16), **kw)
    got = boxes.delta2bbox(_t(rois), _t(deltas).bfloat16(), **kw)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("mode", ["iou", "iof"])
def test_bbox_overlaps_matches(rng, mode):
    a, b = _random_boxes(rng, (30,)), _random_boxes(rng, (20,))
    want = jax_boxes.bbox_overlaps(jnp.asarray(a), jnp.asarray(b), mode=mode)
    got = boxes.bbox_overlaps(_t(a), _t(b), mode=mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_clip_boxes_matches(rng):
    bx = _random_boxes(rng, (2, 40), lo=-50.0, hi=250.0)
    shapes = np.array([[120.0, 150.0], [200.0, 90.0]], np.float32)
    got = boxes.clip_boxes(_t(bx), _t(shapes)).numpy()
    for i, (h, w) in enumerate(shapes):
        want = jax_boxes.clip_boxes(jnp.asarray(bx[i]), (float(h), float(w)))
        np.testing.assert_array_equal(got[i], np.asarray(want))


def _assert_same_result(got, want_per_image):
    for i, want in enumerate(want_per_image):
        np.testing.assert_array_equal(got.valid[i].numpy(), np.asarray(want.valid))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
        np.testing.assert_array_equal(got.indices[i].numpy(), np.asarray(want.indices))
        np.testing.assert_allclose(got.boxes[i].numpy(), np.asarray(want.boxes), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got.scores[i].numpy(), np.asarray(want.scores), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "kw",
    [
        dict(iou_thr=0.5, score_thr=0.05, max_out=40),
        dict(iou_thr=0.7, score_thr=0.0, max_out=300, pre_top_k=120),  # padded output
        dict(iou_thr=0.3, score_thr=0.2, max_out=20, pre_top_k=60),
    ],
)
def test_nms_matches(rng, kw):
    bx = _random_boxes(rng, (3, 200), hi=120.0)
    sc = rng.uniform(0, 1, (3, 200)).astype(np.float32)
    valid = rng.uniform(size=(3, 200)) > 0.1
    got = nms.nms(_t(bx), _t(sc), valid=_t(valid), **kw)
    want = [jax_nms.nms(jnp.asarray(bx[i]), jnp.asarray(sc[i]), valid=jnp.asarray(valid[i]), **kw)
            for i in range(3)]
    _assert_same_result(got, want)


def test_nms_unbatched(rng):
    bx, sc = _random_boxes(rng, (50,), hi=60.0), rng.uniform(0, 1, (50,)).astype(np.float32)
    got = nms.nms(_t(bx), _t(sc), max_out=10)
    want = jax_nms.nms(jnp.asarray(bx), jnp.asarray(sc), max_out=10)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.boxes.shape == (10, 4)


@pytest.mark.parametrize("class_specific", [False, True])
def test_multiclass_nms_matches(rng, class_specific):
    n, c = 150, 4
    shape = (2, n, c) if class_specific else (2, n)
    bx = _random_boxes(rng, shape, hi=100.0)
    sc = rng.uniform(0, 0.6, (2, n, c)).astype(np.float32)
    valid = rng.uniform(size=(2, n)) > 0.2
    kw = dict(iou_thr=0.5, score_thr=0.05, pre_nms_top_k=300, max_out=50)
    got = nms.multiclass_nms(_t(bx), _t(sc), valid=_t(valid), **kw)
    want = [jax_nms.multiclass_nms(jnp.asarray(bx[i]), jnp.asarray(sc[i]),
                                   valid=jnp.asarray(valid[i]), **kw) for i in range(2)]
    _assert_same_result(got, want)


def test_tied_scores_keep_the_stable_order(rng):
    """bf16 logits tie often: equal scores must rank lower index first, as
    XLA's top_k does, in the candidate pool and in the output."""
    n, c = 120, 3
    bx = _random_boxes(rng, (2, n), hi=150.0)
    sc = (np.round(rng.uniform(0, 1, (2, n, c)) * 4) / 4).astype(np.float32)  # 5 levels
    kw = dict(iou_thr=0.5, score_thr=0.05, pre_nms_top_k=100, max_out=60)
    got = nms.multiclass_nms(_t(bx), _t(sc), **kw)
    want = [jax_nms.multiclass_nms(jnp.asarray(bx[i]), jnp.asarray(sc[i]), **kw) for i in range(2)]
    _assert_same_result(got, want)
    single = nms.nms(_t(bx), _t(sc[..., 0]), max_out=60, pre_top_k=80)
    want = [jax_nms.nms(jnp.asarray(bx[i]), jnp.asarray(sc[i, :, 0]), max_out=60, pre_top_k=80)
            for i in range(2)]
    _assert_same_result(single, want)


def _sequential_greedy(iou, thr):
    keep = []
    for j in range(iou.shape[0]):
        if all(iou[i, j] <= thr for i in keep):
            keep.append(j)
    mask = np.zeros(iou.shape[0], bool)
    mask[keep] = True
    return mask


def test_batched_fixpoint_equals_sequential_greedy(rng):
    """Images converge after different iteration counts; running every image
    until the slowest converges must not change the faster ones."""
    k = 40
    chain = np.zeros((k, k), np.float32)
    idx = np.arange(k - 1)
    chain[idx, idx + 1] = 0.9  # a suppression chain: needs ~k iterations
    dense = rng.uniform(0, 1, (k, k)).astype(np.float32)  # converges fast
    iou = np.stack([chain, dense])
    before = nms.suppress_syncs()
    got = nms._greedy_suppress(_t(iou), 0.5).numpy()
    for i in range(2):
        np.testing.assert_array_equal(got[i], _sequential_greedy(iou[i], 0.5))
    assert k - 1 <= nms.suppress_syncs() - before <= k + 1
