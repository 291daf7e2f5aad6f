"""The port's Soft-NMS and RetinaNet's ``nms_method="soft"`` against the JAX package's.

* ``soft_nms`` (gaussian and linear) on overlapping clusters with invalid
  rows, with a pool cut by ``pre_top_k`` and with pools that run out
  before ``max_out`` (fewer candidates than picks, and a pool whose every
  score falls under ``score_thr``), batched and unbatched;
* ``multiclass_soft_nms`` (both methods) with shared and class-specific
  boxes, the class offset's islands (a cross-class pair decays nothing),
  invalid boxes and a pool smaller than ``max_out``;
* RetinaNet's decode with ``nms_method="soft"`` against the reference's on
  seeded head outputs of five levels at 64 x 96, with and without clipping
  and scale factors;
* the builder: a RetinaNet config with ``nms_method="soft"`` and
  ``soft_sigma``, FreeAnchor's inheriting them, an unknown method refused.

The reference runs under jit. Tolerances: the picked indices, labels and
validity exactly; scores 1e-5 (a score is its candidate's times the decay
factors of every earlier pick, each an exp that XLA's and torch's CPU
kernels may round an ulp apart: up to 2.9e-6 relative after tens of
decays) and boxes 1e-4 px.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import RetinaNetConfig as JaxRetinaNetConfig
from torch_detection_tpu.models.detectors import decode_detections as jax_decode_detections
from torch_detection_tpu.ops.nms import multiclass_soft_nms as jax_multiclass_soft_nms
from torch_detection_tpu.ops.nms import soft_nms as jax_soft_nms
from torch_detection_tpu_torch.builder import build_detection_cfg
from torch_detection_tpu_torch.models.detectors import (
    FreeAnchorConfig,
    RetinaNetConfig,
    decode_detections,
)
from torch_detection_tpu_torch.ops.nms import multiclass_soft_nms, soft_nms
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tt(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def clusters(rng, n: int, b: int = 2):
    """(B, N, 4) boxes in clusters of jittered copies (IoUs from 0.3 to
    0.95), (B, N) scores, (B, N) validity with a few invalid rows."""
    centres = rng.uniform(20, 180, (b, max(n // 4, 1), 2))
    pick = rng.integers(0, centres.shape[1], (b, n))
    c = np.take_along_axis(centres, pick[..., None], axis=1) + rng.normal(0, 4, (b, n, 2))
    wh = rng.uniform(20, 60, (b, n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], axis=-1).astype(np.float32)
    scores = rng.uniform(0.0, 1.0, (b, n)).astype(np.float32)
    valid = rng.uniform(size=(b, n)) > 0.1
    return boxes, scores, valid


def check(got, want, what=""):
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=what + field)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0,
                               err_msg=what + "scores")
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4, rtol=0,
                               err_msg=what + "boxes")


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("n,kw", [
    (60, dict(max_out=20)),
    (60, dict(max_out=20, pre_top_k=25, score_thr=0.05)),
    (12, dict(max_out=20)),  # fewer candidates than picks
    (40, dict(max_out=10, score_thr=0.999)),  # every pick under score_thr
], ids=["pool", "pre_top_k", "short_pool", "empty"])
def test_soft_nms_matches_the_reference(rng, method, n, kw):
    boxes, scores, valid = clusters(rng, n)
    fn = jax.jit(jax.vmap(functools.partial(jax_soft_nms, method=method, iou_thr=0.3, **kw)))
    want = fn(jnp.asarray(boxes), jnp.asarray(scores), valid=jnp.asarray(valid))
    got = soft_nms(tt(boxes), tt(scores), method=method, iou_thr=0.3, valid=tt(valid), **kw)
    check(got, want)
    if kw.get("score_thr") == 0.999:
        assert not bool(got.valid.any())
    elif n < kw["max_out"]:
        assert not bool(got.valid[:, n:].any()) and bool(got.valid[:, 0].all())
    one = soft_nms(tt(boxes[1]), tt(scores[1]), method=method, iou_thr=0.3, valid=tt(valid[1]),
                   **kw)
    for g, w in zip(one, got):
        assert torch.equal(g, w[1])


@pytest.mark.parametrize("method", ["gaussian", "linear"])
@pytest.mark.parametrize("specific", [False, True], ids=["shared_boxes", "class_boxes"])
def test_multiclass_soft_nms_matches_the_reference(rng, method, specific):
    n, c = 50, 3
    boxes, _, valid = clusters(rng, n)
    if specific:
        boxes = boxes[:, :, None, :] + rng.normal(0, 2, (2, n, c, 4)).astype(np.float32)
    scores = rng.uniform(0, 1, (2, n, c)).astype(np.float32) ** 2
    kw = dict(method=method, iou_thr=0.3, score_thr=0.05, pre_nms_top_k=80, max_out=40)
    want = jax.jit(jax.vmap(functools.partial(jax_multiclass_soft_nms, **kw)))(
        jnp.asarray(boxes), jnp.asarray(scores), valid=jnp.asarray(valid))
    got = multiclass_soft_nms(tt(boxes), tt(scores), valid=tt(valid), **kw)
    check(got, want)
    assert bool(got.valid.all()) and len(set(got.labels[0].tolist())) == c


def test_multiclass_soft_nms_islands_and_a_short_pool():
    """Two identical boxes of two classes keep their scores (the offset puts
    them on islands of their own); a third of the first class decays; the
    pool (3 pairs over ``score_thr``, 6 in all) is shorter than
    ``max_out``."""
    boxes = np.array([[[10, 10, 50, 50], [12, 10, 52, 50]]], np.float32)
    scores = np.array([[[0.9, 0.8, 0.01], [0.7, 0.02, 0.03]]], np.float32)
    kw = dict(iou_thr=0.3, score_thr=0.05, pre_nms_top_k=1000, max_out=8)
    want = jax.jit(jax.vmap(functools.partial(jax_multiclass_soft_nms, **kw)))(
        jnp.asarray(boxes), jnp.asarray(scores))
    got = multiclass_soft_nms(tt(boxes), tt(scores), **kw)
    check(got, want)
    assert got.labels[0, :3].tolist() == [0, 1, 0] and got.valid[0].tolist() == [True] * 3 + [False] * 5
    assert got.scores[0, :2].tolist() == [float(np.float32(0.9)), float(np.float32(0.8))]
    assert got.scores[0, 2] < np.float32(0.7)
    single = multiclass_soft_nms(tt(boxes[0]), tt(scores[0]), **kw)
    assert torch.equal(single.scores, got.scores[0])


# ---------------------------------------------------------------- RetinaNet's decode


def head_outputs(rng, c=3, a=9):
    """Seeded per-level logits and deltas of five levels on a 64 x 96 canvas."""
    sizes = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]
    cls = [rng.normal(-1.5, 1.5, (2, h, w, a * c)).astype(np.float32) for h, w in sizes]
    reg = [rng.normal(0, 0.3, (2, h, w, a * 4)).astype(np.float32) for h, w in sizes]
    return cls, reg


@pytest.mark.parametrize("clip_and_scale", [False, True])
def test_retina_decode_with_soft_nms_matches_the_reference(rng, clip_and_scale):
    cls, reg = head_outputs(rng)
    shapes = np.array([[64, 96], [50, 70]], np.float32) if clip_and_scale else None
    scale = np.array([1.0, 2.0], np.float32) if clip_and_scale else None
    kw = dict(num_classes=3, nms_method="soft", soft_sigma=0.4, pre_nms_top_k=300,
              max_detections=50)
    want = jax.jit(lambda c, r, s, f: jax_decode_detections(JaxRetinaNetConfig(**kw), c, r, s, f))(
        cls, reg, shapes, scale)
    as_t = lambda x: None if x is None else tt(x)
    got = decode_detections(RetinaNetConfig(**kw), [tt(c) for c in cls], [tt(r) for r in reg],
                            as_t(shapes), as_t(scale))
    check(got, want)
    hard = decode_detections(RetinaNetConfig(**dict(kw, nms_method="hard")), [tt(c) for c in cls],
                             [tt(r) for r in reg], as_t(shapes), as_t(scale))
    # each pick is the pool's largest decayed score, so the scores never rise; the
    # picks are not greedy NMS's
    assert bool((got.scores[:, 1:] <= got.scores[:, :-1]).all())
    assert not torch.equal(got.indices, hard.indices)


def test_builder_takes_soft_nms_for_retinanet_and_free_anchor():
    for name, config_cls in (("retinanet_r50_fpn_coco.py", RetinaNetConfig),
                             ("free_anchor_r50_fpn_coco.py", FreeAnchorConfig)):
        cfg = Config.fromfile(os.path.join(CONFIGS, name))
        det = dict(cfg.detection, nms_method="soft", soft_sigma=0.3)
        got = build_detection_cfg(det)
        assert type(got) is config_cls and (got.nms_method, got.soft_sigma) == ("soft", 0.3)
        if config_cls is RetinaNetConfig:  # the reference's R1 breaks its FreeAnchor build
            det.pop("assigner")
            want = jax_builder.build_detection_cfg(det)
            assert (want.nms_method, want.soft_sigma) == ("soft", 0.3)
    assert build_detection_cfg(dict(style="retina")).nms_method == "hard"
    with pytest.raises(ValueError, match="nms_method"):
        build_detection_cfg(dict(style="retina", nms_method="greedy"))
