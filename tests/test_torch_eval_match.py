"""The C++ matchers of the evaluators (``native/eval_match.cpp``) against
the port's plain Python matchers and the JAX package's ``native`` module,
and the three evaluators through them against the reference's.

Each matcher call must give the same matches: seeded images with crowd and
ignored gts, IoUs tied on a grid of 0.1, and images with no detections or
no gts. ``eval_coco_map``, ``eval_coco_segm_map`` and ``eval_voc_map``
(through the C++ matchers) must equal the reference's and the port's own
through the plain matchers to 1e-12.
"""

import numpy as np
import pytest

from test_torch_engine import _seeded_eval_inputs
from test_torch_segm_eval import _segm_case
from torch_detection_tpu import native as jax_native
from torch_detection_tpu.engine import eval as jax_eval
from torch_detection_tpu_torch import native
from torch_detection_tpu_torch.engine import eval as port_eval
from torch_detection_tpu_torch.native import eval_match

THRS = np.linspace(0.5, 0.95, 10)


def _image(rng, d: int, g: int, ties: bool):
    """``d`` detections half on the ``g`` gts, a third of the gts ignored
    and a fifth crowd, ``r`` ignore regions; IoUs rounded to 0.1 with
    ``ties``."""
    def boxes(n):
        xy = rng.integers(0, 60, (n, 2)).astype(float)
        return np.concatenate([xy, xy + rng.integers(0, 40, (n, 2))], 1)

    det, gt, regions = boxes(d), boxes(g), boxes(int(rng.integers(0, 3)))
    k = min(d, g) // 2
    det[:k] = gt[:k] + rng.integers(-3, 4, (k, 4))
    ignored = rng.random(g) < 0.3
    crowd = rng.random(g) < 0.2
    iou = port_eval._iou_matrix(det, gt)
    if ties:
        iou = np.round(iou, 1)
    return det, gt, regions, ignored, crowd, iou


@pytest.mark.parametrize("seed", range(4))
def test_the_matchers_equal_the_plain_ones_and_the_reference(seed):
    rng = np.random.default_rng(seed)
    for case in range(60):
        d = 0 if case % 10 == 0 else int(rng.integers(1, 25))
        g = 0 if case % 10 == 1 else int(rng.integers(1, 12))
        det, gt, regions, ignored, crowd, iou = _image(rng, d, g, ties=case % 2 == 0)
        for thr in (0.3, 0.5, 0.75):
            got = eval_match.match_image(det, gt, ignored, regions, thr)
            for want in (port_eval._match_image_plain(det, gt, ignored, regions, thr),
                         jax_native.match_image(det, gt, ignored, regions, thr)):
                assert all(np.array_equal(a, b) for a, b in zip(got, want)), (case, thr)
        order = np.argsort(ignored, kind="mergesort")
        args = (iou[:, order], ignored[order], crowd[order], THRS)
        got = eval_match.coco_match(*args)
        assert got[0].shape == (len(THRS), d)
        for want in (port_eval._coco_match_img_plain(*args), jax_native.coco_match(*args)):
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), case
        ious = eval_match.iou_matrix(det, gt)
        np.testing.assert_array_equal(ious, port_eval._iou_matrix(det, gt))
        np.testing.assert_array_equal(ious, jax_native.iou_matrix(det, gt))


@pytest.fixture
def plain_matchers(monkeypatch):
    """The evaluators through the plain Python matchers."""
    def use():
        monkeypatch.setattr(port_eval, "_coco_match_img", port_eval._coco_match_img_plain)
        monkeypatch.setattr(port_eval, "_match_image", port_eval._match_image_plain)

    return use


def _flat(metrics, prefix=""):
    """A metrics dict, nested ones (VOC's per-class APs) flattened."""
    out = {}
    for k, v in metrics.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + str(k): v})
    return out


@pytest.mark.parametrize("seed", (0, 1))
def test_the_evaluators_equal_the_reference_and_the_plain_matchers(seed, plain_matchers):
    detections, annotations = _seeded_eval_inputs(seed, 4, with_crowd_labels=True)
    seg_dets, seg_anns = _segm_case(seed)
    voc_anns = [dict(a, bboxes_ignore=a["bboxes_ignore"][:1]) for a in annotations]
    runs = {
        "coco": lambda ev: ev.eval_coco_map(detections, annotations, 4),
        "segm": lambda ev: ev.eval_coco_segm_map(seg_dets, seg_anns, 3),
        "voc07": lambda ev: ev.eval_voc_map(detections, voc_anns, 4, use_07_metric=True),
        "voc": lambda ev: ev.eval_voc_map(detections, voc_anns, 4, use_07_metric=False),
    }
    got = {k: _flat(run(port_eval)) for k, run in runs.items()}
    want = {k: _flat(run(jax_eval)) for k, run in runs.items()}
    plain_matchers()
    plain = {k: _flat(run(port_eval)) for k, run in runs.items()}
    for k in runs:
        assert set(got[k]) == set(want[k]) == set(plain[k]), k
        for m in got[k]:
            assert abs(got[k][m] - want[k][m]) <= 1e-12, (k, m)
            assert abs(got[k][m] - plain[k][m]) <= 1e-12, (k, m)
    assert got["coco"]["mAP"] > 0 and got["segm"]["mAP"] > 0 and got["voc07"]["mAP"] > 0


def test_a_missing_compiler_raises(tmp_path, monkeypatch):
    """No fallback: without g++ the matcher's first use raises."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIBS", {})
    monkeypatch.setattr(native.shutil, "which", lambda _: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        eval_match.coco_match(np.zeros((1, 1)), np.zeros(1, bool), np.zeros(1, bool), THRS)
