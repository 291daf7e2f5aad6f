"""``MaxIoUAssigner``'s last two rules against the JAX package's:
``gt_max_assign_all=False`` (R16 pinned) and the ignore regions of
``ignore_iof_thr``; and R14, that no detector hands its assigner ignore
regions. The port assigns a (B, N) batch at once, the reference an image
at a time; the assignments and labels must be equal."""

import inspect
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_detection_tpu.models.detectors import faster_rcnn_loss as jax_faster_rcnn_loss
from torch_detection_tpu.models.detectors import retina_loss as jax_retina_loss
from torch_detection_tpu.ops.assign import MaxIoUAssigner as JaxMaxIoUAssigner
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.models.detectors import faster_rcnn_loss, retina_loss
from torch_detection_tpu_torch.ops.assign import MaxIoUAssigner


def _case(seed: int, shared: bool):
    """Two images of 30 anchors and 6 gts (the last two padding); with
    ``shared`` the gts are jittered copies of a few anchors, so that
    several gts name one best anchor; six ignore regions, two invalid."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (30, 2))
    anchors = np.concatenate([xy, xy + rng.uniform(4, 30, (30, 2))], 1).astype(np.float32)
    gt = np.zeros((2, 6, 4), np.float32)
    for i in range(2):
        if shared:
            picks = anchors[rng.integers(0, 4, 4)]
            gt[i, :4] = picks + rng.integers(-2, 3, (4, 4))
        else:
            g = rng.uniform(0, 50, (4, 2))
            gt[i, :4] = np.concatenate([g, g + rng.uniform(6, 25, (4, 2))], 1)
    valid = np.array([[True] * 4 + [False] * 2, [True, True, False, True, False, False]])
    gt[~valid] = 0
    labels = np.where(valid, rng.integers(1, 5, (2, 6)), 0).astype(np.int32)
    ig = rng.uniform(0, 60, (2, 6, 2))
    ignore = np.concatenate([ig, ig + rng.uniform(5, 40, (2, 6, 2))], -1).astype(np.float32)
    ignore_valid = np.array([[True] * 4 + [False] * 2] * 2)
    return anchors, gt, valid, labels, ignore, ignore_valid


def _both(kw, anchors, gt, valid, labels, ignore=None, ignore_valid=None):
    """The port's batched assignment and the reference's per image."""
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    got = MaxIoUAssigner(**kw)(t(anchors), t(gt), t(valid), t(labels), gt_boxes_ignore=t(ignore),
                               gt_ignore_valid=t(ignore_valid))
    want = [JaxMaxIoUAssigner(**kw)(
        jnp.asarray(anchors), jnp.asarray(gt[i]), jnp.asarray(valid[i]), jnp.asarray(labels[i]),
        gt_boxes_ignore=None if ignore is None else jnp.asarray(ignore[i]),
        gt_ignore_valid=None if ignore_valid is None else jnp.asarray(ignore_valid[i]))
        for i in range(gt.shape[0])]
    return got, want


@pytest.mark.parametrize("seed,shared,min_pos_iou",
                         [(0, True, 0.0), (1, True, 0.5), (2, False, 0.3), (3, True, 0.9)])
def test_gt_max_assign_all_false_matches_the_reference(seed, shared, min_pos_iou):
    """Each gt's first best anchor only, with gts that share a best anchor
    and gts that do not qualify (``min_pos_iou``), padding included."""
    kw = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=min_pos_iou, gt_max_assign_all=False)
    anchors, gt, valid, labels, _, _ = _case(seed, shared)
    got, want = _both(kw, anchors, gt, valid, labels)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got.assigned_gt_inds[i].numpy(),
                                      np.asarray(w.assigned_gt_inds))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(w.labels))
    if seed == 0:  # the first form differs: every tie takes its gt
        all_ties = MaxIoUAssigner(**dict(kw, gt_max_assign_all=True))(
            *(torch.from_numpy(a) for a in (anchors, gt, valid, labels)))
        assert not torch.equal(all_ties.assigned_gt_inds, got.assigned_gt_inds)


def test_a_later_gt_undoes_an_earlier_gts_best_anchor_pin_r16():
    """R16: the reference's scatter writes, for a gt that does not qualify,
    its best anchor's value from before rule 4, and on the CPU the last gt
    to name an anchor decides it. A padded gt's IoUs are all -1, so its
    best anchor is anchor 0: a valid gt whose best anchor is anchor 0 loses
    it to the padding after it, and a gt below ``min_pos_iou`` undoes an
    earlier gt's write to their shared anchor. The port gives the same."""
    anchors = np.array([[0, 0, 10, 10], [20, 20, 30, 30], [40, 40, 52, 52], [0, 0, 40, 40]],
                       np.float32)
    gt = np.array([[[0, 0, 12, 12], [20, 20, 31, 31], [17, 17, 33, 33], [0, 0, 0, 0]]],
                  np.float32)
    valid = np.array([[True, True, True, False]])
    labels = np.array([[1, 2, 3, 0]], np.int32)
    kw = dict(pos_iou_thr=0.9, neg_iou_thr=0.1, min_pos_iou=0.6, gt_max_assign_all=False)
    got, (want,) = _both(kw, anchors, gt, valid, labels)
    want = np.asarray(want.assigned_gt_inds)
    np.testing.assert_array_equal(got.assigned_gt_inds[0].numpy(), want)
    # gt 1 qualifies for anchor 1 (IoU 0.83), gt 2 shares it below 0.6 and writes back -1;
    # gt 0 qualifies for anchor 0 (IoU 0.72), the padded gt 3 writes back its -1
    assert want[0] == -1 and want[1] == -1
    kw["gt_max_assign_all"] = True  # every tie rule: both anchors keep their gts
    got_all, (want_all,) = _both(kw, anchors, gt, valid, labels)
    assert np.asarray(want_all.assigned_gt_inds)[:2].tolist() == [1, 2]
    np.testing.assert_array_equal(got_all.assigned_gt_inds[0].numpy(),
                                  np.asarray(want_all.assigned_gt_inds))


@pytest.mark.parametrize("with_valid", [True, False])
@pytest.mark.parametrize("assign_all", [True, False])
def test_ignore_regions_match_the_reference(with_valid, assign_all):
    """Rule 5: an anchor whose intersection over its own area with a valid
    ignore region reaches ``ignore_iof_thr`` is ignored, after rule 4."""
    anchors, gt, valid, labels, ignore, ignore_valid = _case(4, True)
    kw = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0, ignore_iof_thr=0.5,
              gt_max_assign_all=assign_all)
    got, want = _both(kw, anchors, gt, valid, labels, ignore, ignore_valid if with_valid else None)
    for i, w in enumerate(want):
        np.testing.assert_array_equal(got.assigned_gt_inds[i].numpy(),
                                      np.asarray(w.assigned_gt_inds))
    plain, _ = _both(dict(kw, ignore_iof_thr=-1.0), anchors, gt, valid, labels, ignore,
                     ignore_valid)
    newly = (got.assigned_gt_inds == -1) & (plain.assigned_gt_inds != -1)
    assert bool(newly.any())  # the rule took part


def test_no_detector_passes_ignore_regions_pin_r14(caplog):
    """R14: the reference's losses take no ignore regions, so
    ``ignore_iof_thr`` changes no assignment in its training; the port's
    losses neither. The builder builds the assigner with it and says so
    once; a RetinaNet loss is the same with and without it."""
    for fn in (jax_retina_loss, jax_faster_rcnn_loss, retina_loss, faster_rcnn_loss):
        assert not any("ignore" in p for p in inspect.signature(fn).parameters), fn
    builder._log_no_ignore_regions.cache_clear()
    with caplog.at_level(logging.INFO, logger="torch_detection_tpu_torch.builder"):
        cfgs = [builder.build_detection_cfg(dict(style="retina", assigner=dict(
            pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0, ignore_iof_thr=thr)))
            for thr in (0.5, 0.5, -1.0)]
    assert cfgs[0].assigner.ignore_iof_thr == 0.5
    assert sum("R14" in r.getMessage() for r in caplog.records) == 1
    gen = torch.Generator().manual_seed(0)
    sizes = [128 // s for s in (8, 16, 32, 64, 128)]
    cls = [torch.randn(2, k, k, 9 * 80, generator=gen) for k in sizes]
    reg = [torch.randn(2, k, k, 9 * 4, generator=gen) for k in sizes]
    gt = torch.tensor([[[4.0, 4, 40, 40], [20, 8, 60, 40]]] * 2)
    args = (cls, reg, gt, torch.tensor([[1, 3]] * 2), torch.ones(2, 2, dtype=torch.bool))
    with_rule, without = (retina_loss(cfgs[i], *args)["loss"] for i in (0, 2))
    assert torch.isfinite(with_rule) and torch.equal(with_rule, without)
