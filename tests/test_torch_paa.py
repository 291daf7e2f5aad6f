"""The port's PAA family against the JAX package's: ``PAAHead`` (ATSS's
tree), ``paa_reassign`` exactly on seeded losses (ties, levels of fewer
anchors than ``topk``, a gt with no candidates, an invalid gt), the loose
MaxIoU assignment and the candidate losses, ``paa_loss`` with the
gradients into the head and the levels, ``decode_paa`` with and without
score voting, one SGD step, ``make_inference_fn``, the committed config
(its merged ``assigner`` carries ATSS's ``topk``, dropped as the
reference drops it), a full-width build and a ``Trainer`` step.

The detector, batch, weights and tolerances are ``test_torch_fcos.py``'s
(ResNet-18, FPN 32, one stacked GN conv of 32, 4 classes, 64 x 96, batch 2,
float32 on both sides), with ``PAAHead`` and one anchor a location; the
canvas's last three levels hold 6, 2 and 1 anchors, fewer than ``topk``
(9). Assignments and reassignments exactly; candidate losses 1e-6 of
max(1, |want|); losses rtol 1e-5; gradients 1e-4 in relative norm; the
decode on equal inputs exactly in indices, labels and validity, scores
1e-6, boxes (voted or not) 1e-4 px.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import (
    CONFIGS,
    IMG_SHAPES,
    LEVEL_SIZES,
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    check_config,
    check_full_width,
    check_head_outputs,
    check_loss_and_grads,
    check_sgd_step,
    check_trainer_step,
    close,
    dense_setup,
    gts,
    torch_batch,
)
from torch_detection_tpu.models.detectors import PAAConfig as JaxPAAConfig
from torch_detection_tpu.models.detectors import decode_paa as jax_decode_paa
from torch_detection_tpu.models.detectors import paa_loss as jax_paa_loss
from torch_detection_tpu.models.detectors import paa_reassign as jax_paa_reassign
from torch_detection_tpu.models.detectors.paa import _aligned_giou as jax_aligned_giou
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.ops.boxes import delta2bbox as jax_delta2bbox
from torch_detection_tpu.ops.losses import _focal_sparse_elem as jax_focal_sparse_elem
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models.detectors import (
    PAAConfig,
    decode_paa,
    paa_loss,
    paa_reassign,
)
from torch_detection_tpu_torch.models.detectors.paa import candidate_losses, initial_assignment
from torch_detection_tpu_torch.models.detectors.fcos import flatten_outputs
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.ops.assign import MaxIoUAssigner
from torch_detection_tpu_torch.utils.config import Config

ANCHOR = dict(strides=(8, 16, 32, 64, 128), ratios=(1.0,), octave_base_scale=8.0,
              scales_per_octave=1)
PAA_HEAD = dict(type="PAAHead", num_classes=4, in_channels=32, feat_channels=32, stacked_convs=1)
COUNTS = tuple(h * w for h, w in LEVEL_SIZES)
LOSS_KEYS = ("loss", "loss_cls", "loss_reg", "loss_iou", "num_pos")


def port_cfg(**kw):
    return PAAConfig(num_classes=4, anchor_generator=AnchorGenerator(**ANCHOR), **kw)


def jax_cfg(**kw):
    return JaxPAAConfig(num_classes=4, anchor_generator=JaxAnchorGenerator(**ANCHOR), **kw)


def jax_paa(cfg, outs, batch):
    return jax_paa_loss(cfg, *outs, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
                        img_shapes=batch["img_shape"])


def port_paa(outs, batch):
    b = torch_batch(batch) if isinstance(batch["gt_boxes"], np.ndarray) else batch
    return paa_loss(port_cfg(), *outs, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                    img_shapes=b["img_shape"])


@pytest.fixture(scope="module")
def paa_setup():
    return dense_setup(PAA_HEAD, jax_cfg(), jax_paa)


def reassign_case(seed):
    """Bimodal seeded losses (PAA's regime) on the canvas's anchors, a
    third of them repeated (ties); gts 0-3 valid, gt 2 with no anchor, gt
    4 invalid with anchors; the last three levels hold fewer than 9."""
    rng = np.random.default_rng(seed)
    n, g = sum(COUNTS), 5
    loss = np.where(rng.uniform(size=(2, n)) < 0.5, rng.normal(0.3, 0.05, (2, n)),
                    rng.normal(4.0, 0.3, (2, n))).astype(np.float32)
    tie = rng.uniform(size=(2, n)) < 0.3
    loss[tie] = np.roll(loss, 1, axis=1)[tie]
    assigned = rng.integers(-1, g + 1, (2, n)).astype(np.int32)
    assigned[assigned == 3] = 0  # gt 2 (index 3) takes no anchor
    assigned[:, -9:] = np.tile([1, 2, 4, 5, 1, 2, 4, 5, 1], (2, 1))  # the small levels
    valid = np.array([[True, True, True, True, False]] * 2)
    return loss, assigned, valid


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paa_reassign_matches_exactly(seed):
    loss, assigned, valid = reassign_case(seed)
    got = paa_reassign(port_cfg(), torch.from_numpy(loss), torch.from_numpy(assigned),
                       torch.from_numpy(valid), COUNTS)
    reassign = jax.jit(lambda lo, a, v: jax_paa_reassign(jax_cfg(), lo, a, v, COUNTS))
    for i in range(2):
        want = np.asarray(reassign(loss[i], assigned[i], valid[i]))
        np.testing.assert_array_equal(got[i].numpy(), want)
    out = got.numpy()
    assert all((out == gi).any() for gi in (1, 2, 4))  # the valid gts with anchors get positives
    assert not (out == 3).any() and not (out == 5).any()  # no anchor; invalid
    assert ((out > 0) <= (assigned > 0)).all()


def test_paa_assignment_and_candidate_losses_match(paa_setup):
    """The loose MaxIoU assignment exactly (the valid anchors from
    ``img_shape``) and the detached candidate losses on the JAX side's head
    outputs, against the reference's per-image forms."""
    cfg, jcfg = port_cfg(), jax_cfg()
    outs = paa_setup[4]["outs"]
    g = gts()
    anchors = cfg.anchor_generator.flat_anchors(LEVEL_SIZES)
    tb = torch_batch(dict(g, img_shape=IMG_SHAPES))
    assigned, matched, label0 = initial_assignment(cfg, anchors, tb["gt_boxes"], tb["gt_labels"],
                                                   tb["gt_valid"], tb["img_shape"])
    fc, fr, _ = flatten_outputs(4, *(tuple(torch.from_numpy(o) for o in branch)
                                     for branch in outs))
    loss = candidate_losses(cfg, anchors, fc, fr, matched, label0)
    janchors = jnp.asarray(anchors.numpy())
    cx, cy = (janchors[:, 0] + janchors[:, 2]) * 0.5, (janchors[:, 1] + janchors[:, 3]) * 0.5
    for i in range(2):
        h, w = IMG_SHAPES[i]
        want = jcfg.assigner(janchors, jnp.asarray(g["gt_boxes"][i]), jnp.asarray(g["gt_valid"][i]),
                             jnp.asarray(g["gt_labels"][i]), anchor_valid=(cx < w) & (cy < h))
        np.testing.assert_array_equal(assigned[i].numpy(), np.asarray(want.assigned_gt_inds))
    # the reference's candidate loss, as its paa_loss computes it
    cls_elem = jnp.sum(jax_focal_sparse_elem(jnp.asarray(fc.numpy()),
                                             jnp.asarray(label0.numpy()), 2.0, 0.25), axis=-1)
    decoded = jax_delta2bbox(janchors, jnp.asarray(fr.numpy()), jcfg.target_means,
                             jcfg.target_stds, wh_ratio_clip=16 / 1000)
    want = cls_elem + (1.0 - jax_aligned_giou(decoded, jnp.asarray(matched.numpy())))
    close(loss.numpy(), want, 1e-6, "candidate losses")
    assert (assigned > 0).sum() > 10 and (assigned == -1).any()


def test_paa_head_outputs_match(paa_setup):
    check_head_outputs(paa_setup[2].eval(), paa_setup[4])


def test_paa_loss_and_gradients_match(paa_setup):
    _, _, model, batch, want = paa_setup
    check_loss_and_grads(model.train(), lambda outs: port_paa(outs, batch), want, LOSS_KEYS)


@pytest.mark.parametrize("voting", [True, False], ids=["voting", "no_voting"])
def test_paa_decode_matches(paa_setup, voting):
    outs = paa_setup[4]["outs"]
    shapes, scale = IMG_SHAPES, np.array([2.0, 1.5], np.float32)
    want = jax.jit(functools.partial(jax_decode_paa, jax_cfg(score_voting=voting)))(
        *outs, img_shapes=jnp.asarray(shapes), scale_factors=jnp.asarray(scale))
    got = decode_paa(port_cfg(score_voting=voting), *jax.tree_util.tree_map(torch.from_numpy, outs),
                     torch.from_numpy(shapes), torch.from_numpy(scale))
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.valid.sum()) > 10
    close(got.scores.numpy(), want.scores, 1e-6, "scores")
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4, rtol=0)
    if voting:  # the voting moved boxes
        plain = decode_paa(port_cfg(score_voting=False),
                           *jax.tree_util.tree_map(torch.from_numpy, outs),
                           torch.from_numpy(shapes), torch.from_numpy(scale))
        assert not torch.equal(plain.boxes[got.valid], got.boxes[got.valid])


def test_paa_sgd_step_matches_and_pins_r4(paa_setup):
    _, _, model, batch, want = paa_setup
    check_sgd_step(model, port_paa, batch, want)


def test_paa_inference_entry_point(paa_setup):
    _, _, model, batch, _ = paa_setup
    model.eval()
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, port_cfg())(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_paa(port_cfg(), *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_paa_trainer_step(paa_setup):
    _, _, model, batch, _ = paa_setup
    check_trainer_step(model, port_cfg(), batch, LOSS_KEYS)


def test_paa_config_drops_atss_topk_as_the_reference():
    """``_base_`` the ATSS config merges ATSS's ``assigner=dict(topk=9)``
    into PAA's; both builders keep MaxIoUAssigner's fields only."""
    merged = Config.fromfile(CONFIGS / "paa_r50_fpn_coco.py").detection["assigner"]
    assert dict(merged) == {"topk": 9, "pos_iou_thr": 0.1, "neg_iou_thr": 0.1, "min_pos_iou": 0.0}
    cfg = check_config("paa", PAAConfig,
                       ("num_classes", "target_means", "target_stds", "topk", "gmm_iters",
                        "focal_gamma", "focal_alpha", "reg_loss_weight", "iou_loss_weight",
                        "score_thr", "nms_iou_thr", "pre_select_per_level", "pre_nms_top_k",
                        "max_detections", "score_voting", "voting_sigma"),
                       (("anchor_generator", ("strides", "ratios", "resolved_scales",
                                              "num_base_anchors")),
                        ("assigner", ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"))))
    assert cfg.assigner == MaxIoUAssigner(0.1, 0.1, 0.0) and cfg.topk == 9


def test_paa_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg, _ = check_full_width("paa", "PAAHead")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
