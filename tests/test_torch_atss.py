"""The port's ATSS family against the JAX package's: ``ATSSAssigner``
against both of the reference's candidate paths (the windowed one its loss
takes and the full (G, N_l) top-k), ``atss_targets``, ``atss_loss`` with
the gradients into the head and the levels, ``decode_atss``, one SGD step,
the committed config and a full-width build.

The detector, batch, weights and tolerances are ``test_torch_fcos.py``'s
(ResNet-18, FPN 32, one stacked GN conv of 32, 4 classes, 64 x 96, batch 2,
float32 on both sides), with ``ATSSHead`` and one anchor a location
(``octave_base_scale=8``). The assignments must agree exactly, the
centerness targets to one float32 ulp (a square root). The assigner
cases put gt centres half a stride between anchor centres, where up to four
anchors of a level are equally near and the lower index must win, and hold
two copies of one gt and invalid gts.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import (
    IMG_SHAPES,
    LEVEL_SIZES,
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    check_config,
    check_decode,
    check_full_width,
    check_head_outputs,
    check_loss_and_grads,
    check_sgd_step,
    dense_setup,
    gts,
    torch_batch,
)
from torch_detection_tpu.models.detectors import ATSSConfig as JaxATSSConfig
from torch_detection_tpu.models.detectors import atss_loss as jax_atss_loss
from torch_detection_tpu.models.detectors import decode_atss as jax_decode_atss
from torch_detection_tpu.models.detectors.atss import atss_targets as jax_atss_targets
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.ops.assign import ATSSAssigner as JaxATSSAssigner
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models.detectors import (
    ATSSConfig,
    atss_loss,
    atss_targets,
    decode_atss,
)
from torch_detection_tpu_torch.models.detectors.atss import anchor_valid
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.ops.assign import ATSSAssigner

ANCHOR = dict(strides=(8, 16, 32, 64, 128), ratios=(1.0,), octave_base_scale=8.0,
              scales_per_octave=1)
ATSS_HEAD = dict(type="ATSSHead", num_classes=4, in_channels=32, feat_channels=32, stacked_convs=1)
COUNTS = tuple(h * w for h, w in LEVEL_SIZES)
GRIDS = tuple((h, w, float(s)) for (h, w), s in zip(LEVEL_SIZES, ANCHOR["strides"]))


def port_cfg():
    return ATSSConfig(num_classes=4, anchor_generator=AnchorGenerator(**ANCHOR))


def jax_cfg():
    return JaxATSSConfig(num_classes=4, anchor_generator=JaxAnchorGenerator(**ANCHOR))


def anchors():
    return AnchorGenerator(**ANCHOR).flat_anchors(LEVEL_SIZES)


def assign_case(case):
    """gts whose centres lie half a stride between anchor centres (ties of
    two and four), two copies of one gt, invalid rows."""
    g = gts()
    boxes = g["gt_boxes"].copy()
    boxes[0, 4] = [90, 90, 110, 110]  # an invalid row
    boxes[1, 1] = [0, 0, 24, 24]  # centre (12, 12): four level-0 anchors tie
    boxes[1, 2] = [20, 4, 92, 60]  # centre (56, 32): ties on level 1's x
    labels = g["gt_labels"].copy()
    labels[1, 1:3] = [4, 1]
    valid = g["gt_valid"].copy()
    valid[1, 1:3] = True
    if case == "no_gt":
        valid[1] = False
    return boxes, labels, valid


@pytest.mark.parametrize("case", ["plain", "no_gt"])
@pytest.mark.parametrize("masked", [False, True], ids=["all_anchors", "img_shape"])
def test_atss_assigner_matches_both_reference_paths(case, masked):
    boxes, labels, valid = assign_case(case)
    flat = anchors()
    shapes = torch.from_numpy(IMG_SHAPES)
    avalid = anchor_valid(flat, shapes) if masked else None
    got = ATSSAssigner(topk=9)(flat, COUNTS, torch.from_numpy(boxes), torch.from_numpy(valid),
                               torch.from_numpy(labels), avalid)
    ref = JaxATSSAssigner(topk=9)
    full = jax.jit(functools.partial(ref, level_counts=COUNTS))
    windowed = jax.jit(functools.partial(ref, level_counts=COUNTS, level_grids=GRIDS))
    for i in range(2):
        kw = dict(anchors=jnp.asarray(flat.numpy()), gt_boxes=jnp.asarray(boxes[i]),
                  gt_valid=jnp.asarray(valid[i]), gt_labels=jnp.asarray(labels[i]))
        if masked:
            kw.update(anchor_valid=jnp.asarray(avalid[i].numpy()), img_hw=jnp.asarray(IMG_SHAPES[i]))
        for path, fn in (("full", full), ("windowed", windowed)):
            want = fn(**kw)
            for field in ("assigned_gt_inds", "labels"):
                np.testing.assert_array_equal(getattr(got, field)[i].numpy(),
                                              np.asarray(getattr(want, field)), err_msg=path)
            np.testing.assert_allclose(got.max_overlaps[i].numpy(), np.asarray(want.max_overlaps),
                                       atol=1e-6, rtol=0, err_msg=path)
    assigned = got.assigned_gt_inds.numpy()
    assert (assigned[0] == 1).any() and not (assigned[0] == 2).any()  # the duplicate's first
    if case == "plain":
        assert (assigned[1] == 2).any() and (assigned[1] == 3).any()
    else:
        assert not (assigned[1] > 0).any()
    if masked:
        assert (assigned[1] == -1).any() and not (assigned[0] == -1).any()


def test_atss_targets_match_exactly():
    boxes, labels, valid = assign_case("plain")
    flat = anchors()
    shapes = torch.from_numpy(IMG_SHAPES)
    got = atss_targets(port_cfg(), flat, COUNTS, torch.from_numpy(boxes), torch.from_numpy(labels),
                       torch.from_numpy(valid), shapes)
    targets = jax.jit(functools.partial(jax_atss_targets, jax_cfg(), level_counts=COUNTS,
                                        level_grids=GRIDS))
    avalid = anchor_valid(flat, shapes)
    for i in range(2):
        want = targets(anchors=jnp.asarray(flat.numpy()), anchor_valid=jnp.asarray(avalid[i].numpy()),
                       gt_boxes=jnp.asarray(boxes[i]), gt_labels=jnp.asarray(labels[i]),
                       gt_valid=jnp.asarray(valid[i]), img_hw=jnp.asarray(IMG_SHAPES[i]))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1][i].numpy(), np.asarray(want[1]))
        # torch's vectorised CPU square root rounds a near half-way case the
        # other way from XLA's (sqrt(0.5538462) -> 0.7442084, where the
        # correctly rounded value is 0.74420846): one float32 ulp
        np.testing.assert_array_max_ulp(got[2][i].numpy(), np.asarray(want[2]), maxulp=1)
    assert (got[0] >= 0).sum() > 10


def jax_atss(cfg, outs, batch):
    return jax_atss_loss(cfg, *outs, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
                         img_shapes=batch["img_shape"])


def port_atss(outs, batch):
    b = torch_batch(batch) if isinstance(batch["gt_boxes"], np.ndarray) else batch
    return atss_loss(port_cfg(), *outs, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                     img_shapes=b["img_shape"])


@pytest.fixture(scope="module")
def atss_setup():
    return dense_setup(ATSS_HEAD, jax_cfg(), jax_atss)


def test_atss_head_outputs_match(atss_setup):
    check_head_outputs(atss_setup[2].eval(), atss_setup[4])


def test_atss_loss_and_gradients_match(atss_setup):
    _, _, model, batch, want = atss_setup
    check_loss_and_grads(model.train(), lambda outs: port_atss(outs, batch), want,
                         ("loss", "loss_cls", "loss_reg", "loss_centerness", "num_pos"))


def test_atss_decode_matches(atss_setup):
    check_decode(decode_atss, jax_decode_atss, port_cfg(), jax_cfg(), atss_setup[4]["outs"])


def test_atss_sgd_step_matches_and_pins_r4(atss_setup):
    _, _, model, batch, want = atss_setup
    check_sgd_step(model, port_atss, batch, want)


def test_atss_inference_entry_point(atss_setup):
    _, _, model, batch, _ = atss_setup
    model.eval()
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, port_cfg())(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_atss(port_cfg(), *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_atss_config_matches_the_reference():
    cfg = check_config("atss", ATSSConfig,
                       ("num_classes", "target_means", "target_stds", "focal_gamma", "focal_alpha",
                        "reg_loss_weight", "score_thr", "nms_iou_thr", "pre_select_per_level",
                        "pre_nms_top_k", "max_detections"),
                       (("anchor_generator", ("strides", "ratios", "resolved_scales",
                                              "num_base_anchors")), ("assigner", ("topk",))))
    assert isinstance(cfg.assigner, ATSSAssigner) and cfg.anchor_generator.num_base_anchors == 1


def test_atss_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    from torch_detection_tpu_torch.builder import build_detector

    cfg, _ = check_full_width("atss", "ATSSHead")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
