"""The port's GFL family against the JAX package's: ``integral``, the
aligned IoU, the assignment (``ATSSAssigner`` and the matched gts, as
``gfl_loss`` makes them), ``gfl_loss`` (QFL, GIoU, DFL) with the gradients
into the head and the levels, ``decode_gfl``, one SGD step, the committed
config and a full-width build.

The detector, batch, weights and tolerances are ``test_torch_fcos.py``'s
(ResNet-18, FPN 32, one stacked GN conv of 32, 4 classes, 64 x 96, batch 2,
float32 on both sides), with ``GFLHead`` at ``reg_max=8`` (the reference
tests' ``tests/test_gfl.py``) and one anchor a location. ``integral`` and the
IoU to 1e-6; the assignment exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_atss import ANCHOR, COUNTS, GRIDS, assign_case
from test_torch_fcos import (
    IMG_SHAPES,
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    check_config,
    check_decode,
    check_full_width,
    check_head_outputs,
    check_loss_and_grads,
    check_sgd_step,
    dense_setup,
    torch_batch,
)
from torch_detection_tpu.models.detectors import GFLConfig as JaxGFLConfig
from torch_detection_tpu.models.detectors import decode_gfl as jax_decode_gfl
from torch_detection_tpu.models.detectors import gfl_loss as jax_gfl_loss
from torch_detection_tpu.models.detectors import integral as jax_integral
from torch_detection_tpu.models.detectors.gfl import _aligned_iou as jax_aligned_iou
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.ops.assign import ATSSAssigner as JaxATSSAssigner
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models.detectors import GFLConfig, decode_gfl, gfl_loss, integral
from torch_detection_tpu_torch.models.detectors.atss import anchor_valid, assign_and_match
from torch_detection_tpu_torch.models.detectors.gfl import _aligned_iou
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator

GFL_HEAD = dict(type="GFLHead", num_classes=4, in_channels=32, feat_channels=32, stacked_convs=1,
                reg_max=8)


def port_cfg():
    return GFLConfig(num_classes=4, reg_max=8, anchor_generator=AnchorGenerator(**ANCHOR))


def jax_cfg():
    return JaxGFLConfig(num_classes=4, reg_max=8, anchor_generator=JaxAnchorGenerator(**ANCHOR))


@pytest.mark.parametrize("reg_max", [8, 16])
def test_integral_matches(rng, reg_max):
    logits = (2 * rng.normal(size=(3, 7, 4 * (reg_max + 1)))).astype(np.float32)
    got = integral(torch.from_numpy(logits), reg_max)
    want = jax_integral(jnp.asarray(logits), reg_max)
    assert got.shape == (3, 7, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6 * reg_max, rtol=0)


def test_aligned_iou_matches(rng):
    a = rng.uniform(0, 40, (50, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2] + rng.uniform(0, 20, (50, 2))
    b = a + rng.normal(0, 6, (50, 4)).astype(np.float32)
    b[:3] = [[0, 0, -5, -5], [10, 10, 10, 10], [0, 0, 0, 0]]  # degenerate boxes
    got = _aligned_iou(torch.from_numpy(a), torch.from_numpy(b))
    want = jax_aligned_iou(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


def test_gfl_assignment_matches_exactly():
    """``gfl_loss``'s assignment: the reference's assigner (its windowed
    path, as its loss calls it) and its matched gts against the port's."""
    boxes, labels, valid = assign_case("plain")
    flat = AnchorGenerator(**ANCHOR).flat_anchors([(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)])
    shapes = torch.from_numpy(IMG_SHAPES)
    label0, matched = assign_and_match(port_cfg().assigner, flat, COUNTS, torch.from_numpy(boxes),
                                       torch.from_numpy(labels), torch.from_numpy(valid), shapes)
    avalid = anchor_valid(flat, shapes)
    assign = jax.jit(functools.partial(JaxATSSAssigner(topk=9), level_counts=COUNTS,
                                       level_grids=GRIDS))
    for i in range(2):
        want = assign(anchors=jnp.asarray(flat.numpy()), gt_boxes=jnp.asarray(boxes[i]),
                      gt_valid=jnp.asarray(valid[i]), gt_labels=jnp.asarray(labels[i]),
                      anchor_valid=jnp.asarray(avalid[i].numpy()), img_hw=jnp.asarray(IMG_SHAPES[i]))
        inds = np.asarray(want.assigned_gt_inds)
        pos = inds > 0
        np.testing.assert_array_equal(label0[i].numpy(), np.where(pos, np.asarray(want.labels) - 1, -1))
        np.testing.assert_array_equal(matched[i].numpy(), boxes[i][np.clip(inds - 1, 0, None)])
    assert (label0 >= 0).sum() > 10


def jax_gfl(cfg, outs, batch):
    return jax_gfl_loss(cfg, *outs, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"],
                        img_shapes=batch["img_shape"])


def port_gfl(outs, batch):
    b = torch_batch(batch) if isinstance(batch["gt_boxes"], np.ndarray) else batch
    return gfl_loss(port_cfg(), *outs, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                    img_shapes=b["img_shape"])


@pytest.fixture(scope="module")
def gfl_setup():
    return dense_setup(GFL_HEAD, jax_cfg(), jax_gfl)


def test_gfl_head_outputs_match(gfl_setup):
    _, variables, model, _, want = gfl_setup
    assert "ctr_out" not in variables["params"]["head"]
    assert variables["params"]["head"]["reg_out"]["kernel"].shape[-1] == 4 * 9
    check_head_outputs(model.eval(), want)


def test_gfl_loss_and_gradients_match(gfl_setup):
    _, _, model, batch, want = gfl_setup
    check_loss_and_grads(model.train(), lambda outs: port_gfl(outs, batch), want,
                         ("loss", "loss_qfl", "loss_giou", "loss_dfl", "num_pos"))


def test_gfl_decode_matches(gfl_setup):
    check_decode(decode_gfl, jax_decode_gfl, port_cfg(), jax_cfg(), gfl_setup[4]["outs"])


def test_gfl_sgd_step_matches_and_pins_r4(gfl_setup):
    _, _, model, batch, want = gfl_setup
    check_sgd_step(model, port_gfl, batch, want)


def test_gfl_inference_entry_point(gfl_setup):
    _, _, model, batch, _ = gfl_setup
    model.eval()
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, port_cfg())(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_gfl(port_cfg(), *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_gfl_config_matches_the_reference():
    check_config("gfl", GFLConfig,
                 ("num_classes", "reg_max", "qfl_beta", "qfl_weight", "dfl_weight", "giou_weight",
                  "score_thr", "nms_iou_thr", "pre_select_per_level", "pre_nms_top_k",
                  "max_detections"),
                 (("anchor_generator", ("strides", "ratios", "resolved_scales",
                                        "num_base_anchors")), ("assigner", ("topk",))))


def test_gfl_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    from torch_detection_tpu_torch.builder import build_detector

    cfg, model = check_full_width("gfl", "GFLHead")
    assert model.head.reg_out.out_channels == 4 * 17 and not hasattr(model.head, "ctr_out")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
