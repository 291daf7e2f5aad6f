"""The port's FoveaBox family against the JAX package's: ``FoveaHead``
(no ``scales``, no centerness: the state dict is the flax tree's exactly),
``fovea_targets``, ``fovea_loss`` with the gradients into the head and the
levels, ``decode_fovea``, one SGD step, ``make_inference_fn``, the
committed config, a full-width build and a ``Trainer`` step.

The detector, batch, weights and tolerances are ``test_torch_fcos.py``'s
(ResNet-18, FPN 32, one stacked GN conv of 32, 4 classes, 64 x 96, batch 2,
float32 on both sides), with ``FoveaHead``. The first image's gts 0 and 1
are one box twice (labels 3 and 1: the first of equal areas must win), and
its last gt is invalid; every gt's sqrt-area lies in the bands of the
canvas's first two levels, so both take positives. Labels exactly, the
log-space targets within one float32 ulp (a logarithm); head
outputs 1e-5; losses rtol 1e-5; gradients 1e-4 in relative norm; the
decode on equal inputs exactly in indices, labels and validity.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import (
    LEVEL_SIZES,
    IMG_SHAPES,
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    check_config,
    check_decode,
    check_full_width,
    check_head_outputs,
    check_loss_and_grads,
    check_sgd_step,
    check_trainer_step,
    dense_setup,
    gts,
    torch_batch,
)
from torch_detection_tpu.models.detectors import FoveaConfig as JaxFoveaConfig
from torch_detection_tpu.models.detectors import decode_fovea as jax_decode_fovea
from torch_detection_tpu.models.detectors import fovea_loss as jax_fovea_loss
from torch_detection_tpu.models.detectors.foveabox import _flat_geometry as jax_flat_geometry
from torch_detection_tpu.models.detectors.foveabox import fovea_targets as jax_fovea_targets
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models.detectors import (
    FoveaConfig,
    decode_fovea,
    fovea_loss,
    fovea_targets,
)
from torch_detection_tpu_torch.models.detectors.foveabox import flat_geometry

FOVEA_HEAD = dict(type="FoveaHead", num_classes=4, in_channels=32, feat_channels=32,
                  stacked_convs=1)
LOSS_KEYS = ("loss", "loss_cls", "loss_reg", "num_pos")


def jax_fovea(cfg, outs, batch):
    return jax_fovea_loss(cfg, *outs, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])


def port_fovea(outs, batch):
    b = torch_batch(batch) if isinstance(batch["gt_boxes"], np.ndarray) else batch
    return fovea_loss(FoveaConfig(num_classes=4), *outs, b["gt_boxes"], b["gt_labels"],
                      b["gt_valid"])


@pytest.fixture(scope="module")
def fovea_setup():
    return dense_setup(FOVEA_HEAD, JaxFoveaConfig(num_classes=4), jax_fovea)


def test_fovea_weights_load_and_head_outputs_match(fovea_setup):
    _, variables, model, _, want = fovea_setup
    assert set(variables["params"]["head"]) == {"cls_tower0", "reg_tower0", "cls_out", "reg_out"}
    assert model.head.scales is None and not hasattr(model.head, "ctr_out")
    check_head_outputs(model.eval(), want)


def test_fovea_targets_match_exactly():
    cfg, jcfg = FoveaConfig(num_classes=4), JaxFoveaConfig(num_classes=4)
    geometry = flat_geometry(cfg, LEVEL_SIZES)
    jax_geometry = jax_flat_geometry(jcfg, LEVEL_SIZES)
    for got, want in zip(geometry, jax_geometry, strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    g = gts()
    got = fovea_targets(cfg, *geometry,
                        *(torch.from_numpy(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
    targets = jax.jit(functools.partial(jax_fovea_targets, jcfg))
    for i in range(2):
        want = targets(*jax_geometry,
                       *(jnp.asarray(g[k][i]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
        np.testing.assert_array_equal(got[0][i].numpy(), np.asarray(want[0]))
        # a log: torch's CPU log and XLA's round a few values one float32
        # ulp apart
        np.testing.assert_array_max_ulp(got[1][i].numpy(), np.asarray(want[1]), maxulp=1)
    label0 = got[0][0].numpy()
    assert (label0 == 2).any() and not (label0 == 0).any()  # the duplicate's first label (3) wins
    assert (label0 == 1).any() and (label0 == 3).any()
    counts = np.cumsum([0] + [h * w for h, w in LEVEL_SIZES])
    assert all((label0[counts[i]:counts[i + 1]] >= 0).any() for i in range(2))  # two levels


def test_fovea_loss_and_gradients_match(fovea_setup):
    _, _, model, batch, want = fovea_setup
    check_loss_and_grads(model.train(), lambda outs: port_fovea(outs, batch), want, LOSS_KEYS)


def test_fovea_decode_matches(fovea_setup):
    check_decode(decode_fovea, jax_decode_fovea, FoveaConfig(num_classes=4),
                 JaxFoveaConfig(num_classes=4), fovea_setup[4]["outs"])


def test_fovea_sgd_step_matches_and_pins_r4(fovea_setup):
    _, _, model, batch, want = fovea_setup
    check_sgd_step(model, port_fovea, batch, want)


def test_fovea_inference_entry_point(fovea_setup):
    """``make_inference_fn`` reaches ``decode_fovea`` on the model's outputs."""
    _, _, model, batch, _ = fovea_setup
    model.eval()
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, FoveaConfig(num_classes=4))(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_fovea(FoveaConfig(num_classes=4), *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_fovea_trainer_step(fovea_setup):
    _, _, model, batch, _ = fovea_setup
    check_trainer_step(model, FoveaConfig(num_classes=4), batch, LOSS_KEYS)


def test_fovea_config_matches_the_reference():
    check_config("foveabox", FoveaConfig,
                 ("num_classes", "strides", "base_edges", "scale_ranges", "sigma", "focal_gamma",
                  "focal_alpha", "smooth_l1_beta", "reg_loss_weight", "score_thr", "nms_iou_thr",
                  "pre_select_per_level", "pre_nms_top_k", "max_detections"))


def test_fovea_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg, _ = check_full_width("foveabox", "FoveaHead", scales=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
