"""The port's FreeAnchor family against the JAX package's:
``free_anchor_loss`` with the gradients into the head and the levels (with
and without padded gt rows), the ``scatter_reduce`` form of the per-class
ramp maximum against the reference's loop over the gts bit for bit, the
bag's top-k against XLA's on IoU ties at the k-th place, one SGD step,
RetinaNet's inference through ``make_inference_fn``, the committed config
(the R1 pin: the reference's builder raises on it), a full-width build and
a ``Trainer`` step.

The detector, batch, weights and tolerances are ``test_torch_fcos.py``'s
(ResNet-18, FPN 32, 4 classes, 64 x 96, batch 2, float32 on both sides),
with a ``RetinaHead`` of one conv of 32 and 9 anchors. The reference's
``FreeAnchorConfig`` is built directly (R1). Losses rtol 1e-5; gradients
1e-4 in relative norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import (
    CONFIGS,
    IMG_SHAPES,
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    batch_of,
    check_head_outputs,
    check_loss_and_grads,
    check_reference_tree,
    check_sgd_step,
    check_trainer_step,
    dense_setup,
    torch_batch,
)
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import FreeAnchorConfig as JaxFreeAnchorConfig
from torch_detection_tpu.models.detectors import free_anchor_loss as jax_free_anchor_loss
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.ops.assign import MaxIoUAssigner as JaxMaxIoUAssigner
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models.detectors import (
    FreeAnchorConfig,
    RetinaNetConfig,
    decode_detections,
    free_anchor_loss,
)
from torch_detection_tpu_torch.models.detectors.free_anchor import object_box_max
from torch_detection_tpu_torch.ops.nms import top_k_stable
from torch_detection_tpu_torch.utils.config import Config

RETINA_HEAD = dict(type="RetinaHead", num_classes=4, in_channels=32, feat_channels=32,
                   stacked_convs=1, num_base_anchors=9)
LOSS_KEYS = ("loss", "loss_pos", "loss_neg", "num_pos")
CONFIG = CONFIGS / "free_anchor_r50_fpn_coco.py"


def jax_free_anchor(cfg, outs, batch):
    return jax_free_anchor_loss(cfg, *outs, batch["gt_boxes"], batch["gt_labels"],
                                batch["gt_valid"])


def port_free_anchor(outs, batch):
    b = torch_batch(batch) if isinstance(batch["gt_boxes"], np.ndarray) else batch
    return free_anchor_loss(FreeAnchorConfig(num_classes=4), *outs, b["gt_boxes"],
                            b["gt_labels"], b["gt_valid"])


def tight_batch(rng):
    """The harness's batch cut to 4 gt rows: the first image's are all
    valid, the second's one of four."""
    batch = batch_of(rng)
    for k in ("gt_boxes", "gt_labels", "gt_valid"):
        batch[k] = batch[k][:, :4]
    batch["gt_valid"][0, 3] = True
    return batch


@pytest.fixture(scope="module", params=["padded", "tight"])
def free_anchor_setup(request):
    make_batch = batch_of if request.param == "padded" else tight_batch
    return dense_setup(RETINA_HEAD, JaxFreeAnchorConfig(num_classes=4), jax_free_anchor,
                       make_batch=make_batch)


def test_free_anchor_head_outputs_match(free_anchor_setup):
    check_head_outputs(free_anchor_setup[2].eval(), free_anchor_setup[4])


def test_free_anchor_loss_and_gradients_match(free_anchor_setup):
    _, _, model, batch, want = free_anchor_setup
    check_loss_and_grads(model.train(), lambda outs: port_free_anchor(outs, batch), want,
                         LOSS_KEYS)


def test_free_anchor_sgd_step_matches_and_pins_r4(free_anchor_setup):
    _, _, model, batch, want = free_anchor_setup
    check_sgd_step(model, port_free_anchor, batch, want)


def test_free_anchor_trainer_step_reaches_its_own_loss(free_anchor_setup):
    """``build_loss_fn`` on a ``FreeAnchorConfig`` trains on
    ``free_anchor_loss`` (its keys), not on RetinaNet's loss."""
    _, _, model, batch, _ = free_anchor_setup
    record = check_trainer_step(model, FreeAnchorConfig(num_classes=4), batch, LOSS_KEYS)
    assert "loss_cls" not in record and "loss_reg" not in record


def reference_objmax(box_prob, label0, valid):
    """The reference's form: a loop over the gts of (G, N) maxima of the
    ramps of the gts that share a label, one image at a time."""
    out = []
    for bp, lab, v in zip(box_prob, label0, valid):
        eq = (lab[:, None] == lab[None, :]) & v[:, None] & v[None, :]
        objmax = torch.zeros_like(bp)
        for g in range(lab.shape[0]):
            objmax = torch.maximum(objmax, torch.where(eq[:, g][:, None], bp[g][None, :], 0.0))
        out.append(objmax)
    return torch.stack(out)


@pytest.mark.parametrize("ties", [False, True])
def test_objmax_scatter_equals_the_reference_loop(rng, ties):
    """Shared labels, invalid rows (label 0 after the clamp), zero ramps
    and, with ``ties``, ramps on a coarse grid: the same bits."""
    b, g, n, c = 3, 7, 50, 5
    box_prob = rng.uniform(-0.5, 1.0, (b, g, n)).clip(0.0, None).astype(np.float32)
    if ties:
        box_prob = np.round(box_prob * 4) / 4
    valid = rng.uniform(size=(b, g)) > 0.25
    label0 = rng.integers(0, c, (b, g))
    label0[~valid] = 0
    box_prob[~valid] = 0.0
    bp, lab, v = torch.from_numpy(box_prob), torch.from_numpy(label0), torch.from_numpy(valid)
    got = object_box_max(bp, lab, c)
    want = reference_objmax(bp, lab, v)
    # the reference's objmax of an invalid gt is 0; its correction is
    # masked by ``first`` (valid), so only the valid rows must agree
    assert torch.equal(got[v], want[v])
    assert (got[v] > 0).any() and int((lab[v][:, None] == lab[v][None, :]).sum()) > int(v.sum())


def test_bag_top_k_matches_xla_on_ties_at_the_kth_place(rng):
    """IoUs on a grid of eighths: each row's k-th place falls inside a run
    of equal values, and the lower indices must fill the bag, as XLA's
    ``top_k`` fills it."""
    iou = (rng.integers(0, 8, (2, 6, 300)) / 8).astype(np.float32)
    k = 50
    got = top_k_stable(torch.from_numpy(iou), k)[1]  # the bag's top-k
    _, want = jax.lax.top_k(jnp.asarray(iou), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    kth = np.take_along_axis(iou, np.asarray(want)[..., -1:], -1)
    assert ((iou == kth).sum(-1) > (np.sort(iou, -1)[..., ::-1][..., :k] == kth).sum(-1)).all()


def test_free_anchor_inference_is_retinanets(free_anchor_setup):
    """``make_inference_fn`` sends a ``FreeAnchorConfig`` to RetinaNet's
    decode on the model's outputs."""
    _, _, model, batch, _ = free_anchor_setup
    model.eval()
    cfg = FreeAnchorConfig(num_classes=4)
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, cfg)(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_detections(cfg, *model(image), shapes, torch.ones(2))
    assert int(want.valid.sum()) > 10
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_free_anchor_config_builds_and_pins_r1():
    """The reference's ``build_detection_cfg`` raises ``UnboundLocalError``
    on the committed config (R1: a function-local ``MaxIoUAssigner``
    import); the port builds it, field for field the reference's dataclass
    made from the same keys."""
    det = Config.fromfile(CONFIG).detection
    with pytest.raises(UnboundLocalError):
        jax_builder.build_detection_cfg(dict(det))
    got = build_detection_cfg(det)
    assert isinstance(got, FreeAnchorConfig) and isinstance(got, RetinaNetConfig)
    d = dict(det)
    anchor, assigner = d.pop("anchor"), d.pop("assigner")
    d.pop("style")
    want = JaxFreeAnchorConfig(
        anchor_generator=JaxAnchorGenerator(**{k: tuple(v) if isinstance(v, list) else v
                                               for k, v in anchor.items()}),
        assigner=JaxMaxIoUAssigner(**assigner), **{k: tuple(v) if isinstance(v, list) else v
                                                   for k, v in d.items()})
    for field in ("num_classes", "target_means", "target_stds", "focal_gamma", "focal_alpha",
                  "smooth_l1_beta", "reg_loss_weight", "score_thr", "nms_iou_thr",
                  "pre_select_per_level", "pre_nms_top_k", "max_detections", "pre_anchor_topk",
                  "bbox_thr", "bag_gamma", "bag_alpha", "loc_loss_weight"):
        assert getattr(got, field) == getattr(want, field), field
    for field in ("strides", "ratios", "resolved_scales", "num_base_anchors"):
        assert getattr(got.anchor_generator, field) == getattr(want.anchor_generator, field)
    for field in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
        assert getattr(got.assigner, field) == getattr(want.assigner, field), field
    assert not want.approx_top_k


def test_free_anchor_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert type(model.head).__name__ == "RetinaHead"
    check_reference_tree(cfg, model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
