"""The port's Cascade R-CNN and Cascade Mask R-CNN against the JAX package's:
weights, stage assigners, inference, the losses with every gradient, the
gt-block rule between stages, the detection configs and a training step
through ``Trainer``.

The detectors are ``test_torch_mask_rcnn.py``'s with three box stages (and
three mask heads): ResNet-18 with ``frozen_stages=1``, FPN 16 channels, box
heads fc 32, 3 classes, mask heads of one conv at RoI 7 and mask 14, on
64 x 64 images, batch 2, randomised FrozenBN. Both sides run in float32 on
the CPU, the port on the JAX variables converted by ``from_jax_variables``
and loaded with ``strict=True``.

The sampling draws are the reference's own: ``jax.random.split(key, B * (1
+ S))``, an image's keys for the RPN and then each stage, each split into
``k_pos, k_all``; the Cascade Mask R-CNN's mask slates take none.
Tolerances: detections as ``test_torch_model.py`` (identical ``valid`` and
``labels``, boxes 1e-3, scores 1e-5), ``mask_probs`` atol 1e-5; losses
rtol 1e-5; gradients atol = rtol = 1e-4 (the convolutions sum in another
order).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mask_rcnn import MASK_MODEL, _batch, _Loader
from test_torch_model import ANCHORS, _randomise_frozen_bn
from test_torch_train import GRAD_TOL, FixedNoise, _is_frozen, _jax_draws
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import CascadeMaskRCNN as JaxCascadeMaskRCNN
from torch_detection_tpu.models.detectors import CascadeMaskRCNNConfig as JaxCascadeMaskConfig
from torch_detection_tpu.models.detectors import CascadeRCNN as JaxCascadeRCNN
from torch_detection_tpu.models.detectors import CascadeRCNNConfig as JaxCascadeRCNNConfig
from torch_detection_tpu.models.detectors import (
    cascade_mask_rcnn_inference as jax_cascade_mask_rcnn_inference,
)
from torch_detection_tpu.models.detectors import cascade_mask_rcnn_loss as jax_cascade_mask_loss
from torch_detection_tpu.models.detectors import cascade_rcnn_inference as jax_cascade_inference
from torch_detection_tpu.models.detectors import cascade_rcnn_loss as jax_cascade_rcnn_loss
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule, make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    CascadeMaskRCNN,
    CascadeMaskRCNNConfig,
    CascadeRCNN,
    CascadeRCNNConfig,
    MaskDetections,
    cascade_mask_rcnn_inference,
    cascade_mask_rcnn_loss,
    cascade_rcnn_inference,
    cascade_rcnn_loss,
)
from torch_detection_tpu_torch.models.detectors.cascade_rcnn import (
    _cascade_rcnn_loss_core,
    next_candidates,
)
from torch_detection_tpu_torch.models.detectors.two_stage import SampledRois
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.parallel import make_optimizer
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CASCADE_MODEL = {k: v for k, v in MASK_MODEL.items() if k != "mask_head"}
CASCADE_MASK_MODEL = dict(MASK_MODEL)
PROPOSALS = dict(pre_nms_per_level=64, post_nms_top_k=32)
DET = dict(num_classes=3, rpn_num_samples=32, rcnn_num_samples=32, max_detections=8)
MASK_DET = dict(DET, mask_roi_size=7, mask_size=14)  # mask slates of 32 * 0.25 = 8 rois an image
STAGES = 3


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as ``test_torch_train.py``: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(key):
    """The reference's draws of one cascade step: the RPN's anchors, then
    stage 0's P + G and the later stages' R + G candidates."""
    n_anchors = sum(3 * (64 // s) ** 2 for s in ANCHORS["strides"])
    cand = PROPOSALS["post_nms_top_k"] + 4
    return _jax_draws(key, 2, (n_anchors, cand, min(DET["rcnn_num_samples"], cand) + 4,
                               min(DET["rcnn_num_samples"], cand) + 4))


def _reference(jax_model, jax_cfg, loss, inference, variables, batch, x, key):
    """The reference's losses, gradients and detections."""
    def loss_fn(params, batch):
        out = loss(jax_cfg, jax_model, {"params": params, "batch_stats": variables["batch_stats"]},
                   batch, key)
        return out["loss"], out

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], batch)
    infer = jax.jit(lambda v, *a: inference(jax_cfg, jax_model, v, *a))
    dets = infer(variables, x["images"], x["img_shapes"], x["scale_factors"])
    return dict(losses={k: float(v) for k, v in losses.items()}, grads=grads,
                dets=jax.tree_util.tree_map(np.asarray, dets))


@pytest.fixture(scope="module")
def cascade():
    """Both families on the same weights (the Cascade R-CNN's are the
    Cascade Mask R-CNN's without the mask heads), the reference's results
    for each, and the port's builds."""
    rng = np.random.default_rng(0)
    jax_mask_model = JaxCascadeMaskRCNN(**CASCADE_MASK_MODEL, num_stages=STAGES)
    jax_model = JaxCascadeRCNN(**CASCADE_MODEL, num_stages=STAGES)
    proposals = JaxProposalConfig(**PROPOSALS)
    anchors = JaxAnchorGenerator(**ANCHORS)
    jax_cfg = JaxCascadeRCNNConfig(anchor_generator=anchors, proposal_train=proposals,
                                   proposal_test=proposals, **DET)
    jax_mask_cfg = JaxCascadeMaskConfig(anchor_generator=anchors, proposal_train=proposals,
                                        proposal_test=proposals, **MASK_DET)
    variables = jax.jit(jax_mask_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    feats = jnp.zeros((2, 8, 7, 7, 16))
    extra = [jax_mask_model.init(jax.random.PRNGKey(k), feats, method=m)["params"]
             for k, m in ((1, JaxCascadeMaskRCNN.roi_forward_all),
                          (2, JaxCascadeMaskRCNN.mask_forward_all))]
    mask_vars = _randomise_frozen_bn(
        {"params": {**variables["params"], **extra[0], **extra[1]},
         "batch_stats": variables["batch_stats"]},
        rng,
    )
    box_vars = {"params": {k: v for k, v in mask_vars["params"].items()
                           if not k.startswith("mask_head")},
                "batch_stats": mask_vars["batch_stats"]}
    batch = _batch(rng)
    x = dict(images=rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
             img_shapes=np.array([[64, 64], [60, 56]], np.float32),
             scale_factors=np.array([1.0, 2.0], np.float32))
    key = jax.random.PRNGKey(7)
    box_batch = {k: v for k, v in batch.items() if k != "gt_masks"}
    want = dict(
        box=_reference(jax_model, jax_cfg, jax_cascade_rcnn_loss, jax_cascade_inference,
                       box_vars, box_batch, x, key),
        mask=_reference(jax_mask_model, jax_mask_cfg, jax_cascade_mask_loss,
                        jax_cascade_mask_rcnn_inference, mask_vars, batch, x, key),
        draws=_draws(key),
    )
    port = dict(anchor_generator=AnchorGenerator(**ANCHORS),
                proposal_train=ProposalConfig(**PROPOSALS),
                proposal_test=ProposalConfig(**PROPOSALS))

    def make(cls, model_cfg, variables):
        def make_model():
            model = cls(**model_cfg, num_stages=STAGES, device="cpu")
            model.load_state_dict(from_jax_variables(variables, model), strict=True)
            return model.to(memory_format=torch.channels_last).train()
        return make_model

    return dict(
        box=(make(CascadeRCNN, CASCADE_MODEL, box_vars), CascadeRCNNConfig(**port, **DET),
             box_vars),
        mask=(make(CascadeMaskRCNN, CASCADE_MASK_MODEL, mask_vars),
              CascadeMaskRCNNConfig(**port, **MASK_DET), mask_vars),
        batch={k: torch.from_numpy(v) for k, v in batch.items()},
        x={k: torch.from_numpy(v) for k, v in x.items()},
        want=want,
    )


def _grads(want, model):
    return from_jax_variables({"params": want["grads"]}, model)


def test_state_dict_keys_are_the_flax_paths(cascade):
    for family, heads in (("box", ("bbox_head",)), ("mask", ("bbox_head", "mask_head"))):
        make_model, _, variables = cascade[family]
        keys = set(make_model().state_dict())
        assert keys == set(from_jax_variables(variables, make_model()))
        for head in heads:
            assert all(any(k.startswith(f"{head}{t}.") for k in keys) for t in range(STAGES))
            assert not any(k.startswith(f"{head}.") for k in keys), head
    assert {"mask_head2.upsample.weight", "bbox_head1.fc1.weight"} <= keys


def test_class_specific_regression_is_refused():
    with pytest.raises(ValueError, match="class-agnostic"):
        CascadeRCNN(**dict(CASCADE_MODEL, bbox_head=dict(CASCADE_MODEL["bbox_head"],
                                                         reg_class_agnostic=False)),
                    device="cpu")


@pytest.mark.parametrize("t", range(STAGES))
def test_stage_assigner_thresholds(t):
    got = CascadeRCNNConfig().stage_assigner(t)
    want = JaxCascadeRCNNConfig().stage_assigner(t)
    assert got.pos_iou_thr == got.neg_iou_thr == got.min_pos_iou == (0.5, 0.6, 0.7)[t]
    for field in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
        assert getattr(got, field) == getattr(want, field), field


def _check_dets(got, want):
    assert bool(got.valid.any()) and not bool(got.valid.all())
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-5, rtol=0)


def test_cascade_rcnn_inference_matches(cascade):
    make_model, cfg, _ = cascade["box"]
    x = cascade["x"]
    with torch.no_grad():
        got = cascade_rcnn_inference(cfg, make_model().eval(), x["images"], x["img_shapes"],
                                     x["scale_factors"])
    _check_dets(got, cascade["want"]["box"]["dets"])


def test_cascade_mask_rcnn_inference_matches(cascade):
    make_model, cfg, _ = cascade["mask"]
    x = cascade["x"]
    with torch.no_grad():
        got = cascade_mask_rcnn_inference(cfg, make_model().eval(), x["images"], x["img_shapes"],
                                          x["scale_factors"])
    want = cascade["want"]["mask"]["dets"]
    assert isinstance(got, MaskDetections) and got.mask_probs.shape == (2, 8, 14, 14)
    _check_dets(got, want)
    np.testing.assert_allclose(got.mask_probs.numpy(), want.mask_probs, atol=1e-5, rtol=0)
    probs = got.mask_probs.numpy()
    assert (probs >= 0).all() and (probs <= 1).all() and not probs[~want.valid].any()


def test_per_coordinate_scale_factors_pin_r5(cascade):
    """R5 in the cascade: the reference multiplies its detections by
    ``scale_factors[:, None, None]``, which broadcasts (B, 4) factors to
    (B, B, D, 4) and breaks. The port undoes either form per image: (B,)
    and the equal (B, 4) give the same detections and masks."""
    make_model, cfg, _ = cascade["mask"]
    model, x = make_model().eval(), cascade["x"]
    per_coord = x["scale_factors"][:, None].expand(-1, 4).contiguous()
    with torch.no_grad():
        a = cascade_mask_rcnn_inference(cfg, model, x["images"], x["img_shapes"],
                                        x["scale_factors"])
        b = cascade_mask_rcnn_inference(cfg, model, x["images"], x["img_shapes"], per_coord)
    for field in MaskDetections._fields:
        torch.testing.assert_close(getattr(a, field), getattr(b, field), atol=0, rtol=0)
    assert float(a.boxes[1][a.valid[1]].max()) <= 56.0 / 2.0
    rois = jnp.zeros((2, 8, 4)) * jnp.asarray(per_coord.numpy())[:, None, None]
    assert rois.shape == (2, 2, 8, 4)  # the reference's roi boxes for (B, 4)


@pytest.mark.parametrize("family", ["box", "mask"])
def test_cascade_losses_and_gradients_match(cascade, family):
    make_model, cfg, _ = cascade[family]
    want = cascade["want"][family]
    batch = cascade["batch"]
    model = make_model()
    loss = cascade_rcnn_loss if family == "box" else cascade_mask_rcnn_loss
    if family == "box":
        batch = {k: v for k, v in batch.items() if k != "gt_masks"}
    got = loss(cfg, model, batch, FixedNoise(cascade["want"]["draws"]))
    assert set(got) == set(want["losses"])
    assert want["losses"]["num_pos_rois"] > 0
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-5, atol=0, err_msg=k)
    got["loss"].backward()
    grads = _grads(want, model)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(grads)
    for name, p in model.named_parameters():
        if _is_frozen(name):
            assert not p.requires_grad and p.grad is None, name
        else:
            np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **GRAD_TOL,
                                       err_msg=name)
    heads = ("bbox_head", "mask_head") if family == "mask" else ("bbox_head",)
    assert all(model.get_parameter(f"{h}{t}.{'fc1' if h == 'bbox_head' else 'conv0'}.weight")
               .grad.abs().sum() > 0 for h in heads for t in range(STAGES))


def test_gt_block_rois_leave_the_next_slate(cascade):
    """Stage 0 of the parity step samples rois out of the appended gt block,
    so the loss comparison above covers the rule; and ``next_candidates``
    keeps the refined slate less exactly those rois."""
    make_model, cfg, _ = cascade["box"]
    batch = {k: v for k, v in cascade["batch"].items() if k != "gt_masks"}
    with torch.no_grad():
        _, _, slates = _cascade_rcnn_loss_core(cfg, make_model(), batch,
                                               FixedNoise(cascade["want"]["draws"]))
    first = slates[0]
    gt_rois = first.from_gt & first.is_valid
    assert bool(gt_rois.any()) and bool((~first.from_gt & first.is_valid).any())
    # the valid rois of the gt block are their gts' boxes, positives of their gt
    b_idx = torch.nonzero(gt_rois, as_tuple=True)[0]
    torch.testing.assert_close(first.rois[gt_rois], batch["gt_boxes"][b_idx, first.matched[gt_rois]])
    assert bool(first.is_pos[gt_rois].all())
    reg = torch.zeros_like(first.rois)
    boxes, valid = next_candidates(cfg, 0, first, reg, None)
    torch.testing.assert_close(boxes, first.rois)  # zero deltas decode to the same boxes
    assert torch.equal(valid, first.is_valid & ~first.from_gt)
    fake = SampledRois(*first[:5], first.matched, torch.zeros_like(first.from_gt))
    assert torch.equal(next_candidates(cfg, 0, fake, reg, None)[1], first.is_valid)


@pytest.mark.parametrize("name,cls", [("cascade_rcnn", CascadeRCNNConfig),
                                      ("cascade_mask_rcnn", CascadeMaskRCNNConfig)])
def test_detection_cfg_matches_reference(name, cls):
    path = CONFIGS / f"{name}_r50_fpn_coco.py"
    cfg = builder.build_detection_cfg(Config.fromfile(path).detection)
    want = jax_builder.build_detection_cfg(JaxConfig.fromfile(path).detection)
    assert type(cfg) is cls
    fields = ["num_classes", "roi_strides", "roi_size", "finest_scale", "rcnn_num_samples",
              "rcnn_pos_fraction", "rcnn_target_means", "score_thr", "nms_iou_thr",
              "max_detections", "num_stages", "stage_pos_ious", "stage_target_stds",
              "stage_loss_weights"]
    if cls is CascadeMaskRCNNConfig:
        fields += ["mask_size", "mask_roi_size", "mask_loss_weight"]
        assert want.mask_num_rois is None  # the box sampler's positive cap, as the port's
    for field in fields:
        assert getattr(cfg, field) == getattr(want, field), field
    for t in range(cfg.num_stages):
        got_a, want_a = cfg.stage_assigner(t), want.stage_assigner(t)
        assert all(getattr(got_a, f) == getattr(want_a, f)
                   for f in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou")), t
    assert isinstance(cfg.stage_target_stds[0], tuple)


@pytest.mark.parametrize("name,params", [
    # Faster R-CNN's 41 429 156 + two more box heads of 13 982 805
    ("cascade_rcnn", 41_429_156 + 2 * 13_982_805),
    # + three mask heads: 4 conv 3x3, the 2x2 transposed conv, 1x1 logits
    ("cascade_mask_rcnn", 41_429_156 + 2 * 13_982_805 + 3 * (4 * 590_080 + 262_400 + 20_560)),
])
def test_full_width_cascade_answers_on_cpu(name, params):
    """The config's detector at full width (R50, FPN 256, 80 classes)
    through ``make_inference_fn``; its slates cut to 64 proposals and 8
    detections, for the CPU's time."""
    cfg = Config.fromfile(CONFIGS / f"{name}_r50_fpn_coco.py")
    model = builder.build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == params
    # each stage head draws its own seeded weights
    assert not torch.equal(model.bbox_head0.fc2.weight, model.bbox_head1.fc2.weight)
    det_cfg = dataclasses.replace(builder.build_detection_cfg(cfg.detection), max_detections=8,
                                  proposal_test=ProposalConfig(post_nms_top_k=64))
    segm = name == "cascade_mask_rcnn"
    image = torch.randn((1, 64, 96, 3), generator=torch.Generator().manual_seed(0))
    res = make_inference_fn(model, det_cfg, segm=segm)(image, torch.tensor([[64.0, 96.0]]),
                                                       torch.tensor([2.0]))
    assert res.boxes.shape == (1, 8, 4) and bool(res.valid.any())
    assert float(res.boxes[res.valid].max()) <= 95.0 / 2.0
    if segm:
        assert res.mask_probs.shape == (1, 8, 28, 28) and not res.mask_probs[~res.valid].any()


def test_trainer_steps_the_cascade_mask_rcnn(cascade):
    """One epoch of two steps through ``build_loss_fn`` and ``Trainer``:
    every stage's losses finite, every stage head trained."""
    make_model, cfg, _ = cascade["mask"]
    model = make_model()
    loss_fn = builder.build_loss_fn(model, cfg, rng_seed=3)
    before = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(0.01, 2), 0.9, 1e-4, 1.0)
    batch = cascade["batch"]
    history = Trainer(loss_fn, model, optimizer, _Loader([batch, batch]), log_interval=1).run(1)
    assert len(history) == 2 and all(h["skipped_steps"] == 0 for h in history)
    for t in range(STAGES):
        assert all(np.isfinite(h[f"loss_s{t}_{k}"]) for h in history for k in ("cls", "reg", "mask"))
    still = [n for n, p in model.named_parameters() if p.requires_grad and torch.equal(p, before[n])]
    assert not still, still
