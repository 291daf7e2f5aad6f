"""The port's FCOS family against the JAX package's, and the pieces FCOS,
ATSS and GFL share: GroupNorm, the GN towers with their per-level
``scales``, and the harness of ``test_torch_atss.py`` and
``test_torch_gfl.py``.

The detector is the reference tests' tiny one (``tests/test_fcos.py``):
ResNet-18, FPN 32 channels with extra convs on the inputs, a head of one
stacked GN conv of 32, 4 classes, on a 64 x 96 canvas, batch 2; FrozenBN,
GroupNorm, the head's biases and ``scales`` drawn from a numpy seed,
``cls_out``'s bias 0 so that the decode's scores clear ``score_thr``. Both
sides run in float32 on the CPU, the weights carried by
``from_jax_variables`` with ``strict=True``. The second image is smaller
than the canvas, the first holds two copies of one gt (labels 3 and 1) and
two gts of equal area.

Tolerances: GroupNorm 1e-5 on inputs whose mean lies within a standard
deviation of 0, as the towers' do (flax takes E[x^2] - E[x]^2, the port
``F.group_norm``'s two-pass variance); head outputs 1e-5 relative to
max(1, max |want|); targets exactly; losses rtol 1e-5; the gradients into
the head's parameters and the levels 1e-4 in relative norm of the
difference; the decode on equal inputs exactly in its indices, labels and
validity, its scores and boxes to 1e-6 relative to max(1, max |want|); one
SGD step's parameters atol 1e-6 rtol 1e-5 and momentum atol = rtol = 1e-4,
the frozen stages left out of the port's optimizer (R4). The reference's
step is its optax chain on its own gradients.
"""

import copy
import functools
from pathlib import Path

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_model import _randomise_frozen_bn
from test_torch_train import _is_frozen, _momentum
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.engine.trainer import detection_lr_schedule as jax_lr_schedule
from torch_detection_tpu.models.detectors import FCOSConfig as JaxFCOSConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import decode_fcos as jax_decode_fcos
from torch_detection_tpu.models.detectors import fcos_loss as jax_fcos_loss
from torch_detection_tpu.models.detectors.fcos import _flat_points as jax_flat_points
from torch_detection_tpu.models.detectors.fcos import fcos_targets as jax_fcos_targets
from torch_detection_tpu.ops import losses as jax_losses
from torch_detection_tpu.parallel import make_optimizer as jax_make_optimizer
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector, build_loss_fn
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule, make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    FCOSConfig,
    SingleStageDetector,
    decode_fcos,
    fcos_loss,
    fcos_targets,
)
from torch_detection_tpu_torch.models.detectors.fcos import flat_points
from torch_detection_tpu_torch.models.layers import GroupNorm, build_norm
from torch_detection_tpu_torch.ops import losses
from torch_detection_tpu_torch.parallel import make_optimizer, make_train_step
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
CANVAS = (64, 96)
LEVEL_SIZES = [(8, 12), (4, 6), (2, 3), (1, 2), (1, 1)]  # P3-P7 of the canvas
IMG_SHAPES = np.array([[64, 96], [57, 83]], np.float32)
TRUNK = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3), frozen_stages=1),
    neck=dict(type="FPN", in_channels=(128, 256, 512), out_channels=32, num_outs=5,
              add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True),
)
FCOS_HEAD = dict(type="FCOSHead", num_classes=4, in_channels=32, feat_channels=32, stacked_convs=1)
LR, MOMENTUM, WD, CLIP = 0.01, 0.9, 1e-4, 1.0  # a clip the step's gradient norm exceeds
STEP_TOL = dict(atol=1e-6, rtol=1e-5)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch in this module: the test workers share
    the cores, and at these sizes threads contend more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gts():
    """Image 0: gt 1 twice (labels 3 and 1: the first must win), gts 2 and
    3 of equal area, overlapping; image 1: one gt."""
    boxes = np.zeros((2, 5, 4), np.float32)
    boxes[0, :4] = [[4, 6, 40, 50], [4, 6, 40, 50], [30, 10, 70, 40], [40, 20, 80, 50]]
    boxes[1, 0] = [10, 10, 50, 52]
    return dict(gt_boxes=boxes,
                gt_labels=np.array([[3, 1, 2, 4, 0], [2, 0, 0, 0, 0]], np.int32),
                gt_valid=np.array([[True] * 4 + [False], [True] + [False] * 4]))


def batch_of(rng):
    return dict(image=rng.normal(size=(2, *CANVAS, 3)).astype(np.float32), img_shape=IMG_SHAPES,
                **gts())


def randomise(variables, rng):
    """FrozenBN's statistics, GroupNorm's affine parameters, the head's
    biases (a RetinaHead tower conv's too) and ``scales`` from ``rng``;
    ``cls_out``'s bias 0."""
    variables = _randomise_frozen_bn(dict(variables), rng)
    head = variables["params"]["head"]
    for name, module in head.items():
        if name == "scales":
            head[name] = rng.uniform(0.5, 1.5, module.shape).astype(np.float32)
        elif "norm" in module:
            module["norm"]["scale"] = rng.uniform(0.5, 1.5, module["norm"]["scale"].shape).astype(np.float32)
            module["norm"]["bias"] = rng.normal(0, 0.2, module["norm"]["bias"].shape).astype(np.float32)
        else:
            leaf = module["conv"] if "conv" in module else module
            leaf["bias"] = (np.zeros_like(leaf["bias"]) if name == "cls_out"
                            else rng.normal(0, 0.1, leaf["bias"].shape).astype(np.float32))
    return variables


def rel_norm(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def close(got, want, limit=1e-5, what=""):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()) if want.size else 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=limit * scale, rtol=0, err_msg=what)


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def dense_setup(head, jax_cfg, jax_loss, seed=0, make_batch=batch_of):
    """Both detectors on the same randomised weights, and from one jit of
    the JAX side: the levels, the head outputs, the loss dict, every
    parameter's gradient and the gradient into the levels; then one SGD
    step by its optax chain. ``jax_loss(cfg, outs, batch)`` is the family's
    loss dict; ``make_batch(rng)`` the batch."""
    rng = np.random.default_rng(seed)
    jax_model = JaxSingleStageDetector(**TRUNK, head=head)
    batch = make_batch(rng)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(seed), batch["image"])
    variables = randomise(variables, rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def stages(m, x, deltas):
        levels = [f + d for f, d in zip(m.neck_mod(m.backbone_mod(x)), deltas)]
        return levels, m.head_mod(levels)

    def loss(params, deltas):
        levels, outs = jax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                       jbatch["image"], deltas, method=stages)
        out = jax_loss(jax_cfg, outs, jbatch)
        return out["loss"], (out, levels, outs)

    deltas = [jnp.zeros((2, h, w, 32)) for h, w in LEVEL_SIZES]
    (_, (losses_, levels, outs)), (grads, level_grads) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(variables["params"], deltas)
    tx = jax_make_optimizer(jax_lr_schedule(LR, 100, 12), MOMENTUM, WD, CLIP)
    opt_state = tx.init(variables["params"])
    updates, opt_state = jax.jit(tx.update)(grads, opt_state, variables["params"])
    want = dict(
        levels=[np.array(f) for f in levels],
        outs=jax.tree_util.tree_map(np.array, outs),
        losses={k: float(v) for k, v in losses_.items()},
        grads=from_jax_variables({"params": grads}),
        level_grads=[np.asarray(g) for g in level_grads],
        grad_norm=float(optax.global_norm(grads)),
        params=from_jax_variables({"params": optax.apply_updates(variables["params"], updates)}),
        momentum=from_jax_variables({"params": _trace(opt_state)}),
    )
    model = SingleStageDetector(**TRUNK, head=head, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    return jax_model, variables, model.to(memory_format=torch.channels_last), batch, want


def _trace(opt_state):
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState)):
        if isinstance(leaf, optax.TraceState):
            return leaf.trace
    raise AssertionError("no TraceState in the optimizer state")


def check_head_outputs(model, want):
    levels = [torch.from_numpy(f) for f in want["levels"]]
    with torch.no_grad():
        got = model.head(levels)
    assert len(got) == len(want["outs"])
    for branch_got, branch_want in zip(got, want["outs"], strict=True):
        for g, w in zip(branch_got, branch_want, strict=True):
            assert g.shape == w.shape
            close(g.numpy(), w)


def check_loss_and_grads(model, loss_fn, want, keys):
    """The port's loss of the head on the JAX levels: its dict, and the
    gradients into the head's parameters and the levels."""
    levels = [torch.from_numpy(f).requires_grad_() for f in want["levels"]]
    got = loss_fn(model.head(levels))
    assert set(got) == set(keys) and want["losses"]["num_pos"] > 0
    for k in keys:
        np.testing.assert_allclose(float(got[k].detach()), want["losses"][k], rtol=1e-5, atol=0,
                                   err_msg=k)
    model.zero_grad()
    got["loss"].backward()
    for name, p in model.head.named_parameters():
        w = want["grads"]["head." + name].numpy()
        assert rel_norm(p.grad.numpy(), w) <= 1e-4, name
    # the levels' gradient as one vector: on the 1 x 2 and 1 x 1 levels a
    # GroupNorm group of the tiny head holds 2 and 1 values, whose normalised
    # output barely depends on them, so those levels' own gradients are of
    # the size of the float32 rounding of the terms that cancel in them
    got_levels = np.concatenate([lv.grad.numpy().ravel() for lv in levels])
    assert rel_norm(got_levels, np.concatenate([w.ravel() for w in want["level_grads"]])) <= 1e-4
    assert rel_norm(levels[0].grad.numpy(), want["level_grads"][0]) <= 1e-4


def check_sgd_step(model, loss_fn, batch, want):
    """One step of ``make_train_step`` with the port's SGD against the
    reference's optax chain on its own gradients; the frozen stages stay
    out of the port's optimizer (R4). The step runs on a copy of ``model``."""
    model = copy.deepcopy(model).train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(LR, 100), MOMENTUM, WD,
                               CLIP)

    def step_loss(b, step):
        out = loss_fn(model(b["image"]), b)
        return out["loss"], {k: v for k, v in out.items() if k != "loss"}

    metrics = make_train_step(step_loss, optimizer)(torch_batch(batch))
    assert float(metrics["skipped_nonfinite"]) == 0.0 and optimizer.count == 1
    assert want["grad_norm"] > CLIP  # the clip took part
    momentum = dict(zip([n for n, p in model.named_parameters() if p.requires_grad],
                        _momentum(optimizer)))
    for name, p in model.named_parameters():
        if _is_frozen(name):
            assert torch.equal(p.detach(), before[name]) and name not in momentum, name
        else:
            np.testing.assert_allclose(momentum[name].numpy(), want["momentum"][name].numpy(),
                                       **GRAD_TOL, err_msg=name)
            np.testing.assert_allclose(p.detach().numpy(), want["params"][name].numpy(),
                                       **STEP_TOL, err_msg=name)


def check_decode(decode, jax_decode, cfg, jax_cfg, outs):
    """Both decoders on the JAX side's head outputs."""
    shapes, scale = IMG_SHAPES, np.array([2.0, 1.5], np.float32)
    want = jax.jit(functools.partial(jax_decode, jax_cfg))(
        *outs, img_shapes=jnp.asarray(shapes), scale_factors=jnp.asarray(scale))
    got = decode(cfg, *jax.tree_util.tree_map(torch.from_numpy, outs),
                 torch.from_numpy(shapes), torch.from_numpy(scale))
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.valid.sum()) > 10
    close(got.scores.numpy(), want.scores, 1e-6, "scores")
    close(got.boxes.numpy(), want.boxes, 1e-6, "boxes")
    return got


def check_config(name, style_cls, fields, sub=()):
    """``build_detection_cfg`` of a committed config against the
    reference's dataclass, field for field."""
    det = Config.fromfile(CONFIGS / f"{name}_r50_fpn_coco.py").detection
    got, want = build_detection_cfg(det), jax_builder.build_detection_cfg(dict(det))
    assert isinstance(got, style_cls)
    for field in fields:
        assert getattr(got, field) == getattr(want, field), field
    for part, part_fields in sub:
        for field in part_fields:
            assert getattr(getattr(got, part), field) == getattr(getattr(want, part), field), field
    assert not want.approx_top_k
    return got


def check_full_width(name, head_cls, scales=True):
    """The committed config at full width on the CPU: every tensor of the
    JAX model's variables (``jax.eval_shape``, nothing compiled) loads with
    ``strict=True``, GroupNorm's and ``scales`` (where the head has them)
    among them; without a GPU the default device raises."""
    cfg = Config.fromfile(CONFIGS / f"{name}_r50_fpn_coco.py")
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert type(model.head).__name__ == head_cls
    if scales:
        assert model.head.scales.shape == (5,) and model.head.scales.dtype == torch.float32
    else:
        assert model.head.scales is None
    assert isinstance(model.head.cls_tower0.norm, GroupNorm)
    assert model.head.cls_tower0.norm.num_groups == 32 and model.head.cls_tower0.conv.bias is None
    check_reference_tree(cfg, model)
    return cfg, model


def check_reference_tree(cfg, model):
    """Every tensor of the JAX model's variables (``jax.eval_shape``,
    nothing compiled) loads into ``model`` with ``strict=True``, and the
    parameter counts agree."""
    jax_model = JaxSingleStageDetector(**{k: v for k, v in cfg.model.items() if k != "type"})
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 12), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    state = from_jax_variables(zeros, model)
    model.load_state_dict(state, strict=True)
    assert sum(p.numel() for p in model.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))


def check_trainer_step(model, det_cfg, batch, loss_keys):
    """One step of ``build_loss_fn`` and ``Trainer`` on a copy of ``model``:
    the family's losses finite, positives, every trainable parameter moved
    and every frozen one kept."""
    class Loader:
        def set_epoch(self, epoch):
            pass

        def iter_batches(self, skip_batches=0):
            return iter([torch_batch(batch)][skip_batches:])

        def __len__(self):
            return 1

    model = copy.deepcopy(model).train()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(LR, 100), MOMENTUM, WD,
                               CLIP)
    history = Trainer(build_loss_fn(model, det_cfg), model, optimizer, Loader(),
                      log_interval=1).run(1)
    assert len(history) == 1 and history[0]["skipped_steps"] == 0
    assert set(loss_keys) <= set(history[0]) and history[0]["num_pos"] > 0
    assert all(np.isfinite(history[0][k]) for k in loss_keys)
    for name, p in model.named_parameters():
        assert torch.equal(p.detach(), before[name]) != p.requires_grad, name
    return history[0]


# ---------------------------------------------------------------- shared pieces


@pytest.mark.parametrize("channels,groups,mean", [(32, 32, 0.0), (64, 32, 0.5), (256, 32, 0.3),
                                                  (48, 16, -0.5)])
def test_group_norm_matches_flax(rng, channels, groups, mean):
    x = (mean + rng.normal(size=(2, 6, 10, channels))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, channels).astype(np.float32)
    bias = rng.normal(0, 0.2, channels).astype(np.float32)
    want = fnn.GroupNorm(num_groups=groups, epsilon=1e-5).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    norm = build_norm(dict(type="GN", num_groups=groups), channels)
    state = from_jax_variables({"params": {"scale": scale, "bias": bias}})
    norm.load_state_dict(state, strict=True)
    got = norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert norm.scale.dtype == torch.float32 and norm.eps == 1e-5
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_group_norm_rounds_to_the_input_dtype_under_autocast(rng):
    """bf16 in, the float32 normalisation rounded once to bf16, channels_last
    kept."""
    x = torch.from_numpy(rng.normal(size=(1, 64, 4, 4)).astype(np.float32)).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    norm = GroupNorm(64)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = norm(x)
    want = norm(x.float())
    assert got.dtype == torch.bfloat16 and torch.equal(got, want.to(torch.bfloat16))
    assert got.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("offset", [0.0, 1.0], ids=["fcos", "gfl"])
def test_giou_loss_offsets_match(rng, offset):
    pred = rng.uniform(0, 40, (30, 4)).astype(np.float32)
    pred[:, 2:] += pred[:, :2] + rng.uniform(0, 20, (30, 2))
    tgt = pred + rng.normal(0, 4, (30, 4)).astype(np.float32)
    weight = rng.uniform(0, 1, 30).astype(np.float32)
    want = jax_losses.iou_loss(jnp.asarray(pred), jnp.asarray(tgt), weight=jnp.asarray(weight),
                               mode="giou", offset=offset, avg_factor=np.float32(weight.sum()))
    got = losses.iou_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                          weight=torch.from_numpy(weight), mode="giou", offset=offset,
                          avg_factor=torch.tensor(weight.sum()))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------- FCOS


def jax_fcos(cfg, outs, batch):
    return jax_fcos_loss(cfg, *outs, batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])


def port_fcos(outs, batch):
    b = torch_batch(batch) if isinstance(batch["gt_boxes"], np.ndarray) else batch
    return fcos_loss(FCOSConfig(num_classes=4), *outs, b["gt_boxes"], b["gt_labels"],
                     b["gt_valid"])


@pytest.fixture(scope="module")
def fcos_setup():
    return dense_setup(FCOS_HEAD, JaxFCOSConfig(num_classes=4), jax_fcos)


def test_fcos_weights_load_and_head_outputs_match(fcos_setup):
    _, variables, model, _, want = fcos_setup
    assert set(variables["params"]["head"]) == {"cls_tower0", "reg_tower0", "cls_out", "reg_out",
                                                "ctr_out", "scales"}
    check_head_outputs(model.eval(), want)


def test_fcos_targets_match_exactly():
    """Duplicate gts and equal areas: ``argmin``'s first gt, on both sides."""
    jax_points, jax_ranges = jax_flat_points(JaxFCOSConfig(num_classes=4), LEVEL_SIZES)
    points, ranges = flat_points(FCOSConfig(num_classes=4), LEVEL_SIZES)
    np.testing.assert_array_equal(points.numpy(), np.asarray(jax_points))
    np.testing.assert_array_equal(ranges.numpy(), np.asarray(jax_ranges))
    g = gts()
    got = fcos_targets(FCOSConfig(num_classes=4), points, ranges,
                       *(torch.from_numpy(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
    targets = jax.jit(functools.partial(jax_fcos_targets, JaxFCOSConfig(num_classes=4)))
    for i in range(2):
        want = targets(jax_points, jax_ranges,
                       *(jnp.asarray(g[k][i]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
        for gi, wi in zip(got, want, strict=True):
            np.testing.assert_array_equal(gi[i].numpy(), np.asarray(wi))
    label0 = got[0][0].numpy()
    assert (label0 == 2).any() and not (label0 == 0).any()  # the duplicate's first label (3) wins
    assert (label0 == 1).any() and (label0 == 3).any()  # both equal-area gts take points


def test_fcos_loss_and_gradients_match(fcos_setup):
    _, _, model, batch, want = fcos_setup
    check_loss_and_grads(model.train(), lambda outs: port_fcos(outs, batch), want,
                         ("loss", "loss_cls", "loss_reg", "loss_centerness", "num_pos"))


def test_fcos_decode_matches(fcos_setup):
    check_decode(decode_fcos, jax_decode_fcos, FCOSConfig(num_classes=4),
                 JaxFCOSConfig(num_classes=4), fcos_setup[4]["outs"])


def test_fcos_sgd_step_matches_and_pins_r4(fcos_setup):
    _, _, model, batch, want = fcos_setup
    check_sgd_step(model, port_fcos, batch, want)


def test_fcos_inference_entry_point(fcos_setup):
    """``make_inference_fn`` reaches ``decode_fcos`` on the model's outputs."""
    _, _, model, batch, _ = fcos_setup
    model.eval()
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, FCOSConfig(num_classes=4))(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_fcos(FCOSConfig(num_classes=4), *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_fcos_config_matches_the_reference():
    check_config("fcos", FCOSConfig,
                 ("num_classes", "strides", "regress_ranges", "focal_gamma", "focal_alpha",
                  "score_thr", "nms_iou_thr", "pre_select_per_level", "pre_nms_top_k",
                  "max_detections"))


def test_fcos_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg, _ = check_full_width("fcos", "FCOSHead")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
