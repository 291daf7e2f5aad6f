"""The port's Faster R-CNN training step against the JAX package's.

The detector is ``test_torch_model.py``'s (``test_two_stage.py``'s
``frcnn_setup``: ResNet-18, FPN 16 channels, fc 32, 3 classes, 64 x 64
images, batch 2) with ``frozen_stages=1``, on the same converted weights
with randomised FrozenBN. Both sides run in float32 on the CPU.

The sampling draws are the reference's own: ``jax.random`` makes them from
the reference's key splits and the port receives them as tensors. So
assignment and sampling must agree exactly, the losses to rtol 1e-5, the
gradients to atol = rtol = 1e-4 (the convolutions sum in another order), and
one step of ``make_train_step`` must leave the same trainable parameters and
momentum buffers.

The frozen stages differ on purpose (``ROADMAP.md``, fault R4): the
reference freezes them with ``stop_gradient`` but builds its optimizer
without a ``frozen_mask``, so weight decay still moves them and their
momentum; the port leaves them out of the optimizer, as mmdetection does.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_model import ANCHORS, MODEL, _randomise_frozen_bn
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.engine.trainer import detection_lr_schedule as jax_lr_schedule
from torch_detection_tpu.models.detectors import FasterRCNNConfig as JaxFasterRCNNConfig
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.detectors import faster_rcnn_loss as jax_faster_rcnn_loss
from torch_detection_tpu.models.detectors.two_stage import _sample_fixed as jax_sample_fixed
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops import boxes as jax_boxes
from torch_detection_tpu.ops import losses as jax_losses
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.ops.assign import MaxIoUAssigner as JaxMaxIoUAssigner
from torch_detection_tpu.parallel import make_optimizer as jax_make_optimizer
from torch_detection_tpu.parallel.train_step import create_train_state
from torch_detection_tpu.parallel.train_step import make_train_step as jax_make_train_step
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_loss,
)
from torch_detection_tpu_torch.models.detectors.two_stage import _sample_fixed
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops import boxes, losses
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.ops.assign import MaxIoUAssigner
from torch_detection_tpu_torch.parallel import make_optimizer, make_train_step
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "faster_rcnn_r50_fpn_coco.py"
TRAIN_MODEL = dict(MODEL, backbone=dict(MODEL["backbone"], frozen_stages=1))
PROPOSALS = dict(pre_nms_per_level=64, post_nms_top_k=32)
SAMPLES = dict(rpn_num_samples=32, rcnn_num_samples=16, max_detections=8)
GRAD_TOL = dict(atol=1e-4, rtol=1e-4)
LR, MOMENTUM, WD, CLIP = 0.01, 0.9, 1e-4, 1.0  # a clip the step's gradient norm exceeds


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch in this module: the test workers share
    the cores, and at these sizes threads contend more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rng):
    gt_boxes = np.array(
        [[[4, 4, 30, 30], [20, 8, 60, 40], [0, 0, 0, 0], [0, 0, 0, 0]],
         [[10, 10, 50, 59], [2, 2, 20, 18], [30, 30, 55, 50], [0, 0, 0, 0]]], np.float32)
    return dict(
        image=rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
        gt_boxes=gt_boxes,
        gt_labels=np.array([[1, 3, 0, 0], [2, 3, 1, 0]], np.int32),
        gt_valid=np.array([[True, True, False, False], [True, True, True, False]]),
        img_shape=np.array([[64, 64], [60, 56]], np.float32),
    )


def _jax_draws(key, b, n):
    """The uniform draws the reference's ``_sample_fixed`` makes from each
    image's key, for each of its ``len(n)`` samplings in order: the RPN
    (``n[0]`` anchors), then each RoI stage (``n[1:]`` candidates), the key
    split into ``b * len(n)`` keys, ``len(n)`` an image."""
    rngs = jax.random.split(key, b * len(n)).reshape(b, len(n), -1)
    out = []
    for stage, size in enumerate(n):
        u_pos, u_all = [], []
        for i in range(b):
            k_pos, k_all = jax.random.split(rngs[i, stage])
            u_all.append(np.asarray(jax.random.uniform(k_all, (size,), minval=0.0, maxval=0.5)))
            u_pos.append(np.asarray(jax.random.uniform(k_pos, (size,))))
        out.append((np.stack(u_pos), np.stack(u_all)))
    return out


class FixedNoise:
    """A ``noise`` function that hands out given draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)

    def __call__(self, shape):
        u_pos, u_all = self.draws.pop(0)
        assert u_pos.shape == shape, (u_pos.shape, shape)
        return torch.from_numpy(u_pos), torch.from_numpy(u_all)


def _trace(opt_state):
    """The momentum tree of the reference's optax chain."""
    for leaf in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState)):
        if isinstance(leaf, optax.TraceState):
            return leaf.trace
    raise AssertionError("no TraceState in the optimizer state")


def _momentum(optimizer):
    return [optimizer.torch_optimizer.state[p]["momentum_buffer"] for p in optimizer.params]


def _is_frozen(name):
    return name.startswith(("backbone.stem.", "backbone.layer1_"))


@pytest.fixture(scope="module")
def train_setup():
    """Both detectors on the same weights, and the reference's losses,
    gradients and one optimizer step on one seeded batch."""
    rng = np.random.default_rng(0)
    jax_model = JaxTwoStageDetector(**TRAIN_MODEL)
    jax_cfg = JaxFasterRCNNConfig(
        num_classes=3, anchor_generator=JaxAnchorGenerator(**ANCHORS),
        proposal_train=JaxProposalConfig(**PROPOSALS), proposal_test=JaxProposalConfig(**PROPOSALS),
        **SAMPLES,
    )
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    roi_vars = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 7, 7, 16)),
                              method=JaxTwoStageDetector.roi_forward)
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **roi_vars["params"]},
         "batch_stats": variables["batch_stats"]},
        rng,
    )
    batch = _batch(rng)
    key = jax.random.PRNGKey(7)

    def loss_fn(params, batch_stats, batch):
        out = jax_faster_rcnn_loss(jax_cfg, jax_model,
                                   {"params": params, "batch_stats": batch_stats}, batch, key)
        return out["loss"], out

    (_, jax_losses_), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    tx = jax_make_optimizer(jax_lr_schedule(LR, 100, 12), MOMENTUM, WD, CLIP)
    state = create_train_state(variables["params"], tx, batch_stats=variables["batch_stats"])
    state, _ = jax_make_train_step(loss_fn, tx, donate_state=False)(state, batch)

    n_anchors = sum(3 * (64 // s) ** 2 for s in ANCHORS["strides"])
    want = dict(
        losses={k: float(v) for k, v in jax_losses_.items()},
        grads=from_jax_variables({"params": grads}),
        grad_norm=float(optax.global_norm(grads)),
        params=from_jax_variables({"params": state.params}),
        momentum=from_jax_variables({"params": _trace(state.opt_state)}),
        draws=_jax_draws(key, 2, (n_anchors, PROPOSALS["post_nms_top_k"] + 4)),
    )

    cfg = FasterRCNNConfig(num_classes=3, anchor_generator=AnchorGenerator(**ANCHORS),
                           proposal_train=ProposalConfig(**PROPOSALS),
                           proposal_test=ProposalConfig(**PROPOSALS), **SAMPLES)

    def make_model():
        model = TwoStageDetector(**TRAIN_MODEL, device="cpu")
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return model.to(memory_format=torch.channels_last).train()

    return make_model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()}, want


def test_bbox2delta_matches(rng):
    props = rng.uniform(0, 50, (2, 7, 4)).astype(np.float32)
    props[..., 2:] += props[..., :2] + 1
    gt = rng.uniform(0, 50, (2, 7, 4)).astype(np.float32)
    gt[..., 2:] += gt[..., :2] + 1
    kw = dict(means=(0.1, -0.1, 0.0, 0.2), stds=(0.1, 0.1, 0.2, 0.2))
    got = boxes.bbox2delta(torch.from_numpy(props), torch.from_numpy(gt), **kw).numpy()
    want = np.asarray(jax_boxes.bbox2delta(jnp.asarray(props), jnp.asarray(gt), **kw))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("name", ["binary_cross_entropy", "softmax_cross_entropy", "smooth_l1_loss"])
def test_losses_match(rng, name):
    logits = (3 * rng.normal(size=(5, 6))).astype(np.float32)
    weight = (rng.uniform(size=(5, 6)) > 0.3).astype(np.float32)
    if name == "binary_cross_entropy":
        args = (logits, (rng.uniform(size=(5, 6)) > 0.5).astype(np.float32))
    elif name == "softmax_cross_entropy":
        args, weight = (logits, rng.integers(0, 6, 5).astype(np.int32)), weight[:, 0]
    else:
        args = (logits, rng.normal(size=(5, 6)).astype(np.float32))
    kw = dict(weight=weight, avg_factor=np.float32(weight.sum()))
    got = getattr(losses, name)(*(torch.from_numpy(a) for a in args),
                                **{k: torch.as_tensor(v) for k, v in kw.items()})
    want = getattr(jax_losses, name)(*(jnp.asarray(a) for a in args), **kw)
    np.testing.assert_allclose(float(got), float(want), atol=1e-6, rtol=1e-6)


def _assign_case(rng, case):
    anchors = rng.uniform(0, 60, (40, 4)).astype(np.float32)
    anchors[:, 2:] = anchors[:, :2] + rng.uniform(4, 30, (40, 2))
    gt = rng.uniform(0, 50, (2, 5, 4)).astype(np.float32)
    gt[..., 2:] = gt[..., :2] + rng.uniform(6, 25, (2, 5, 2))
    valid = np.array([[True, True, True, False, False], [True, True, False, True, False]])
    anchor_valid = None
    if case == "ties":  # duplicate anchors tie for a gt's best IoU; a duplicate gt
        anchors[5:10] = anchors[3]
        anchors[20] = gt[0, 1]
        anchors[21] = gt[0, 1]
        gt[1, 1] = gt[1, 0]
    elif case == "no_gt":
        valid[1] = False
    elif case == "anchor_valid":
        anchor_valid = rng.uniform(size=(2, 40)) > 0.3
    gt[~valid] = 0.0  # padded gt rows are zero boxes
    labels = rng.integers(1, 4, (2, 5)).astype(np.int32)
    return anchors, gt, valid, labels, anchor_valid


@pytest.mark.parametrize("case", ["plain", "ties", "no_gt", "anchor_valid"])
def test_max_iou_assigner_matches(rng, case):
    anchors, gt, valid, labels, anchor_valid = _assign_case(rng, case)
    thr = dict(pos_iou_thr=0.5, neg_iou_thr=0.3, min_pos_iou=0.1)
    got = MaxIoUAssigner(**thr)(
        torch.from_numpy(anchors), torch.from_numpy(gt), torch.from_numpy(valid),
        torch.from_numpy(labels), None if anchor_valid is None else torch.from_numpy(anchor_valid))
    for i in range(2):
        want = JaxMaxIoUAssigner(**thr)(
            jnp.asarray(anchors), jnp.asarray(gt[i]), jnp.asarray(valid[i]), jnp.asarray(labels[i]),
            anchor_valid=None if anchor_valid is None else jnp.asarray(anchor_valid[i]))
        np.testing.assert_array_equal(got.assigned_gt_inds[i].numpy(), np.asarray(want.assigned_gt_inds))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
        np.testing.assert_allclose(got.max_overlaps[i].numpy(), np.asarray(want.max_overlaps),
                                   atol=1e-6, rtol=0)
    if case == "ties":
        assert (got.assigned_gt_inds[0, 20:22] == 2).all()
    if case == "no_gt":
        assert (got.assigned_gt_inds[1] == 0).all()


@pytest.mark.parametrize("n,num,frac", [(4000, 256, 0.5), (60, 16, 0.25)])
def test_sample_fixed_matches_with_the_reference_draws(rng, n, num, frac):
    """4000 priorities 1+u in float32 tie often: the stable top-k must
    break ties by the lower index, as XLA's top_k does."""
    pos = rng.uniform(size=(2, n)) < 0.1
    neg = ~pos & (rng.uniform(size=(2, n)) < 0.8)
    keys = jax.random.split(jax.random.PRNGKey(3), 2)
    draws_pos, draws_all = [], []
    for i in range(2):
        k_pos, k_all = jax.random.split(keys[i])
        draws_pos.append(np.asarray(jax.random.uniform(k_pos, (n,))))
        draws_all.append(np.asarray(jax.random.uniform(k_all, (n,), minval=0.0, maxval=0.5)))
    got = _sample_fixed(torch.from_numpy(pos), torch.from_numpy(neg), num, frac,
                        torch.from_numpy(np.stack(draws_pos)), torch.from_numpy(np.stack(draws_all)))
    for i in range(2):
        want = jax_sample_fixed(keys[i], jnp.asarray(pos[i]), jnp.asarray(neg[i]), num, frac)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))
    assert int(got[1].sum()) > 0


def _port_losses(train_setup):
    make_model, cfg, batch, want = train_setup
    model = make_model()
    return model, faster_rcnn_loss(cfg, model, batch, FixedNoise(want["draws"]))


def test_faster_rcnn_losses_match(train_setup):
    _, got = _port_losses(train_setup)
    want = train_setup[3]["losses"]
    assert set(got) == set(want)
    assert want["num_pos_rois"] > 0
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=1e-5, atol=0, err_msg=k)


def test_gradients_match(train_setup):
    model, got = _port_losses(train_setup)
    got["loss"].backward()
    want = train_setup[3]["grads"]
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in model.named_parameters():
        if _is_frozen(name):  # stop_gradient in the reference, requires_grad=False here
            assert not p.requires_grad and p.grad is None, name
            assert not want[name].any(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL, err_msg=name)


def test_one_train_step_matches_and_pins_r4(train_setup):
    make_model, cfg, batch, want = train_setup
    model = make_model()
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(LR, 100), MOMENTUM, WD, CLIP)
    noise = FixedNoise(want["draws"])

    def loss_fn(batch, step):
        out = faster_rcnn_loss(cfg, model, batch, noise)
        return out["loss"], {k: v for k, v in out.items() if k != "loss"}

    metrics = make_train_step(loss_fn, optimizer)(batch)
    assert float(metrics["skipped_nonfinite"]) == 0.0 and optimizer.steps == optimizer.count == 1
    assert want["grad_norm"] > CLIP  # the clip took part
    momentum = dict(zip([n for n, p in model.named_parameters() if p.requires_grad],
                        _momentum(optimizer)))
    lr0 = LR / 3
    for name, p in model.named_parameters():
        if _is_frozen(name):
            # the port: untouched, and no momentum
            assert torch.equal(p.detach(), before[name]) and name not in momentum, name
            # R4: the reference decays them, and keeps a momentum of wd * p
            np.testing.assert_allclose(want["momentum"][name].numpy(), WD * before[name].numpy(),
                                       rtol=1e-6, atol=0, err_msg=name)
            np.testing.assert_allclose(want["params"][name].numpy(),
                                       (before[name] * (1 - lr0 * WD)).numpy(),
                                       rtol=1e-6, atol=0, err_msg=name)
            assert not torch.equal(want["params"][name], before[name]) or not before[name].any()
        else:
            np.testing.assert_allclose(momentum[name].numpy(), want["momentum"][name].numpy(),
                                       **GRAD_TOL, err_msg=name)
            np.testing.assert_allclose(p.detach().numpy(), want["params"][name].numpy(),
                                       atol=1e-6, rtol=1e-5, err_msg=name)


def test_nan_batch_skips_the_step(train_setup):
    make_model, cfg, batch, _ = train_setup
    model = make_model()
    optimizer = make_optimizer(model.parameters(), LR, MOMENTUM, WD, CLIP)
    step = make_train_step(builder.build_loss_fn(model, cfg, rng_seed=1), optimizer)
    assert float(step(batch)["skipped_nonfinite"]) == 0.0
    params = [p.detach().clone() for p in optimizer.params]
    buffers = [m.clone() for m in _momentum(optimizer)]
    bad = dict(batch, image=batch["image"].clone())
    bad["image"][1, 5, 7, 0] = float("nan")
    metrics = step(bad)
    assert float(metrics["skipped_nonfinite"]) == 1.0 and not np.isfinite(float(metrics["loss"]))
    assert optimizer.steps == 2 and optimizer.count == 1
    for p, q in zip(optimizer.params, params):
        assert torch.equal(p.detach(), q)
    for m, n in zip(_momentum(optimizer), buffers):
        assert torch.equal(m, n)


@pytest.mark.parametrize("steps_per_epoch", [100, 1000])
def test_lr_schedule_matches(steps_per_epoch):
    got = detection_lr_schedule(0.02, steps_per_epoch, decay_epochs=(8, 11))
    want = jax_lr_schedule(0.02, steps_per_epoch, 12, decay_epochs=(8, 11))
    b1, b2 = 8 * steps_per_epoch, 11 * steps_per_epoch
    for step in (0, 250, 499, 500, 501, b1 - 1, b1, b2 - 1, b2, 20 * steps_per_epoch):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))


def test_schedule_and_optimizer_come_from_the_config():
    cfg = Config.fromfile(CONFIG)
    got = builder.build_lr_schedule(cfg, 50)
    want = jax_builder.build_lr_schedule(JaxConfig.fromfile(CONFIG), 50)
    for step in (0, 499, 500, 400, 550, 5000):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, err_msg=str(step))
    small = dict(cfg, model=dict(TRAIN_MODEL, type="TwoStageDetector"))
    model, det_cfg, _, optimizer = builder.build_train_objects(small, "cpu", loader=_Loader([]))
    assert model.training and det_cfg.rpn_num_samples == 256
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.dtype == torch.bfloat16  # the runtime's compute dtype
    group = optimizer.torch_optimizer.param_groups[0]
    assert (group["momentum"], group["weight_decay"], optimizer.grad_clip_norm) == (0.9, 1e-4, 35.0)
    trainable = [p for n, p in model.named_parameters() if not _is_frozen(n)]
    assert len(optimizer.params) == len(trainable) < len(list(model.parameters()))


def test_training_build_computes_in_bf16_on_float32_params():
    """The training build keeps float32 parameters and computes in bf16;
    FrozenBN stays on its statistics in train mode (train and eval forwards
    are equal), and the result is the serving build's to bf16 rounding (the
    two round sums at other places)."""
    small = dict(TRAIN_MODEL, type="TwoStageDetector")
    train = builder.build_detector(small, "bfloat16", "cpu", seed=2, param_dtype="float32").train()
    serve = builder.build_detector(small, "bfloat16", "cpu", seed=2)
    assert {p.dtype for n, p in train.named_parameters()} == {torch.float32}
    assert {p.dtype for n, p in serve.named_parameters() if ".norm." not in n} == {torch.bfloat16}
    x = torch.randn((1, 32, 32, 3), generator=torch.Generator().manual_seed(0))
    feats, scores, _ = train(x)
    assert feats[0].dtype == scores[0].dtype == torch.bfloat16
    with torch.no_grad():
        again = train.eval()(x)[0]
        want = serve(x)[0]
    for a, b, c in zip(feats, again, want, strict=True):
        torch.testing.assert_close(a.detach(), b, atol=0, rtol=0)
        torch.testing.assert_close(b.float(), c.float(), atol=0.05, rtol=0.05)


class _Loader:
    def __init__(self, batches):
        self.batches, self.epochs = batches, []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def iter_batches(self, skip_batches=0):
        return iter([dict(b) for b in self.batches[skip_batches:]])

    def __len__(self):
        return len(self.batches)


def test_trainer_runs_steps_and_logs(train_setup):
    make_model, cfg, batch, _ = train_setup
    model = make_model()
    loader = _Loader([batch, batch])
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(LR, len(loader)),
                               MOMENTUM, WD, CLIP)
    trainer = Trainer(builder.build_loss_fn(model, cfg), model, optimizer, loader, log_interval=1)
    history = trainer.run(2)
    assert loader.epochs == [0, 1] and optimizer.steps == 4 and len(history) == 4
    assert all(np.isfinite(h["loss"]) and h["skipped_steps"] == 0 for h in history)
    assert [h["step"] for h in history] == [1, 2, 3, 4]
    np.testing.assert_allclose(history[0]["lr"], detection_lr_schedule(LR, 2)(1))
