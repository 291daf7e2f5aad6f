"""The port's training options against the JAX package's: the step and
cosine schedules, gradient accumulation, the EMA of the parameters and
class-specific box regression, then the same through ``Trainer``, two gloo
ranks and ``tools.train``.

The detector is ``test_torch_train.py``'s narrow Faster R-CNN (ResNet-18,
FPN 16, fc 32, 3 classes, 64 x 64 images, ``frozen_stages=1``) with a
class-specific box head (``reg_class_agnostic=False``), on the same
converted weights. The reference's step, built with ``accum_steps=2`` and
an ``ema_decay``, takes a batch of four images, a batch with a NaN pixel
(skipped) and the first batch again; the port's ``make_train_step`` takes
the same three batches with the reference's own sampling draws: each
step's draws come from ``fold_in(PRNGKey(seed), step)``, so both
micro-batches of a step draw the same noise (R15). Losses to rtol 1e-5,
gradients to atol = rtol = 1e-4, parameters and EMA to atol 1e-6, rtol
1e-5. Torch runs on one thread.
"""

import json
import math
import os
import shutil
import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import torch_accum_ranks
from test_torch_data import write_png_coco
from test_torch_model import ANCHORS, MODEL, _randomise_frozen_bn
from test_torch_tools import _write_config
from test_torch_train import GRAD_TOL, PROPOSALS, SAMPLES, FixedNoise, _batch, _jax_draws
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.engine.trainer import detection_lr_schedule as jax_lr_schedule
from torch_detection_tpu.models.detectors import FasterRCNNConfig as JaxFasterRCNNConfig
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.detectors import faster_rcnn_loss as jax_faster_rcnn_loss
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.parallel import make_optimizer as jax_make_optimizer
from torch_detection_tpu.parallel.train_step import create_train_state
from torch_detection_tpu.parallel.train_step import make_train_step as jax_make_train_step
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule
from torch_detection_tpu_torch.engine.checkpoint import load_checkpoint, load_checkpoint_file
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_loss,
)
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.parallel import ParamEMA, make_optimizer, make_train_step
from torch_detection_tpu_torch.parallel.train_step import micro_batch_parts, micro_batch_ranks
from torch_detection_tpu_torch.tools import train as train_cli
from torch_detection_tpu_torch.utils.config import Config

SPECIFIC_MODEL = dict(MODEL, backbone=dict(MODEL["backbone"], frozen_stages=1),
                      bbox_head=dict(MODEL["bbox_head"], reg_class_agnostic=False))
LR, MOMENTUM, WD, CLIP = 0.01, 0.9, 1e-4, 1.0
DECAY = 0.2  # below the ramp's (1 + t) / (10 + t) from t = 1, above it at t = 0
SEED = 7
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- schedules
@pytest.mark.parametrize("policy,min_lr_ratio", [("step", 0.0), ("cosine", 0.0), ("cosine", 0.01)])
def test_schedule_matches_the_reference_at_every_step(policy, min_lr_ratio):
    """Every step of a 12-epoch run of 7 steps an epoch and 20 more, the
    warmup of 30 steps in front: the reference computes in float32, so
    within float32's rounding of the base rate (atol 1e-6 of it) where the
    cosine nears 0."""
    kw = dict(decay_epochs=(8, 11), warmup_steps=30, warmup_ratio=0.1, policy=policy,
              min_lr_ratio=min_lr_ratio)
    got = detection_lr_schedule(0.02, 7, 12, **kw)
    want = jax_lr_schedule(0.02, 7, 12, **kw)
    steps = np.arange(12 * 7 + 20)
    np.testing.assert_allclose([got(int(s)) for s in steps],
                               np.asarray(jax.vmap(want)(jnp.asarray(steps))), rtol=2e-6, atol=2e-8)
    if policy == "cosine":
        assert got(12 * 7) == pytest.approx(0.02 * min_lr_ratio, abs=1e-15)
        assert got(12 * 7 + 19) == got(12 * 7)


def test_builder_reads_the_cosine_over_the_configs_total_epochs():
    """``schedule.total_epochs`` sets the cosine's length, not the run's
    ``--epochs``, as in the reference's builder."""
    sched = dict(policy="cosine", min_lr_ratio=0.05, total_epochs=3, warmup_steps=4)
    cfg = dict(optimizer=dict(lr=0.04), schedule=sched)
    got, want = builder.build_lr_schedule(cfg, 5), jax_builder.build_lr_schedule(cfg, 5)
    for step in range(20):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=2e-6, err_msg=str(step))
    with pytest.raises(ValueError, match="linear"):
        builder.build_lr_schedule(dict(schedule=dict(policy="linear")), 5)


# ---------------------------------------------------------------- accumulation, EMA, class-specific
@pytest.fixture(scope="module")
def options_setup():
    """The reference's class-specific losses and gradients on a two-image
    micro-batch at two keys, and its ``accum_steps=2`` + EMA step on three
    batches (the middle one NaN), then on a batch of two equal halves."""
    rng = np.random.default_rng(0)
    jax_model = JaxTwoStageDetector(**SPECIFIC_MODEL)
    jax_cfg = JaxFasterRCNNConfig(
        num_classes=3, anchor_generator=JaxAnchorGenerator(**ANCHORS),
        proposal_train=JaxProposalConfig(**PROPOSALS), proposal_test=JaxProposalConfig(**PROPOSALS),
        **SAMPLES)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    roi_vars = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 7, 7, 16)),
                              method=JaxTwoStageDetector.roi_forward)
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **roi_vars["params"]},
         "batch_stats": variables["batch_stats"]}, rng)
    half_a, half_b = _batch(rng), _batch(rng)
    half_b["gt_labels"] = np.array([[3, 2, 0, 0], [1, 1, 2, 0]], np.int32)
    batch = {k: np.concatenate([half_a[k], half_b[k]]) for k in half_a}
    nan_batch = dict(batch, image=batch["image"].copy())
    nan_batch["image"][3, 9, 9, 1] = np.nan
    twin = {k: np.concatenate([half_a[k], half_a[k]]) for k in half_a}

    def micro_loss(params, batch_stats, batch, key):
        out = jax_faster_rcnn_loss(jax_cfg, jax_model,
                                   {"params": params, "batch_stats": batch_stats}, batch, key)
        return out["loss"], out

    grad_fn = jax.jit(jax.value_and_grad(micro_loss, has_aux=True))
    keys = [jax.random.fold_in(jax.random.PRNGKey(SEED), s) for s in range(3)]
    (_, losses0), grads0 = grad_fn(variables["params"], variables["batch_stats"], half_a, keys[0])
    (_, losses1), _ = grad_fn(variables["params"], variables["batch_stats"], half_a, keys[1])

    def step_loss(params, batch_stats, batch, step=0):
        key = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
        return micro_loss(params, batch_stats, batch, key)

    tx = jax_make_optimizer(jax_lr_schedule(LR, 100, 12), MOMENTUM, WD, CLIP)
    train_step = jax_make_train_step(step_loss, tx, donate_state=False, accum_steps=2,
                                     ema_decay=DECAY)
    state = create_train_state(variables["params"], tx, batch_stats=variables["batch_stats"],
                               ema=True)
    history = []
    for b in (batch, nan_batch, batch):
        state, metrics = train_step(state, b)
        history.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                            params=from_jax_variables({"params": state.params}),
                            ema=from_jax_variables({"params": state.ema_params})))
    fresh = create_train_state(variables["params"], tx, batch_stats=variables["batch_stats"],
                               ema=True)
    _, twin_metrics = train_step(fresh, twin)

    n_anchors = sum(3 * (64 // s) ** 2 for s in ANCHORS["strides"])
    draws = [_jax_draws(k, 2, (n_anchors, PROPOSALS["post_nms_top_k"] + 4)) for k in keys]
    cfg = FasterRCNNConfig(num_classes=3, anchor_generator=AnchorGenerator(**ANCHORS),
                           proposal_train=ProposalConfig(**PROPOSALS),
                           proposal_test=ProposalConfig(**PROPOSALS), **SAMPLES)

    def make_model():
        model = TwoStageDetector(**SPECIFIC_MODEL, device="cpu")
        model.load_state_dict(from_jax_variables(variables), strict=True)
        return model.to(memory_format=torch.channels_last).train()

    tensors = lambda b: {k: torch.from_numpy(v) for k, v in b.items()}  # noqa: E731
    return dict(
        make_model=make_model, cfg=cfg, draws=draws,
        batches=[tensors(b) for b in (batch, nan_batch, batch)], half_a=tensors(half_a),
        twin=tensors(twin), losses0={k: float(v) for k, v in losses0.items()},
        loss_key1=float(losses1["loss"]), grads0=from_jax_variables({"params": grads0}),
        history=history, twin_loss=float(twin_metrics["loss"]))


def _step_loss(setup, model):
    """``loss_fn(batch, step)`` with the reference's draws of ``step``,
    handed out afresh to every micro-batch (R15)."""
    def loss_fn(batch, step):
        out = faster_rcnn_loss(setup["cfg"], model, batch, FixedNoise(setup["draws"][step]))
        return out["loss"], {k: v for k, v in out.items() if k != "loss"}

    return loss_fn


def test_class_specific_losses_and_gradients_match(options_setup):
    """Each sampled roi's deltas are read at its class; the gradient into
    the (C * 4)-wide regression layer lands in several classes' blocks."""
    model = options_setup["make_model"]()
    got = faster_rcnn_loss(options_setup["cfg"], model, options_setup["half_a"],
                           FixedNoise(options_setup["draws"][0]))
    want = options_setup["losses0"]
    assert model.bbox_head.reg.out_features == 3 * 4 and want["num_pos_rois"] > 0
    for k in want:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=1e-5, atol=0, err_msg=k)
    got["loss"].backward()
    for name, p in model.named_parameters():
        if p.requires_grad:
            np.testing.assert_allclose(p.grad.numpy(), options_setup["grads0"][name].numpy(),
                                       **GRAD_TOL, err_msg=name)
    reg = model.bbox_head.reg.weight.grad.reshape(3, 4, -1)
    assert int((reg.abs().sum(dim=(1, 2)) > 0).sum()) >= 2


def test_accumulated_steps_and_the_ema_match_the_reference(options_setup):
    """``accum_steps=2`` with the EMA: the first step's loss, metrics and
    parameters; the NaN step skipped with the EMA as it was; after the
    third step the parameters and the EMA (the ramp at t = 0, the decay at
    t = 2)."""
    model = options_setup["make_model"]()
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(LR, 100), MOMENTUM, WD,
                               CLIP)
    optimizer.ema = ParamEMA(model, DECAY)
    assert optimizer.ema.rate(0) == pytest.approx(0.1) and optimizer.ema.rate(2) == \
        pytest.approx(DECAY)
    step = make_train_step(_step_loss(options_setup, model), optimizer, accum_steps=2)
    history = options_setup["history"]
    for i, batch in enumerate(options_setup["batches"]):
        ema_before = [e.clone() for e in optimizer.ema.tensors]
        metrics = {k: float(v) for k, v in step(batch).items()}
        want = history[i]
        assert metrics["skipped_nonfinite"] == want["metrics"]["skipped_nonfinite"] == float(i == 1)
        if i == 1:
            assert all(torch.equal(a, b) for a, b in zip(ema_before, optimizer.ema.tensors))
            continue
        if i == 0:
            assert set(metrics) == set(want["metrics"])
            for k, v in want["metrics"].items():
                np.testing.assert_allclose(metrics[k], v, rtol=1e-5, atol=1e-7, err_msg=k)
        params = dict(model.named_parameters())
        for name, e in zip(optimizer.ema.names, optimizer.ema.tensors):
            np.testing.assert_allclose(params[name].detach().numpy(),
                                       want["params"][name].numpy(), **PARAM_TOL, err_msg=name)
            np.testing.assert_allclose(e.numpy(), want["ema"][name].numpy(), **PARAM_TOL,
                                       err_msg=name)
    assert optimizer.steps == 3 and optimizer.count == 2


def test_micro_batches_of_a_step_draw_the_same_noise_pin_r15(options_setup):
    """R15: the reference binds the step for every micro-batch and keys its
    draws by it, so two equal halves give one micro-batch's loss exactly
    as if drawn once; another step's draws give another loss. The port
    keeps that: its step over the twin batch gives the same."""
    want = options_setup["losses0"]["loss"]
    assert abs(options_setup["loss_key1"] - want) > 1e-3 * abs(want)  # the draws matter
    np.testing.assert_allclose(options_setup["twin_loss"], want, rtol=1e-6)
    model = options_setup["make_model"]()
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(LR, 100), MOMENTUM, WD,
                               CLIP)
    metrics = make_train_step(_step_loss(options_setup, model), optimizer,
                              accum_steps=2)(options_setup["twin"])
    np.testing.assert_allclose(float(metrics["loss"]), want, rtol=1e-5)


def test_accumulation_over_ranks_takes_whole_micro_batches():
    """The global batch is the data ranks' shards in rank order, cut into
    ``accum_steps`` contiguous micro-batches, as the reference cuts it; each
    rank runs the parts its shard holds, in order: whole micro-batches
    where the ranks divide the count, else parts of one that spans ranks
    (``accum_steps=3`` over 2 ranks of 3 images: rank 0 holds micro-batch 0
    and the first row of micro-batch 1, rank 1 its second row and
    micro-batch 2). A global batch that does not split raises."""
    assert [micro_batch_parts(a, 1, 6, 0) for a in (1, 2, 3)] == [
        [(0, 0, 0, 6)], [(0, 0, 0, 3), (1, 3, 0, 3)], [(0, 0, 0, 2), (1, 2, 0, 2), (2, 4, 0, 2)]]
    assert [micro_batch_parts(a, 2, 2, 1) for a in (1, 2, 4)] == [
        [(0, 0, 2, 2)], [(1, 0, 0, 2)], [(2, 0, 0, 1), (3, 1, 0, 1)]]
    assert micro_batch_parts(3, 2, 3, 0) == [(0, 0, 0, 2), (1, 2, 0, 1)]
    assert micro_batch_parts(3, 2, 3, 1) == [(1, 0, 1, 1), (2, 1, 0, 2)]
    assert [micro_batch_ranks(3, 2, 3, m) for m in range(3)] == [[0], [0, 1], [1]]
    assert [micro_batch_ranks(2, 4, 1, m) for m in range(2)] == [[0, 1], [2, 3]]
    with pytest.raises(ValueError, match="does not split into 4"):
        micro_batch_parts(4, 2, 3, 0)


# ---------------------------------------------------------------- the trainer and the checkpoints
class _Batches:
    def __init__(self, n):
        gen = torch.Generator().manual_seed(0)
        self.batches = [dict(image=torch.randn(4, 3, generator=gen)) for _ in range(n)]

    def set_epoch(self, epoch):
        pass

    def iter_batches(self, skip_batches=0):
        yield from (dict(b) for b in self.batches[skip_batches:])

    def __len__(self):
        return len(self.batches)


def _tiny(seed=0):
    """A linear model whose bias is frozen, and its loss."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(3, 2))
    model[0].bias.requires_grad_(False)  # frozen, and averaged all the same

    def loss_fn(batch, step):
        return ((model(batch["image"]) - 1) ** 2).mean(), {}

    return model, loss_fn


def test_validation_scores_the_ema_and_checkpoints_carry_it(tmp_path):
    """Validation sees the averages in the model and gives the parameters
    back; ``epoch_N`` holds the parameters and ``ema.pt``; ``best/`` holds
    the weights validation scored; a resume restores the EMA bit for bit,
    and one from a checkpoint without an EMA starts it from the loaded
    parameters."""
    model, loss_fn = _tiny()
    optimizer = make_optimizer(model.parameters(), 0.1, 0.9, 0.0)
    seen = []

    def val_hook():
        seen.append({n: p.detach().clone() for n, p in model.named_parameters()})
        return {"mAP": float(len(seen))}

    trainer = Trainer(loss_fn, model, optimizer, _Batches(3), work_dir=str(tmp_path / "w"),
                      val_hook=val_hook, ema_decay=0.5, log_interval=1)
    trainer.run(2)
    ema = dict(zip(optimizer.ema.names, optimizer.ema.tensors))
    params = {n: p.detach().clone() for n, p in model.named_parameters()}
    assert not torch.equal(ema["0.weight"], params["0.weight"])
    assert all(torch.equal(seen[-1][n], ema[n]) for n in ema)
    # the frozen bias's average is d * p + (1 - d) * p, its value to float32 rounding
    torch.testing.assert_close(ema["0.bias"], params["0.bias"], rtol=1e-6, atol=0)
    ckpt = load_checkpoint_file(str(tmp_path / "w" / "epoch_2"))
    assert all(torch.equal(ckpt["model"][n], params[n]) for n in params)
    assert all(torch.equal(ckpt["ema"][n], ema[n]) for n in ema)
    best = load_checkpoint_file(str(tmp_path / "w" / "best"))
    assert "ema" not in best and all(torch.equal(best["model"][n], ema[n]) for n in ema)

    again, _ = _tiny(seed=1)
    opt2 = make_optimizer(again.parameters(), 0.1, 0.9, 0.0)
    Trainer(loss_fn, again, opt2, _Batches(3), ema_decay=0.5)
    load_checkpoint(again, str(tmp_path / "w" / "epoch_2"), strict=True, optimizer=opt2)
    assert all(torch.equal(e, ema[n]) for n, e in zip(opt2.ema.names, opt2.ema.tensors))
    (tmp_path / "w" / "epoch_2" / "ema.pt").unlink()
    load_checkpoint(again, str(tmp_path / "w" / "epoch_2"), strict=True, optimizer=opt2)
    assert all(torch.equal(e, params[n]) for n, e in zip(opt2.ema.names, opt2.ema.tensors))


def test_cli_trains_with_all_four_options_and_resumes_bit_for_bit(tmp_path):
    """``tools.train`` with ``accum_steps=2``, ``ema_decay``, the cosine
    schedule and class-specific regression: the logged learning rates are
    the cosine's, validation runs each epoch, and one epoch then
    ``--auto-resume`` gives the straight run's ``epoch_2`` bit for bit:
    the model, the momentum and the EMA."""
    config = _write_config(tmp_path / "opts.py", write_png_coco(tmp_path / "coco"),
                           accum_steps=2, ema_decay=0.9)
    text = (tmp_path / "opts.py").read_text()
    text = text.replace("'fc_channels': 32}", "'fc_channels': 32, 'reg_class_agnostic': False}")
    text = text.replace("schedule = dict(warmup_steps=2)",
                        "schedule = dict(warmup_steps=2, policy='cosine', min_lr_ratio=0.01, "
                        "total_epochs=2)")
    assert "reg_class_agnostic" in text and "cosine" in text
    (tmp_path / "opts.py").write_text(text)
    work = tmp_path / "work"
    trainer = train_cli.main([config, "--epochs", "2", "--work-dir", str(work), "--device", "cpu"])
    assert trainer.accum_steps == 2 and trainer.optimizer.ema.decay == 0.9
    assert trainer.model.bbox_head.reg.out_features == 2 * 4
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    lr = Config.fromfile(config)["optimizer"]["lr"]
    want = detection_lr_schedule(lr, 2, 2, warmup_steps=2, policy="cosine", min_lr_ratio=0.01)
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    for r in steps:
        assert math.isclose(r["lr"], want(r["step"]), rel_tol=1e-12) and r["skipped_steps"] == 0
    assert [r["epoch"] for r in records if "val_mAP" in r] == [0, 1]

    shutil.copytree(work / "epoch_1", tmp_path / "resumed" / "epoch_1")
    train_cli.main([config, "--epochs", "2", "--work-dir", str(tmp_path / "resumed"),
                    "--auto-resume", "--device", "cpu"])
    got = load_checkpoint_file(str(tmp_path / "resumed" / "epoch_2"))
    ref = load_checkpoint_file(str(work / "epoch_2"))
    for part in ("model", "ema"):
        assert set(got[part]) == set(ref[part])
        for k, v in ref[part].items():
            assert torch.equal(got[part][k], v), (part, k)
    for name, state in ref["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][name]["momentum_buffer"],
                           state["momentum_buffer"]), name


# ---------------------------------------------------------------- two gloo ranks
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_ranks_with_accumulation_and_ema_equal_one_process(tmp_path):
    """Two gloo ranks, ``accum_steps=2`` and the EMA, plain and under FSDP
    (``tests/torch_accum_ranks.py``), against one process at
    ``accum_steps=2`` on the global batch: each micro-batch is one rank's
    shard, with its own normalisers and draws."""
    ctx = mp.start_processes(torch_accum_ranks.rank_worker,
                             args=(torch_accum_ranks.WORLD, _free_port(), str(tmp_path)),
                             nprocs=torch_accum_ranks.WORLD, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + torch_accum_ranks.DEADLINE_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    reports = [torch.load(tmp_path / f"rank{r}.pt") for r in range(torch_accum_ranks.WORLD)]
    for case in ("dp", "fsdp"):
        assert all(r[case]["replicas_equal"] for r in reports), case
        assert reports[0][case]["mismatches"] == [], (case, reports[0][case])
    assert os.path.exists(tmp_path / "rank1.pt")
