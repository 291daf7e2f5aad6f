"""Gradient accumulation over ranks that do not divide it, the ``model``
mesh axis (tensor parallelism) and image-row partitioning, against one
process and the JAX package.

A spawn of four gloo ranks on the CPU (``torch_mesh_ranks.rank_worker``,
a 2 x 2 ``(data, model)`` mesh) computes the cases' numbers: the narrow
Faster R-CNN of ``torch_dp_families`` at ``accum_steps=3`` with an EMA over
two data ranks of three images (micro-batch 1 spans them), with the model
ranks as replicas and under tensor parallelism, against one process on the
six images (losses to ``fam.LOSS_RTOL``, parameters, momentum buffers and
averages to ``fam.PARAM_TOL`` and to rtol 1e-5 plus 1e-5 of a tensor's
largest entry); the tensor-parallel checkpoint both ways; the reference's
toy (``tests/test_parallel.py:85-108``) against the JAX package's
one-device step; row bands on the reference's own spatial case
(``tests/test_multihost_train.py:1123-1188``: ResNet-18 RetinaNet, FPN 16,
forward at rtol 2e-4 and atol 2e-5, the step's loss at rel 2e-4) and on
the narrow Faster R-CNN, whose P6 of one row leaves one rank of each pair
without rows; and the refusals. A second launch, slow (``TD_RUN_SLOW=1``),
adds tensor parallelism under FSDP and every family of ``build_loss_fn``
on bands. Each launch has a process-group timeout and a deadline, so a
mismatched collective fails in a minute. In one process: the
tensor-parallel plan against the reference's ``param_sharding_rules``
through the converter (the full-width case slow), and, slow, the
one-process accumulated step against the JAX package's
``make_train_step(accum_steps=3)`` (the Tier-1
``tests/test_torch_train_options.py`` holds the same one-process path
against the reference at ``accum_steps=2``).
"""

import socket
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp

import torch_dp_families as fam
import torch_mesh_ranks as ranks
from test_torch_model import ANCHORS, MODEL, _randomise_frozen_bn
from test_torch_train import PROPOSALS, SAMPLES, FixedNoise, _batch, _jax_draws
from torch_detection_tpu.engine.trainer import detection_lr_schedule as jax_lr_schedule
from torch_detection_tpu.models.detectors import FasterRCNNConfig as JaxFasterRCNNConfig
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.detectors import faster_rcnn_loss as jax_faster_rcnn_loss
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.parallel import make_optimizer as jax_make_optimizer
from torch_detection_tpu.parallel.mesh import make_mesh as jax_make_mesh
from torch_detection_tpu.parallel.mesh import param_sharding_rules
from torch_detection_tpu.parallel.train_step import create_train_state
from torch_detection_tpu.parallel.train_step import make_train_step as jax_make_train_step
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.engine import detection_lr_schedule
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_loss,
)
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.parallel import ParamEMA, make_optimizer, make_train_step
from torch_detection_tpu_torch.parallel.tensor_parallel import tensor_parallel_plan

FORWARD_TOL = dict(rtol=2e-4, atol=2e-5)  # the reference's, tests/test_multihost_train.py
SPATIAL_LOSS_REL = 2e-4


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _toy():
    """The reference toy's variables and batch (``tests/test_parallel.py``)."""
    rng = np.random.default_rng(0)
    w = (rng.normal(size=(8, 4)) * 0.1).astype(np.float32)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ranks.TOY_ROWS, 8)).astype(np.float32)
    return dict(w=w, b=np.zeros((4,), np.float32), x=x, y=np.ones((ranks.TOY_ROWS, 4), np.float32))


def _launch(out, part: str):
    """Each rank's report of a launch of ``part``."""
    toy = {k: torch.from_numpy(v) for k, v in _toy().items()}
    ctx = mp.start_processes(ranks.rank_worker,
                             args=(ranks.WORLD, _free_port(), str(out), toy, part),
                             nprocs=ranks.WORLD, join=False, start_method="spawn")
    try:
        deadline = time.monotonic() + ranks.DEADLINE_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt") for r in range(ranks.WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each rank's report of the ``core`` launch."""
    return _launch(tmp_path_factory.mktemp("mesh"), "core")


@pytest.fixture(scope="module")
def extra_runs(tmp_path_factory):
    """Each rank's report of the ``extra`` launch (slow cases only)."""
    return _launch(tmp_path_factory.mktemp("mesh_extra"), "extra")


@pytest.mark.parametrize("case", ["accum", "tp", pytest.param("fsdp", marks=pytest.mark.slow),
                                  pytest.param("tp_fsdp", marks=pytest.mark.slow)])
def test_accumulation_over_ranks_that_do_not_divide_it_equals_one_process(request, case):
    """``accum_steps=3`` over two data ranks of three images, two steps with
    an EMA: every rank's state equal to every other's bit for bit, and to
    the one process's on the six images: the losses at rtol 1e-5, every
    parameter, momentum buffer and average at rtol 1e-5 plus 1e-5 of the
    tensor's largest entry (``torch_mesh_ranks.departures``), and within
    ``torch_dp_families.mismatches``; the same under FSDP over the data
    ranks, alone and with tensor parallelism."""
    fsdp = case in ("fsdp", "tp_fsdp")
    runs = request.getfixturevalue("extra_runs" if fsdp else "runs")
    assert all(r[case]["replicas_equal"] for r in runs), case
    owner = runs[3 if fsdp else 0][case]
    assert owner["mismatches"] == [], owner["mismatches"]
    assert owner["departures"] == {}, owner["departures"]
    if fsdp:
        assert owner["same_init"]


def _predicted_held(model, parts):
    plan = tensor_parallel_plan(model, parts)
    return sum(p.numel() // (parts if n in plan else 1) for n, p in model.named_parameters())


def test_tensor_parallel_ranks_hold_the_reference_share(runs):
    """Each rank holds what the reference's rule predicts: the sharded
    leaves' half and every other leaf whole; the toy's weight half."""
    model = build_detector(fam.FAMILIES[ranks.NAME][0], "float32", "meta")
    whole = sum(p.numel() for p in model.parameters())
    held = _predicted_held(model, ranks.MODEL)
    assert held < whole * 0.55
    for r in runs:
        assert r["accum"]["held"] == whole and r["tp"]["held"] == held
        assert r["toy"]["held"] == 8 * 4 // ranks.MODEL


def test_tensor_parallel_checkpoint_is_whole_and_loads_back(runs):
    """Rank 0 writes the tensor-parallel run's checkpoint whole, in the
    one-process format: one process loads it bit for bit; a one-process
    checkpoint loads into the tensor-parallel shards bit for bit."""
    for r in runs:
        assert r["tp_checkpoint"] == dict(loads_whole=True, resumes=True)


def _jax_toy_step(toy):
    """The reference test's one-device step of its toy: (loss, w after)."""
    def simple_loss(params, batch_stats, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        loss = jnp.mean((pred - batch["y"]) ** 2)
        return loss, {"mse": loss}

    tx = optax.sgd(ranks.TOY_LR)
    state = create_train_state({"w": jnp.asarray(toy["w"]), "b": jnp.asarray(toy["b"])}, tx)
    state, metrics = jax_make_train_step(simple_loss, tx, donate_state=False)(
        state, {"x": jnp.asarray(toy["x"]), "y": jnp.asarray(toy["y"])})
    return float(metrics["loss"]), np.asarray(state.params["w"])


def test_the_reference_toy_under_tensor_parallelism(runs):
    """``tests/test_parallel.py:85-108`` on the 2 x 2 mesh: the loss at rel
    1e-5 and the weight at rtol 1e-5 against the JAX package's one-device
    step, as the reference holds its 4 x 2 mesh; the port's one process
    too."""
    loss, w = _jax_toy_step(_toy())
    single = runs[2]["toy"]["single"]
    for got in [r["toy"] for r in runs] + [single]:
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        np.testing.assert_allclose(got["w"].numpy(), w, rtol=1e-5)


def test_row_bands_train_the_narrow_faster_rcnn_as_one_process(runs):
    """A step on bands of the 64-row images (P6 has one row, so one rank of
    each model group owns none of it) equals one process's step on the
    four images, and every rank holds the same parameters."""
    assert [r["bands"]["image_rows"] for r in runs] == [32] * 4
    assert all(r["bands"]["replicas_equal"] for r in runs)
    assert runs[0]["bands"]["mismatches"] == [], runs[0]["bands"]["mismatches"]


def test_row_bands_hold_the_reference_spatial_case(runs):
    """The reference's own case on a 2 x 2 mesh: each data rank's forward
    outputs, gathered from its bands, at rtol 2e-4 and atol 2e-5 against
    one process's on the same images, and the step's loss at rel 2e-4."""
    single = runs[1]["r18"]["single"]
    for r in runs:
        got = r["r18"]
        assert got["band_rows"] == fam.R18_CANVAS[0] // ranks.MODEL
        for g_level, w_level in zip(jax.tree_util.tree_leaves(got["outs"]),
                                    jax.tree_util.tree_leaves(single["outs"])):
            np.testing.assert_allclose(g_level.numpy(), w_level[slice(*got["rows"])].numpy(),
                                       **FORWARD_TOL)
        assert got["metrics"]["loss"] == pytest.approx(single["metrics"]["loss"],
                                                       rel=SPATIAL_LOSS_REL)


# the families whose forward reaches a layer without a band rule, and the layer named
BAND_REFUSALS = {"sparse_rcnn": "roi_align", "detr": "input_proj (Linear)",
                 "yolox": "backbone (CSPDarknet) runs TensorBase.reshape",
                 "centernet": "neck.up0 (ConvTranspose2d)", "solov2": "head (SOLOV2Head)"}


@pytest.mark.slow  # a launch of its own: each family's build and two forwards on every rank
@pytest.mark.parametrize("name", list(fam.FAMILIES))
def test_each_family_on_row_bands_equals_its_whole_loss_or_raises_by_name(extra_runs, name):
    """Each family of ``build_loss_fn`` on bands of its two images over a
    model group of two: the loss equal to the same step's loss on the
    whole images at rtol 1e-5, or, for a family whose forward reaches a
    layer with no band rule (``BAND_REFUSALS``, queued in ``ROADMAP.md``), a
    refusal naming the layer."""
    for r in extra_runs:
        got = r["families"][name]
        if name in BAND_REFUSALS:
            assert got["loss"] is None and BAND_REFUSALS[name] in got["refusal"], got
        else:
            assert got["refusal"] == "" and got["loss"] == pytest.approx(got["want"], rel=1e-5)


def test_a_layer_without_a_band_rule_raises_by_name(runs):
    """A squeeze-and-excitation layer's spatial mean on a band raises,
    naming the layer; so does a step on bands of a tensor-parallel model."""
    for r in runs:
        assert "se (SELayer)" in r["refusals"]["no_rule"] and "mean" in r["refusals"]["no_rule"]
        assert "tensor parallelism on the same model axis" in r["refusals"]["tp"]


# ---------------------------------------------------------------- one process
def _jax_leaves_sharded(jax_model, x, roi):
    """The reference's ``param_sharding_rules`` over a 1 x 2 mesh on the
    model's parameters: a tree of 1.0 where a leaf is sharded over
    ``model``, 0.0 elsewhere (shapes from ``jax.eval_shape``)."""
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), x)
    if roi is not None:
        roi_shapes = jax.eval_shape(lambda k, r: jax_model.init(
            k, r, method=JaxTwoStageDetector.roi_forward), jax.random.PRNGKey(1), roi)
        shapes = {"params": {**shapes["params"], **roi_shapes["params"]},
                  "batch_stats": shapes["batch_stats"]}
    rule = param_sharding_rules(jax_make_mesh(data=1, model=2, devices=jax.devices()[:2]))
    marked = jax.tree_util.tree_map(
        lambda s: np.full(s.shape, float("model" in tuple(rule(np.zeros(s.shape)).spec)),
                          np.float32), shapes["params"])
    return {"params": marked, "batch_stats": jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])}


@pytest.mark.parametrize("which", ["narrow", pytest.param("full", marks=pytest.mark.slow)])
def test_the_tensor_parallel_plan_shards_the_reference_s_leaves(which):
    """The port shards exactly the parameters whose JAX leaves the
    reference's rule shards over ``model=2``, mapped through the port's
    converter, each on its output channels (dim 0 of a conv or linear
    weight). ``full``: the Faster R-CNN R50-FPN of the config."""
    if which == "narrow":
        model_dict = fam.FAMILIES[ranks.NAME][0]
        x = jnp.zeros((1, 64, 64, 3))
        roi = jnp.zeros((1, 4, 7, 7, 32))
    else:
        from torch_detection_tpu_torch.utils.config import Config

        model_dict = Config.fromfile("configs/faster_rcnn_r50_fpn_coco.py")["model"]
        x = jnp.zeros((1, 64, 64, 3))
        roi = jnp.zeros((1, 4, 7, 7, 256))
    port = build_detector(model_dict, "float32", "meta")
    jax_model = JaxTwoStageDetector(**{k: v for k, v in model_dict.items() if k != "type"})
    marked = from_jax_variables(_jax_leaves_sharded(jax_model, x, roi), port)
    want = {n for n, v in marked.items() if v.numel() and bool((v == 1).all())}
    plan = tensor_parallel_plan(port, 2)
    assert set(plan) == want and len(want) > 10
    assert set(plan.values()) == {0}
    shapes = dict(port.named_parameters())
    assert all(shapes[n].shape[0] % 2 == 0 for n in plan)


@pytest.mark.slow  # the JAX side's jit of the accumulated step: about 20 s
def test_one_process_accumulation_at_three_equals_the_reference():
    """The port's one-process ``make_train_step(accum_steps=3)`` with an EMA
    on six images (three micro-batches of two), the reference's draws of
    each step handed to every micro-batch (R15), against the JAX package's
    one-device ``make_train_step(accum_steps=3)`` on the same weights and
    batch, made with numpy from a seed: two steps' losses at rtol 1e-5,
    the parameters and the averages at atol 1e-6, rtol 1e-5."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(3)
    jax_model = JaxTwoStageDetector(**MODEL)
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
    thirds = [_batch(rng) for _ in range(3)]
    batch = {k: np.concatenate([t[k] for t in thirds]) for k in thirds[0]}

    def step_loss(params, batch_stats, batch, step=0):
        key = jax.random.fold_in(jax.random.PRNGKey(ranks.ACCUM), step)
        out = jax_faster_rcnn_loss(jax_cfg, jax_model,
                                   {"params": params, "batch_stats": batch_stats}, batch, key)
        return out["loss"], out

    tx = jax_make_optimizer(jax_lr_schedule(fam.LR, 100, 12), fam.MOMENTUM, fam.WD, fam.CLIP)
    jax_step = jax_make_train_step(step_loss, tx, donate_state=False, accum_steps=3,
                                   ema_decay=ranks.DECAY)
    state = create_train_state(variables["params"], tx, batch_stats=variables["batch_stats"],
                               ema=True)
    want = []
    for _ in range(ranks.STEPS):
        state, metrics = jax_step(state, batch)
        want.append(float(metrics["loss"]))
    want_params = from_jax_variables({"params": state.params})
    want_ema = from_jax_variables({"params": state.ema_params})

    n_anchors = sum(3 * (64 // s) ** 2 for s in ANCHORS["strides"])
    draws = [_jax_draws(jax.random.fold_in(jax.random.PRNGKey(ranks.ACCUM), s), 2,
                        (n_anchors, PROPOSALS["post_nms_top_k"] + 4)) for s in range(ranks.STEPS)]
    cfg = FasterRCNNConfig(num_classes=3, anchor_generator=AnchorGenerator(**ANCHORS),
                           proposal_train=ProposalConfig(**PROPOSALS),
                           proposal_test=ProposalConfig(**PROPOSALS), **SAMPLES)
    model = TwoStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(memory_format=torch.channels_last).train()

    def loss_fn(b, step):
        out = faster_rcnn_loss(cfg, model, b, FixedNoise(draws[step]))
        return out["loss"], {k: v for k, v in out.items() if k != "loss"}

    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(fam.LR, 100), fam.MOMENTUM,
                               fam.WD, fam.CLIP)
    optimizer.ema = ParamEMA(model, ranks.DECAY)
    step = make_train_step(loss_fn, optimizer, accum_steps=3)
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = [float(step(tensors)["loss"]) for _ in range(ranks.STEPS)]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params = dict(model.named_parameters())
    for name, e in zip(optimizer.ema.names, optimizer.ema.tensors):
        np.testing.assert_allclose(params[name].detach().numpy(), want_params[name].numpy(),
                                   atol=1e-6, rtol=1e-5, err_msg=name)
        np.testing.assert_allclose(e.numpy(), want_ema[name].numpy(), atol=1e-6, rtol=1e-5,
                                   err_msg=name)
