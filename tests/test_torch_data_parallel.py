"""The port's data-parallel and FSDP steps against one process on the global batch.

One spawn of two gloo ranks on the CPU (``torch_dp_families.rank_worker``)
runs, for every family of ``build_loss_fn`` on its narrow model, one SGD
step (momentum, weight decay, a global-norm clip the gradients exceed) on
its half of a four-image batch whose halves hold 4 and 3 gts; then one
FSDP step of Faster R-CNN, a validation, a second step and a validation,
its checkpoint, and a resume of it; a
``Trainer`` that one rank alone is asked to stop; then one
step of the JAX package's 2-device mesh test model (RetinaNet R18,
``tests/test_multihost_train.py``) from that test's own weights
(``jax.jit(model.init)``), which this process writes while the ranks run
the families, before it takes the JAX package's mesh step itself
(``jax.jit`` over two of the CPU devices).

The reference's promise is that N replicas give one device's result on the
concatenated batch. So in each case the rank that draws the initial
weights also takes the one-process step on the whole batch, before the
group forms, and reports where the ranks' step departs from it: the loss beyond 2e-5 (relative), the skip
decision, any parameter beyond ``rtol 2e-4, atol 2e-6`` (FSDP: ``2e-3,
8e-6``, the reference's FSDP tolerance), any momentum buffer (after one
step the clipped gradient plus the decay) beyond ``1e-4`` of its largest
entry, at the least 1e-8, the rounding noise of a zero gradient (the
attention key bias's). The replicas must be equal bit for bit (a digest of
every parameter and momentum buffer), each FSDP validation must give a
one-process model's features bit for bit, the FSDP checkpoint must load
into a one-process model with ``strict=True`` holding the steps' parameters and
resume into a sharded model with the same state, and the R18 step's
parameters must equal the JAX mesh step's at ``rtol 2e-4, atol 2e-6``.
The ranks send reports, not tensors; torch runs on one thread in every
process.
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
from torch_detection_tpu.models.detectors import RetinaNetConfig as JaxRetinaNetConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import retina_loss as jax_retina_loss
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.parallel import (
    create_train_state,
    make_mesh,
    make_train_step,
    shard_batch,
    shard_params,
)
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.models import from_jax_variables

WORLD = 2
DEADLINE_S = 600  # the ranks' run, which takes well under a minute


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_r18_variables():
    """The reference test's R18 model and its ``model.init`` variables."""
    model = JaxSingleStageDetector(**{k: v for k, v in fam.R18_MODEL.items() if k != "type"})
    x = jnp.zeros((1, *fam.R18_CANVAS, 3), jnp.float32)
    return model, jax.tree_util.tree_map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), x))


def jax_mesh_step(model, variables, batch):
    """The JAX package's data-parallel step on a 2-device mesh, as
    ``tests/test_multihost_train.py`` takes it: (loss, params after)."""
    det_cfg = JaxRetinaNetConfig(num_classes=2, anchor_generator=JaxAnchorGenerator(
        strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0), octave_base_scale=4.0,
        scales_per_octave=3))

    def loss_fn(params, batch_stats, batch):
        cls, reg = model.apply({"params": params, "batch_stats": batch_stats}, batch["image"],
                               train=True)
        losses = jax_retina_loss(det_cfg, cls, reg, batch["gt_boxes"], batch["gt_labels"],
                                 batch["gt_valid"], img_shapes=batch.get("img_shape"))
        return losses["loss"], {"loss_cls": losses["loss_cls"]}

    tx = optax.sgd(0.01, momentum=0.9)
    mesh = make_mesh(data=2, model=1, devices=jax.devices()[:2])
    with mesh:
        state = create_train_state(shard_params(mesh, variables["params"]), tx,
                                   batch_stats=shard_params(mesh, variables["batch_stats"]))
        step = make_train_step(loss_fn, tx, mesh=mesh, donate_state=False)(state)
        state, metrics = step(state, shard_batch(mesh, batch))
    return float(metrics["loss"]), jax.device_get(state.params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{'ranks': each rank's report, 'jax': the mesh step's loss and the
    port names of its parameters, 'r18': rank 0's R18 parameters}."""
    out = tmp_path_factory.mktemp("dp")
    ctx = mp.start_processes(fam.rank_worker,
                             args=(WORLD, free_port(), str(out), list(fam.FAMILIES)),
                             nprocs=WORLD, join=False, start_method="spawn")
    try:
        jax_model, variables = jax_r18_variables()
        port_r18 = build_detector(fam.R18_MODEL, "float32", "cpu")
        torch.save(from_jax_variables(variables, port_r18), out / "r18_init.tmp")
        (out / "r18_init.tmp").rename(out / fam.R18_INIT)  # whole when the ranks see it
        loss, params = jax_mesh_step(jax_model, variables,
                                     {k: v.numpy() for k, v in fam.r18_batch().items()})
        jax_params = from_jax_variables({"params": params}, port_r18)
        deadline = time.monotonic() + DEADLINE_S
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "the ranks did not finish"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(WORLD)]
    r18 = torch.load(out / fam.R18_DP)
    for name in (fam.R18_INIT, fam.R18_DP):  # the only tensors on disk, 45 MB each
        (out / name).unlink()
    return dict(ranks=ranks, jax=dict(loss=loss, params=jax_params), r18=r18)


@pytest.mark.parametrize("name", list(fam.FAMILIES) + ["fsdp", "r18"])
def test_two_ranks_equal_one_process_on_the_global_batch(runs, name):
    """Each family's 2-rank step (and the FSDP and R18 cases): the one
    process's loss, skip decision, parameters and momentum; the replicas
    equal bit for bit."""
    reports = [r[name] for r in runs["ranks"]]
    assert all(r["replicas_equal"] for r in reports), f"{name}: the replicas differ"
    assert reports[0]["metrics"] == reports[1]["metrics"], name
    compared = [r for r in reports if r["mismatches"] is not None]
    assert len(compared) == 1, name
    assert compared[0]["mismatches"] == [], (name, compared[0]["metrics"],
                                             compared[0]["single_metrics"])


def test_fsdp_validation_sees_each_step(runs):
    """The FSDP model's inference within ``unsharded`` (the trainer's
    validation) after each of two steps equals, bit for bit, a one-process
    model holding that step's parameters: the second does not reuse the
    ``FrozenBatchNorm`` folds the first cached, though FSDP's all-gather
    writes the parameters without a new version."""
    for r in runs["ranks"]:
        assert r["fsdp_validation"] == [True, True]


def test_fsdp_checkpoint_is_whole_and_resumes(runs):
    """The FSDP step's checkpoint loads into a one-process model with
    ``strict=True`` and holds the step's whole parameters; loaded back into
    a sharded model (each rank its shards) it gives the step's state, the
    momentum and the step count included."""
    for r in runs["ranks"]:
        assert r["fsdp_checkpoint"] == dict(loads_whole=True, resumes=True)


def test_a_stop_on_one_rank_stops_every_rank_after_the_same_step(runs):
    """Rank 1's trainer alone is asked to stop during step 2 of 4 (as its
    SIGTERM handler asks): both ranks stop after step 2, and rank 0 alone
    writes ``step_2`` and ``metrics.jsonl``."""
    r0, r1 = (r["preemption"] for r in runs["ranks"])
    assert r0["steps"] == r1["steps"] == 2 and r0["preempted"] and r1["preempted"]
    assert r0["wrote"] == ["metrics.jsonl", "step_2"] and r1["wrote"] == []


def test_two_ranks_equal_the_reference_mesh_step(runs):
    """The R18 RetinaNet's 2-rank step equals the JAX package's 2-device
    mesh step from the same weights: the loss to 2e-5, every parameter at
    ``rtol 2e-4, atol 2e-6``."""
    got = runs["r18"]
    loss = runs["ranks"][0]["r18"]["metrics"]["loss"]
    np.testing.assert_allclose(loss, runs["jax"]["loss"], rtol=fam.LOSS_RTOL)
    assert set(runs["jax"]["params"]) == set(got)
    for name, want in runs["jax"]["params"].items():
        if not torch.allclose(got[name], want, **fam.PARAM_TOL):
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), **fam.PARAM_TOL,
                                       err_msg=name)
