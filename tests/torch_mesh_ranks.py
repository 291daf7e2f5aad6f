"""Accumulation over ranks that do not divide it, tensor parallelism and
image-row partitioning on a ``(data, model)`` mesh of four gloo ranks, for
``test_torch_mesh.py``.

A launch's ``part`` is ``core`` or ``extra``. Before the group forms, in
``core``, rank 0 takes the one-process references of the narrow Faster
R-CNN of ``torch_dp_families`` (``accum_steps=3`` with an EMA on the
six-image global batch, two steps; a plain step on the four-image batch),
rank 1 the R18 RetinaNet's (the reference's own spatial case: the forward
and a step on its 128 x 128 batch) and rank 2 the reference's toy
(``tests/test_parallel.py:85-108``: one SGD step of a linear layer). Then
every rank takes, on a 2 x 2 mesh:

* ``accum``: the accumulated steps on its data rank's three images, the
  model ranks replicas (micro-batch 1 spans the two data ranks);
* ``tp``: the same under tensor parallelism; the tensor-parallel
  checkpoint loaded into one process, and the one process's into a
  tensor-parallel model;
* ``toy``: the toy's step under tensor parallelism;
* ``bands``: the Faster R-CNN's step on row bands (its P6 has one row, so
  one rank of each pair owns none), the R18's forward and step on bands;
  a layer with no band rule, and bands over a tensor-parallel model.

``extra`` (slow): ``fsdp`` and ``tp_fsdp``, the accumulated steps under
FSDP over the data ranks, alone and with tensor parallelism, against rank
3's one process; every family's loss on bands (``family_on_bands``).

Each rank writes its report (no tensors but the R18 forward's) to
``out_dir/rank<rank>.pt``. This module imports neither JAX nor the JAX
package.
"""

from __future__ import annotations

import os
from typing import Dict, Optional
from unittest import mock

import torch
from torch.distributed import barrier

import torch_dp_families as fam
from torch_detection_tpu_torch.builder import build_detector, build_loss_fn
from torch_detection_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from torch_detection_tpu_torch.models.layers import SELayer
from torch_detection_tpu_torch.parallel import ParamEMA, make_mesh, make_optimizer, make_train_step
from torch_detection_tpu_torch.parallel.distributed import all_gather_objects, broadcast_object
from torch_detection_tpu_torch.parallel.mesh import full_tensor, local_tensor, shard_batch, \
    shard_model
from torch_detection_tpu_torch.parallel.spatial import bands
from torch_detection_tpu_torch.parallel.tensor_parallel import apply_tensor_parallel

WORLD, DATA, MODEL = 4, 2, 2
DEADLINE_S = 240  # the ranks' run, which takes well under a minute
GROUP_TIMEOUT_S = 60.0  # a mismatched collective fails in a minute
ACCUM, DECAY, STEPS = 3, 0.5, 2
ACCUM_RTOL = 1e-5
ACCUM_FLOOR = 1e-5  # of a tensor's largest entry: the float32 noise of its entries near 0
ROWS = 3  # images a data rank in the accumulated steps
NAME = "faster_rcnn"
TOY_ROWS, TOY_LR = 8, 0.1


def _build(state, mesh=None, tp: bool = False, fsdp: bool = False):
    model = fam.model_from(fam.FAMILIES[NAME][0], state)
    if tp:
        apply_tensor_parallel(model, mesh)
    root = shard_model(model, mesh) if fsdp else None
    optimizer = make_optimizer(model.parameters(), fam.LR, fam.MOMENTUM, fam.WD, fam.CLIP,
                               fsdp_root=root)
    return model, build_loss_fn(model, fam.FAMILIES[NAME][1], rng_seed=5), optimizer


def accumulated(state, batch, mesh=None, tp: bool = False, fsdp: bool = False,
                accum: int = ACCUM, steps: int = STEPS) -> Dict[str, object]:
    """``steps`` steps at ``accum_steps=accum`` with an EMA: the losses,
    the last step's metrics, the state after them (the parameters, the
    momentum buffers and the averages, ``ema.`` names, whole) and the
    parameter elements this rank holds. MKLDNN's convolutions round an
    image otherwise in a batch of one than of two, which flips ReLU and
    max-pool kinks of the trunk's gradient (1% of the stem's) where a
    micro-batch is cut into parts: the native convolution, which computes
    each image alone, runs the steps."""
    model, loss_fn, optimizer = _build(state, mesh, tp, fsdp)
    optimizer.ema = ParamEMA(model, DECAY)
    step = make_train_step(loss_fn, optimizer, accum_steps=accum)
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = [{k: float(v) for k, v in step(batch).items()} for _ in range(steps)]
    out = fam.state_of(model, optimizer)
    out.update({"ema." + n: full_tensor(e).detach().clone()
                for n, e in zip(optimizer.ema.names, optimizer.ema.tensors)})
    held = sum(local_tensor(p).numel() for p in model.parameters())
    return dict(metrics=metrics[-1], losses=[m["loss"] for m in metrics], state=out, held=held,
                model=model, optimizer=optimizer)


def one_step(state, batch, mesh=None) -> Dict[str, object]:
    """One plain step of the narrow Faster R-CNN (on row bands for a
    ``RowBatch``)."""
    model, loss_fn, optimizer = _build(state, mesh)
    return fam.step(model, loss_fn, optimizer, batch)


def compare(got, want, tol, steps: bool = False) -> Optional[list]:
    """The departures of ``got`` from ``want`` (None on a rank without the
    one-process run); ``steps``: each step's loss too."""
    if want is None:
        return None
    out = fam.mismatches(got, want, **tol)
    if steps:
        out += [f"step {i} loss {g!r} vs {w!r}"
                for i, (g, w) in enumerate(zip(got["losses"], want["losses"]))
                if abs(g - w) > fam.LOSS_RTOL * abs(w)]
    return out


def departures(got, want, rtol: float = ACCUM_RTOL) -> Optional[Dict[str, float]]:
    """Each tensor of ``want``'s state (parameters, momentum buffers,
    averages) and each step's loss where ``got`` departs from it beyond
    ``rtol``: how far past, in units of the tensor's largest entry
    (``|x - v| - rtol |v|`` over ``max |v|``). None on a rank without the
    one-process run."""
    if want is None:
        return None
    out = {f"loss{i}": abs(g - w) / abs(w) for i, (g, w) in enumerate(zip(got["losses"],
                                                                        want["losses"]))}
    out = {k: v for k, v in out.items() if v > rtol}
    for name, v in want["state"].items():
        x = got["state"][name]
        past = float(((x - v).abs() - rtol * v.abs()).max()) / max(float(v.abs().max()), 1e-30)
        if past > ACCUM_FLOOR:
            out[name] = past
    return out


def replicas_equal(state) -> bool:
    replicas = all_gather_objects(fam.digests(state))
    return all(r == replicas[0] for r in replicas)


def toy_model(w: torch.Tensor, b: torch.Tensor) -> torch.nn.Module:
    """The reference toy's ``x @ w + b`` as a ``Linear`` (``w`` is (in, out))."""
    lin = torch.nn.Linear(w.shape[0], w.shape[1])
    with torch.no_grad():
        lin.weight.copy_(w.t())
        lin.bias.copy_(b)
    return lin


def toy_step(lin, batch) -> Dict[str, object]:
    """One SGD(0.1) step of the toy's mean squared error: the loss, the
    whole weight after it as (in, out), and the elements this rank holds."""
    optimizer = make_optimizer(lin.parameters(), TOY_LR, 0.0, 0.0)

    def loss_fn(b, step):
        loss = ((lin(b["image"]) - b["y"]) ** 2).mean()
        return loss, {"mse": loss}

    metrics = make_train_step(loss_fn, optimizer)(batch)
    return dict(loss=float(metrics["loss"]), w=full_tensor(lin.weight).detach().t().clone(),
                held=local_tensor(lin.weight).numel())


class _Squeeze(torch.nn.Module):
    """A conv then a squeeze-and-excitation layer, whose spatial mean has no
    band rule."""

    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv2d(3, 4, 3, padding=1)
        self.se = SELayer(4, 2)

    def forward(self, x):
        return self.se(self.conv(x.permute(0, 3, 1, 2)))


def family_on_bands(name: str, batch, rows, mesh) -> Dict[str, object]:
    """``name``'s loss on bands and on the whole images, without gradients,
    or the band context's refusal."""
    model_dict, det_cfg = fam.FAMILIES[name]
    torch.manual_seed(0)  # torch's own initialisers, the same on every rank: the seeded
    with mock.patch("torch_detection_tpu_torch.builder.init_weights"):  # draw takes a second
        model = build_detector(model_dict, "float32", "cpu").train()
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=5)
    whole = fam.family_batch(name, batch, rows)
    banded = shard_batch(mesh, whole, spatial=True)
    with torch.no_grad():
        want = float(loss_fn(whole, step=0)[0])

        def run():
            with bands(banded):
                return float(loss_fn(banded, step=0)[0])

        try:
            return dict(loss=run(), want=want, refusal="")
        except NotImplementedError as e:
            return dict(loss=None, want=want, refusal=str(e))


def refusal(fn) -> str:
    try:
        fn()
    except NotImplementedError as e:
        return str(e)
    return ""


def _references(rank: int, part: str, out_dir: str, toy, batch6, batch4) -> Dict[str, object]:
    """The one-process runs each rank takes before the group forms."""
    out: Dict[str, object] = {}
    if rank == 0:  # the weights every rank starts from
        out["init"] = build_detector(fam.FAMILIES[NAME][0], "float32", "cpu", seed=0).state_dict()
    if part == "core" and rank == 0:
        out["single"] = accumulated(out["init"], fam.family_batch(NAME, batch6))
        out["plain"] = one_step(out["init"], fam.family_batch(NAME, batch4))
        save_checkpoint(os.path.join(out_dir, "single_ckpt"), out["single"]["model"],
                        out["single"]["optimizer"])
    if part == "core" and rank == 1:
        out["r18_init"] = build_detector(fam.R18_MODEL, "float32", "cpu", seed=0).state_dict()
        model = fam.model_from(fam.R18_MODEL, out["r18_init"]).eval()
        with torch.no_grad():
            outs = model(fam.r18_batch()["image"])
        out["r18_single"] = dict(outs=outs, metrics=fam.r18_step(
            out["r18_init"], fam.r18_batch())["metrics"])
    if part == "core" and rank == 2:
        out["toy_single"] = toy_step(toy_model(toy["w"], toy["b"]),
                                     dict(image=toy["x"], y=toy["y"]))
    if part == "extra" and rank == 3:  # the FSDP cases' reference, in this launch
        out["own_init"] = build_detector(fam.FAMILIES[NAME][0], "float32", "cpu",
                                         seed=0).state_dict()
        out["single_fsdp"] = accumulated(out["own_init"], fam.family_batch(NAME, batch6))
    return out


def _case(got, want, tol) -> Dict[str, object]:
    return dict(mismatches=compare(got, want, tol, steps=True), departures=departures(got, want),
                replicas_equal=replicas_equal(got["state"]), held=got["held"])


def _core(rank: int, refs, init, mesh, out_dir: str, toy, batch6, batch4) -> Dict[str, object]:
    d = rank // MODEL
    shard6 = fam.family_batch(NAME, batch6, slice(d * ROWS, (d + 1) * ROWS))
    single = refs.get("single")
    report: Dict[str, object] = {}
    # accumulation over the data ranks: the model ranks replicas, then tensor-parallel
    report["accum"] = _case(accumulated(init, shard6, mesh), single, fam.PARAM_TOL)
    tp_run = accumulated(init, shard6, mesh, tp=True)
    report["tp"] = _case(tp_run, single, fam.PARAM_TOL)
    # the tensor-parallel checkpoint: whole, loadable by one process bit for bit; and back
    ckpt = os.path.join(out_dir, "tp_ckpt")
    save_checkpoint(ckpt, tp_run["model"], tp_run["optimizer"])
    barrier()
    plain_model = fam.model_from(fam.FAMILIES[NAME][0], init)
    load_checkpoint(plain_model, ckpt, strict=True)
    loads_whole = all(torch.equal(p.detach(), tp_run["state"][n])
                      for n, p in plain_model.named_parameters())
    model, _, optimizer = _build(init, mesh, tp=True)
    load_checkpoint(model, os.path.join(out_dir, "single_ckpt"), strict=True, optimizer=optimizer)
    want = broadcast_object(None if single is None else {
        k: v for k, v in single["state"].items() if not k.startswith("ema.")}, src=0)
    resumed = fam.state_of(model, optimizer)
    report["tp_checkpoint"] = dict(loads_whole=loads_whole,
                                   resumes=fam.digests(resumed) == fam.digests(want))
    barrier()

    # the reference's toy under tensor parallelism, its batch over the data ranks
    lin = toy_model(toy["w"], toy["b"])
    apply_tensor_parallel(lin, mesh)
    rows = slice(d * TOY_ROWS // DATA, (d + 1) * TOY_ROWS // DATA)
    report["toy"] = dict(toy_step(lin, dict(image=toy["x"][rows], y=toy["y"][rows])),
                         single=refs.get("toy_single"))

    # row bands: the narrow Faster R-CNN (P6 of one row), the R18 RetinaNet's forward and step
    rows4 = slice(d * fam.BATCH // DATA, (d + 1) * fam.BATCH // DATA)
    banded = shard_batch(mesh, fam.family_batch(NAME, batch4, rows4), spatial=True)
    got = one_step(init, banded, mesh)
    report["bands"] = dict(mismatches=compare(got, refs.get("plain"), fam.PARAM_TOL),
                           replicas_equal=replicas_equal(got["state"]),
                           image_rows=banded["image"].shape[1])
    r18_init = broadcast_object(refs.get("r18_init"), src=1)
    model = fam.model_from(fam.R18_MODEL, r18_init).eval()
    r18_banded = shard_batch(mesh, fam.r18_batch(rows4), spatial=True)
    with torch.no_grad(), bands(r18_banded):
        outs = model(r18_banded["image"])
    report["r18"] = dict(outs=outs, rows=(rows4.start, rows4.stop), single=refs.get("r18_single"),
                         metrics=fam.r18_step(r18_init, r18_banded)["metrics"],
                         band_rows=r18_banded["image"].shape[1])

    # refusals: a layer with no band rule, bands over a tensor-parallel model
    squeeze = _Squeeze()
    image = shard_batch(mesh, dict(image=torch.randn(1, 8, 8, 3)), spatial=True)

    def no_rule():
        with bands(image):
            squeeze(image["image"])

    _, tp_loss, tp_optimizer = _build(init, mesh, tp=True)
    report["refusals"] = dict(no_rule=refusal(no_rule), tp=refusal(
        lambda: make_train_step(tp_loss, tp_optimizer)(banded)))
    return report


def _extra(rank: int, refs, init, mesh, batch6, batch4) -> Dict[str, object]:
    d = rank // MODEL
    shard6 = fam.family_batch(NAME, batch6, slice(d * ROWS, (d + 1) * ROWS))
    report: Dict[str, object] = {}
    # FSDP over the data ranks, alone and under tensor parallelism, micro-batch 1 spanning them
    for case, tp in (("fsdp", False), ("tp_fsdp", True)):
        report[case] = _case(accumulated(init, shard6, mesh, tp=tp, fsdp=True),
                             refs.get("single_fsdp"), fam.FSDP_TOL)
        if "own_init" in refs:
            report[case]["same_init"] = fam.digests(refs["own_init"]) == fam.digests(init)
    # every family of build_loss_fn on bands of its data rank's two images, against the step's
    # loss on the whole images (the same normalisers over the data ranks), or its refusal
    rows4 = slice(d * fam.BATCH // DATA, (d + 1) * fam.BATCH // DATA)
    report["families"] = {name: family_on_bands(name, batch4, rows4, mesh)
                          for name in fam.FAMILIES}
    return report


def rank_worker(rank: int, world: int, port: int, out_dir: str, toy: Dict[str, torch.Tensor],
                part: str = "core") -> None:
    """One rank of a launch: ``part`` ``core`` (accumulation with and
    without tensor parallelism, its checkpoint, the toy, row bands, the
    refusals) or ``extra`` (FSDP with and without tensor parallelism, every family on
    bands), whose cases are slow."""
    torch.set_num_threads(1)
    batch6 = fam.global_batch(b=DATA * ROWS)
    batch4 = fam.global_batch()
    refs = _references(rank, part, out_dir, toy, batch6, batch4)

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from torch_detection_tpu_torch.parallel import init_distributed, shutdown_distributed

    info = init_distributed(device="cpu", timeout_s=GROUP_TIMEOUT_S)
    init = broadcast_object(refs.get("init"), src=0)
    mesh = make_mesh(data=DATA, model=MODEL, device_type="cpu")
    if part == "core":
        report = _core(rank, refs, init, mesh, out_dir, toy, batch6, batch4)
    else:
        report = _extra(rank, refs, init, mesh, batch6, batch4)
    shutdown_distributed(info)
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
