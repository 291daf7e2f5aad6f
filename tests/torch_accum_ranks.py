"""Gradient accumulation and the EMA over two gloo ranks, for
``test_torch_train_options.py``.

Every rank builds the same narrow Faster R-CNN of ``torch_dp_families``
from seed 0; rank 0 first takes two one-process steps at ``accum_steps=2``
with an EMA on the whole four-image batch (two micro-batches of two
images); then both ranks take the same two steps on their halves, once
plain and once under FSDP, and rank 0 reports where they depart from the
one process (the losses, every parameter and momentum buffer, every
average). This module imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict

import torch

import torch_dp_families as fam
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.parallel import ParamEMA, make_train_step
from torch_detection_tpu_torch.parallel.distributed import all_gather_objects
from torch_detection_tpu_torch.parallel.mesh import full_tensor

WORLD = 2
DEADLINE_S = 300  # the ranks' run, which takes well under a minute
ACCUM, DECAY, STEPS = 2, 0.5, 2
NAME = "faster_rcnn"


def run(init, batch, fsdp: bool = False) -> Dict[str, object]:
    """``STEPS`` steps at ``accum_steps=ACCUM`` with an EMA: each step's
    metrics, and the state after them with the averages (``ema.`` names)."""
    model, loss_fn, optimizer = fam.build(NAME, init, fsdp=fsdp)
    optimizer.ema = ParamEMA(model, DECAY)
    step = make_train_step(loss_fn, optimizer, accum_steps=ACCUM)
    metrics = [{k: float(v) for k, v in step(batch).items()} for _ in range(STEPS)]
    state = fam.state_of(model, optimizer)
    state.update({"ema." + n: full_tensor(e).detach().clone()
                  for n, e in zip(optimizer.ema.names, optimizer.ema.tensors)})
    return dict(metrics=metrics[-1], losses=[m["loss"] for m in metrics], state=state)


def case(dp, single, tol) -> Dict[str, object]:
    """The replicas' agreement and, on the rank that took the one-process
    run, the departures from it."""
    replicas = all_gather_objects(fam.digests(dp["state"]))
    out = dict(replicas_equal=all(r == replicas[0] for r in replicas), mismatches=None)
    if single is not None:
        out["mismatches"] = fam.mismatches(dp, single, **tol) + [
            f"step {i} loss {g!r} vs {w!r}" for i, (g, w) in enumerate(zip(dp["losses"],
                                                                            single["losses"]))
            if abs(g - w) > fam.LOSS_RTOL * abs(w)]
    return out


def rank_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    torch.set_num_threads(1)
    batch = fam.global_batch()
    init = build_detector(fam.FAMILIES[NAME][0], "float32", "cpu", seed=0).state_dict()
    single = run(init, fam.family_batch(NAME, batch)) if rank == 0 else None

    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from torch_detection_tpu_torch.parallel import init_distributed, shutdown_distributed

    info = init_distributed(device="cpu", timeout_s=120.0)
    b = fam.BATCH // world
    shard = fam.family_batch(NAME, batch, slice(rank * b, (rank + 1) * b))
    report = dict(dp=case(run(init, shard), single, fam.PARAM_TOL),
                  fsdp=case(run(init, shard, fsdp=True), single, fam.FSDP_TOL))
    shutdown_distributed(info)
    torch.save(report, os.path.join(out_dir, f"rank{rank}.pt"))
