"""``tools.train`` and ``tools.test --shard-eval`` launched by torchrun with 2 CPU ranks.

The port's counterpart of ``tests/test_multihost_train.py::
test_multiprocess_training_through_cli``: the same RetinaNet R18 config on
``make_golden_coco`` (8 square images, one aspect group), ``sample_per_replica``
4, so that each epoch is one step of all 8 images; 2 epochs with
validation (spread over the ranks) and checkpoints on. torchrun
(``python -m torch.distributed.run --standalone --nproc_per_node 2
--no-python sh -c ...``) gives each rank a work directory of its own, so
that the test can see that

* rank 0 wrote ``epoch_1/``, ``epoch_2/``, ``best/`` and ``metrics.jsonl``
  (with its validation records) and rank 1 nothing;
* the ranks' ``--dump-final`` parameters are equal bit for bit;
* they equal a one-process run of the same config with
  ``sample_per_replica`` 8 (the same images a step, in another order) at
  ``rtol 2e-4, atol 3e-6``;
* ``tools.test --shard-eval`` on 2 ranks gives rank 0's ``epoch_2`` the
  one-process metrics and the same COCO results dump (``score_thr`` 0 and
  100 detections an image, so that the barely trained weights leave
  detections and some recall);
* each run's epoch-2 validation record, taken over both ranks, equals a
  one-process ``tools.test`` of its ``epoch_2`` checkpoint, which scores
  above 0, so that a validation on stale weights (FSDP's whole parameters
  are rewritten in place between validations) would show;
* the same run under ``runtime.fsdp`` ends at the one-process parameters
  at the reference's FSDP tolerance, ``rtol 2e-3, atol 8e-6``, its
  replicas' whole parameters equal, and its ``epoch_2`` checkpoint loads
  into a one-process model with ``strict=True`` and holds those
  parameters.

The one-process runs take place in this process while the ranks run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from data_fixtures import make_golden_coco
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.engine.checkpoint import load_checkpoint
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli

REPO = Path(__file__).resolve().parent.parent
TIMEOUT_S = 600

MODEL = dict(
    type="SingleStageDetector",
    backbone=dict(type="ResNet", depth=18, num_stages=3, out_indices=(0, 1, 2)),
    neck=dict(type="FPN", in_channels=(64, 128, 256), out_channels=16, num_outs=3),
    head=dict(type="RetinaHead", num_classes=2, in_channels=16, feat_channels=16,
              stacked_convs=1, num_base_anchors=9),
)
CONFIG = """
model = {model!r}
detection = dict(num_classes=2, anchor=dict(strides=(8, 16, 32)), max_detections=100,
                 pre_nms_top_k=1000, score_thr=0.0)
data = dict(
    train=dict(type="CocoDataset", ann_file={ann!r}, img_prefix={img!r}, img_means=(0, 0, 0),
               img_stds=(1, 1, 1), img_expected_sizes=(64, 64), size_divisor=32,
               flip_ratio=0.0),
    val=dict(type="CocoDataset", ann_file={ann!r}, img_prefix={img!r}, img_means=(0, 0, 0),
             img_stds=(1, 1, 1), img_expected_sizes=(64, 64), size_divisor=32, test_mode=True),
    sample_per_replica={spr}, max_gts=4, canvas=(64, 64),
)
optimizer = dict(lr=0.001, momentum=0.9, weight_decay=0.0, grad_clip_norm=35.0)
schedule = dict(total_epochs=2, warmup_steps=0)
runtime = dict(work_dir="unused", log_interval=1, mesh=dict(model=1), compute_dtype="float32",
               val_interval_epochs=1, val_batch=4, checkpoint_interval_epochs=1, fsdp={fsdp})
"""


def torchrun(command: str) -> subprocess.Popen:
    """``command`` (a shell line that may read ``$RANK``) as 2 CPU ranks."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "--no-python", "sh", "-c", command],
        cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen) -> str:
    try:
        out, _ = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == 0, out[-4000:]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_cli")
    ann, img = make_golden_coco(str(root / "golden"))
    configs = {}
    for name, spr, fsdp in (("ranks", 4, False), ("one", 8, False), ("fsdp", 4, True)):
        configs[name] = root / f"{name}.py"
        configs[name].write_text(CONFIG.format(model=MODEL, ann=ann, img=img, spr=spr,
                                                  fsdp=fsdp))
    py = f"{sys.executable} -m torch_detection_tpu_torch.tools"
    ranks = torchrun(f"{py}.train {configs['ranks']} --device cpu --work-dir {root}/work_r$RANK "
                     f"--dump-final {root}/final")
    fsdp = torchrun(f"{py}.train {configs['fsdp']} --device cpu --work-dir {root}/fsdp_r$RANK "
                    f"--dump-final {root}/fsdp_final")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        train_cli.main([str(configs["one"]), "--device", "cpu", "--work-dir", str(root / "one"),
                        "--dump-final", str(root / "one_final")])
        log, fsdp_log = finish(ranks), finish(fsdp)
        ckpt = root / "work_r0" / "epoch_2"
        shard = torchrun(f"{py}.test {configs['ranks']} {ckpt} --device cpu --batch 2 "
                         f"--shard-eval --out {root}/shard.json")
        one_metrics = test_cli.main([str(configs["ranks"]), str(ckpt), "--device", "cpu",
                                     "--batch", "2", "--out", str(root / "one.json")])
        epoch_2 = {run: test_cli.main([str(configs[name]), str(root / f"{run}_r0" / "epoch_2"),
                                       "--device", "cpu", "--batch", "4"])
                   for run, name in (("work", "ranks"), ("fsdp", "fsdp"))}  # val_batch 4
        shard_log = finish(shard)
    finally:
        torch.set_num_threads(threads)
    return dict(root=root, log=log, fsdp_log=fsdp_log, shard_log=shard_log,
                one_metrics=one_metrics, epoch_2=epoch_2)


@pytest.mark.parametrize("run", ["work", "fsdp"])
def test_only_rank_0_writes_the_work_dir(runs, run):
    work0, work1 = runs["root"] / f"{run}_r0", runs["root"] / f"{run}_r1"
    for name in ("epoch_1", "epoch_2", "best"):
        assert (work0 / name / "model.pt").is_file(), (name, runs["log"][-2000:],
                                                      runs["fsdp_log"][-2000:])
    records = [json.loads(line) for line in (work0 / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records if "loss" in r] == [1, 2]  # one record a step
    assert len([r for r in records if "val_mAP" in r]) == 2
    assert all(r["images_per_sec"] > 0 for r in records if "loss" in r)
    assert not work1.exists() or not any(work1.iterdir())


@pytest.mark.parametrize("run", ["work", "fsdp"])
def test_validation_in_training_equals_one_process_test_of_the_checkpoint(runs, run):
    """The epoch-2 validation record (both ranks' images; under FSDP the
    whole parameters gathered anew) holds the one-process metrics of the
    ``epoch_2`` checkpoint, to 1e-12; those metrics are not all 0."""
    want = runs["epoch_2"][run]
    assert any(v > 0 for v in want.values()), want
    records = [json.loads(line)
               for line in (runs["root"] / f"{run}_r0" / "metrics.jsonl").read_text().splitlines()]
    got = [r for r in records if "val_mAP" in r][-1]
    assert got["epoch"] == 1
    for k, v in want.items():
        assert abs(got[f"val_{k}"] - v) <= 1e-12, (k, got, want)


def test_replicas_are_equal_and_equal_one_process(runs):
    root = runs["root"]
    r0, r1 = (dict(np.load(root / f"final.rank{r}.npz")) for r in (0, 1))
    one = dict(np.load(root / "one_final.rank0.npz"))
    assert set(r0) == set(r1) == set(one) and r0
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], rtol=2e-4, atol=3e-6, err_msg=k)


def test_shard_eval_equals_one_process(runs):
    """The 12 metrics to 1e-12 on rank 0 (printed), and the same dump."""
    root = runs["root"]
    printed = [line for line in runs["shard_log"].splitlines()
               if line.startswith("{") and "'mAP'" in line]
    assert len(printed) == 1, runs["shard_log"][-2000:]  # rank 0 alone prints
    shard_metrics = eval(printed[0], {"np": np})
    assert set(shard_metrics) == set(runs["one_metrics"])
    assert any(v > 0 for v in runs["one_metrics"].values()), runs["one_metrics"]
    for k, v in runs["one_metrics"].items():
        assert abs(shard_metrics[k] - v) <= 1e-12, k
    dump = json.loads((root / "one.json").read_text())
    assert dump and json.loads((root / "shard.json").read_text()) == dump


def test_fsdp_run_equals_one_process_and_saves_whole_checkpoints(runs):
    root = runs["root"]
    r0, r1 = (dict(np.load(root / f"fsdp_final.rank{r}.npz")) for r in (0, 1))
    one = dict(np.load(root / "one_final.rank0.npz"))
    assert set(r0) == set(r1) == set(one) and r0
    model = build_detector(MODEL, "float32", "cpu")
    load_checkpoint(model, str(root / "fsdp_r0" / "epoch_2"), strict=True)
    params = dict(model.named_parameters())
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)
        np.testing.assert_array_equal(params[k].detach().numpy(), r0[k], err_msg=k)
        np.testing.assert_allclose(r0[k], one[k], rtol=2e-3, atol=8e-6, err_msg=k)
