"""The port's ``train`` and ``test`` CLIs, in-process on the CPU.

A config whose ``_base_`` is ``configs/faster_rcnn_r50_fpn_coco.py``, cut to
``test_torch_train.py``'s tiny Faster R-CNN in float32 on the PNG COCO
fixture (b2 on a 64 x 64 canvas, two steps an epoch, validation every
epoch): ``tools.train`` writes ``epoch_N/``, ``best/`` and
``metrics.jsonl``; one epoch and ``--auto-resume`` equal two epochs bit for
bit; ``tools.test``
gives the 12 COCO metrics and a COCO results JSON; ``--profile-dir`` writes
a trace; ``tools.export --check`` round-trips a serving artifact; the knobs
the port does not do raise ``NotImplementedError``, and without ``--device
cpu`` both CLIs ask for a GPU.
"""

import json
import math
import os
import shutil

import pytest
import torch

import torch_refs
from test_torch_data import write_png_coco
from test_torch_detr import MODEL as DETR_MODEL
from test_torch_engine import METRICS
from test_torch_train import TRAIN_MODEL
from torch_detection_tpu_torch.data import build_dataloader
from torch_detection_tpu_torch.engine.checkpoint import latest_checkpoint, load_checkpoint_file
from torch_detection_tpu_torch.tools import export as export_cli
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli

MODEL = dict(TRAIN_MODEL, type="TwoStageDetector",
             bbox_head=dict(TRAIN_MODEL["bbox_head"], num_classes=2))  # the fixture's classes
BASE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                    "faster_rcnn_r50_fpn_coco.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_config(path, coco, **runtime):
    ann, prefix = coco["ann_file"], coco["img_prefix"]
    runtime = {**dict(compute_dtype="float32", log_interval=1, val_interval_epochs=1,
                      val_batch=2), **runtime}
    text = f"""_base_ = {os.path.abspath(BASE)!r}
model = dict(_delete_=True, **{MODEL!r})
detection = dict(num_classes=2, max_detections=8)
data = dict(
    train=dict(ann_file=[{ann!r}, {ann!r}], img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    val=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    sample_per_replica=2, max_gts=8, canvas=(64, 64),
)
schedule = dict(warmup_steps=2)
runtime = dict(**{runtime!r})
"""
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two epochs through ``tools.train`` on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    config = _write_config(root / "tiny.py", write_png_coco(root / "coco"))
    work = root / "work"
    trainer = train_cli.main([config, "--epochs", "2", "--work-dir", str(work),
                              "--device", "cpu"])
    return config, work, trainer


def _records(work):
    with open(work / "metrics.jsonl") as f:
        return [json.loads(line) for line in f]


def test_train_cli_writes_checkpoints_metrics_and_best(trained):
    _, work, trainer = trained
    assert sorted(os.listdir(work)) == ["best", "epoch_1", "epoch_2", "metrics.jsonl"]
    assert latest_checkpoint(str(work)) == str(work / "epoch_2")
    steps = [r for r in _records(work) if "loss" in r]
    vals = [r for r in _records(work) if "val_mAP" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4] and [r["epoch"] for r in vals] == [0, 1]
    assert all(math.isfinite(r["loss"]) and r["skipped_steps"] == 0 for r in steps)
    assert set(vals[0]) == {"epoch"} | {f"val_{k}" for k in METRICS}
    assert trainer.optimizer.steps == 4 and trainer.loader_wait_s > 0


def test_one_epoch_and_auto_resume_equal_two_epochs(trained, tmp_path):
    """``--auto-resume`` in a work dir holding only ``epoch_1``: epoch 2's
    steps continue the count, and its ``epoch_2`` equals the straight run's
    bit for bit, the model's and the optimizer's state (one CPU thread)."""
    config, work, _ = trained
    shutil.copytree(work / "epoch_1", tmp_path / "work" / "epoch_1")
    trainer = train_cli.main([config, "--epochs", "2", "--work-dir", str(tmp_path / "work"),
                              "--auto-resume", "--device", "cpu"])
    steps = [r for r in _records(tmp_path / "work") if "loss" in r]
    assert [(r["epoch"], r["step"]) for r in steps] == [(1, 3), (1, 4)]
    assert [r["loss"] for r in steps] == [r["loss"] for r in _records(work) if "loss" in r][2:]
    assert trainer.optimizer.steps == 4
    got = load_checkpoint_file(str(tmp_path / "work" / "epoch_2"))
    want = load_checkpoint_file(str(work / "epoch_2"))
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for name, state in want["optimizer"]["state"].items():
        assert torch.equal(got["optimizer"]["state"][name]["momentum_buffer"],
                           state["momentum_buffer"]), name
    assert got["optimizer"]["steps"] == 4 and got["meta"]["step"] == want["meta"]["step"]


def test_test_cli_dumps_coco_results(trained, tmp_path):
    config, work, _ = trained
    out = tmp_path / "res.json"
    metrics = test_cli.main([config, str(work / "epoch_2"), "--batch", "2", "--out", str(out),
                             "--device", "cpu"])
    assert set(metrics) == set(METRICS) and all(math.isfinite(v) for v in metrics.values())
    records = json.loads(out.read_text())
    assert records and {r["category_id"] for r in records} <= {11, 13}
    assert {r["image_id"] for r in records} <= {1, 2, 3}
    for r in records:
        x, y, w, h = r["bbox"]
        assert w > 0 and h > 0 and x + w <= 101 and y + h <= 101 and 0 < r["score"] <= 1


def test_clis_train_and_test_detr_from_a_torchvision_pth(tmp_path):
    """A model without a neck through both CLIs: ``tools.train`` on the tiny
    DETR from a torchvision-named ResNet-18 ``.pth`` (every backbone tensor
    loads), then ``tools.test`` on its ``epoch_1`` and on the ``.pth``."""
    coco = write_png_coco(tmp_path / "coco")
    base = os.path.join(os.path.dirname(BASE), "detr_r50_coco.py")
    ann, prefix = coco["ann_file"], coco["img_prefix"]
    config = tmp_path / "detr.py"
    config.write_text(f"""_base_ = {os.path.abspath(base)!r}
model = dict(_delete_=True, **{dict(DETR_MODEL, type="DETR", num_classes=2)!r})
detection = dict(num_classes=2, num_queries=8, max_detections=8)
data = dict(
    train=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    val=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    sample_per_replica=2, max_gts=8, canvas=(64, 64),
)
schedule = dict(warmup_steps=2)
runtime = dict(compute_dtype="float32", log_interval=1)
""")
    torch.manual_seed(0)
    state = torch_refs.torch_resnet18().state_dict()
    pth = tmp_path / "resnet18.pth"
    torch.save(state, str(pth))
    trainer = train_cli.main([str(config), "--epochs", "1", "--work-dir", str(tmp_path / "work"),
                              "--pretrained", f"torch://{pth}", "--device", "cpu"])
    saved = load_checkpoint_file(str(tmp_path / "work" / "epoch_1"))["model"]
    assert torch.equal(saved["backbone.stem.conv.weight"], state["conv1.weight"])  # frozen
    assert trainer.optimizer.steps == 2
    for ckpt in (str(tmp_path / "work" / "epoch_1"), f"torch://{pth}"):
        metrics = test_cli.main([str(config), ckpt, "--batch", "2", "--device", "cpu"])
        assert set(metrics) == set(METRICS) and all(math.isfinite(v) for v in metrics.values())


@pytest.mark.parametrize("knob", [dict(mesh=dict(model=2))])
def test_train_cli_refuses_unported_knobs(tmp_path, knob):
    """A ``model`` axis of 2 needs two ranks (tensor parallelism is ported:
    ``test_torch_mesh.py``): one process refuses the mesh by name."""
    config = _write_config(tmp_path / "knob.py", dict(ann_file="a.json", img_prefix="."), **knob)
    with pytest.raises(ValueError, match=next(iter(knob))):
        train_cli.main([config, "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--shard-eval"])
def test_test_cli_refuses_unported_flags(tmp_path, flag):
    """``--shard-eval`` needs a launch of several processes: in one it raises."""
    config = _write_config(tmp_path / "flag.py", dict(ann_file="a.json", img_prefix="."))
    with pytest.raises(ValueError, match=flag):
        test_cli.main([config, "ckpt", flag, "--device", "cpu"])


def test_train_cli_profile_dir_writes_a_trace(tmp_path):
    """``--profile-dir`` traces the first epoch: the steps' ``train_step``
    spans and the loader's ``data`` spans from ``annotate``, and the
    operators of the step inside them."""
    config = _write_config(tmp_path / "p.py", write_png_coco(tmp_path / "coco"),
                           val_interval_epochs=0)
    trainer = train_cli.main([config, "--epochs", "1", "--work-dir", str(tmp_path / "work"),
                              "--profile-dir", str(tmp_path / "prof"), "--device", "cpu"])
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = [e.get("name") for e in events if e.get("ph") == "X"]
    spans = [e.get("name") for e in events if e.get("cat") == "user_annotation"]
    assert spans.count("train_step") == trainer.optimizer.steps == 2
    assert spans.count("data") >= 2
    assert "aten::convolution_backward" in names


def test_distributed_sampler_raises():
    """The distributed sampler refuses a rank outside its replicas."""
    with pytest.raises(ValueError, match="rank 2"):
        build_dataloader([], dist=True, num_replicas=2, rank=2)


def test_export_cli_check_on_the_cpu(tmp_path):
    """``tools.export --check``: the artifact of the tiny config round-trips
    and equals the live module bit for bit."""
    config = _write_config(tmp_path / "e.py", dict(ann_file="a.json", img_prefix="."))
    out = tmp_path / "serve.pt2"
    result = export_cli.main([config, "--out", str(out), "--batch", "2", "--canvas", "64x64",
                              "--check", "--device", "cpu"])
    assert out.is_file() and result["mb"] > 1 and result["canvas"] == (64, 64)
    assert result["max_diff"] == dict(boxes=0.0, scores=0.0, labels=0.0, valid=0.0)
    got = result["loaded"](*export_cli.check_inputs(2, (64, 64), False, seed=1))
    assert got["boxes"].shape == (2, 8, 4) and got["valid"].dtype == torch.bool


def test_clis_default_to_cuda(tmp_path, monkeypatch):
    """Without ``--device`` both CLIs ask for the GPU; without one they raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _write_config(tmp_path / "c.py", dict(ann_file="a.json", img_prefix="."))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main([config])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        test_cli.main([config, "ckpt"])
