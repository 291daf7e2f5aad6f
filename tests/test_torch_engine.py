"""The port's engine against the JAX package's: COCO mAP, the results
dump, checkpoints, the trainer's records and resume, and
``evaluate_detector``.

``eval_coco_map`` is held to the reference's on seeded detections with
crowds and empty images, all 12 metrics and every class's AP to 1e-12. A
checkpoint round trip gives the model's and the optimizer's state back bit
for bit. The trainer's ``metrics.jsonl`` records carry the reference
trainer's keys, ``best/`` follows the validation hook, and a tiny Faster
R-CNN (``test_torch_train.py``'s) trained on the PNG COCO fixture for two
epochs equals one epoch plus a resume, and a mid-epoch ``step_N`` resume
(after a SIGTERM) equals the straight run, bit for bit on one CPU thread.
``evaluate_detector`` of ``test_torch_model.py``'s tiny Faster R-CNN, on
weights converted from the JAX variables, gives the reference's detections
to 1e-4 and its metrics to 1e-6 on the same dataset; it is the one test
here that jits.
"""

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_data import write_png_coco
from test_torch_model import ANCHORS, MODEL, _randomise_frozen_bn
from test_torch_train import PROPOSALS, SAMPLES, TRAIN_MODEL
from torch_detection_tpu.data import get_datasets as jax_get_datasets
from torch_detection_tpu.engine import Trainer as JaxTrainer
from torch_detection_tpu.engine import eval as jax_eval
from torch_detection_tpu.engine import validate as jax_validate
from torch_detection_tpu.models.detectors import FasterRCNNConfig as JaxFasterRCNNConfig
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.data import get_datasets
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule
from torch_detection_tpu_torch.engine import checkpoint, validate
from torch_detection_tpu_torch.engine.eval import _match_image as eval_match_image
from torch_detection_tpu_torch.engine.eval import eval_coco_map
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import FasterRCNNConfig, TwoStageDetector
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.parallel import make_optimizer
from torch_detection_tpu_torch.utils.config import Config

CONFIG = os.path.join(os.path.dirname(__file__), "..", "configs", "faster_rcnn_r50_fpn_coco.py")
MEANS, STDS = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
METRICS = ("mAP", "mAP_50", "mAP_75", "mAP_s", "mAP_m", "mAP_l",
           "AR_1", "AR_10", "AR_100", "AR_s", "AR_m", "AR_l")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the resume tests compare bits, and the test
    workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return write_png_coco(tmp_path_factory.mktemp("coco"))


# ---------------------------------------------------------------- COCO mAP
def _seeded_eval_inputs(seed: int, num_classes: int, with_crowd_labels: bool):
    """Per image: 0-12 gts of every size bucket, 0-2 crowd boxes, and
    detections that jitter the gts or fall anywhere; one image without gts,
    one without detections."""
    rng = np.random.default_rng(seed)
    detections, annotations = [], []
    for i in range(9):
        g = 0 if i == 3 else int(rng.integers(1, 13))
        xy = rng.uniform(0, 300, (g, 2))
        wh = np.exp(rng.uniform(np.log(4), np.log(300), (g, 2)))
        gts = np.concatenate([xy, xy + wh], 1)
        labels = rng.integers(1, num_classes + 1, g)
        c = int(rng.integers(0, 3))
        cxy = rng.uniform(0, 300, (c, 2))
        crowds = np.concatenate([cxy, cxy + rng.uniform(40, 200, (c, 2))], 1)
        ann = dict(bboxes=gts.astype(np.float32), labels=labels, bboxes_ignore=crowds)
        if with_crowd_labels:
            ann["labels_ignore"] = rng.integers(1, num_classes + 1, c)
            ann["areas"] = wh.prod(1) * rng.uniform(0.5, 1.0, g)
        annotations.append(ann)
        d = 0 if i == 5 else int(rng.integers(0, 40))
        pick = rng.integers(0, max(g, 1), d)
        jitter = rng.normal(0, 6, (d, 4))
        rxy = rng.uniform(0, 300, (d, 2))
        anywhere = np.concatenate([rxy, rxy + rng.uniform(4, 100, (d, 2))], 1)
        boxes = gts[pick] + jitter if g else anywhere
        boxes = np.where((rng.uniform(size=d) < 0.3)[:, None], anywhere, boxes)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        keep_label = rng.uniform(size=d) < 0.8
        det_labels = np.where(keep_label, labels[pick] if g else 1,
                              rng.integers(1, num_classes + 1, d))
        detections.append(dict(boxes=boxes.astype(np.float32),
                               scores=rng.uniform(0.05, 1, d).astype(np.float32),
                               labels=det_labels))
    return detections, annotations


@pytest.mark.parametrize("with_crowd_labels", (True, False))
@pytest.mark.parametrize("seed", (0, 1))
def test_eval_coco_map_equals_the_reference(seed, with_crowd_labels):
    detections, annotations = _seeded_eval_inputs(seed, 4, with_crowd_labels)
    got = eval_coco_map(detections, annotations, 4)
    want = jax_eval.eval_coco_map(detections, annotations, 4)
    assert set(got) == set(want) == set(METRICS) | {"per_class"}
    for key in METRICS:
        assert np.isfinite(got[key]) and abs(got[key] - want[key]) <= 1e-12, key
    assert got["per_class"].keys() == want["per_class"].keys()
    for c, ap in got["per_class"].items():
        assert abs(ap - want["per_class"][c]) <= 1e-12
    assert 0 < got["mAP"] < 1


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_match_image_equals_the_reference(seed):
    """The greedy matcher of the VOC protocol, with ignored gts and crowd
    regions."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 100, (12, 2))
    gts = np.concatenate([xy, xy + rng.uniform(10, 60, (12, 2))], 1)
    dets = gts[rng.integers(0, 12, 20)] + rng.normal(0, 8, (20, 4))
    ignore = rng.uniform(size=12) < 0.25
    crowds = np.array([[0.0, 0.0, 80.0, 80.0]])
    for regions in (crowds, np.zeros((0, 4))):
        for thr in (0.3, 0.5, 0.75):
            got = eval_match_image(dets, gts, ignore, regions, thr)
            want = jax_eval._match_image(dets, gts, ignore, regions, thr)
            assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_gt_as_detections_scores_one():
    """The oracle: every gt as a detection of score 1 gives mAP 1."""
    _, annotations = _seeded_eval_inputs(4, 3, True)
    dets = [dict(boxes=a["bboxes"], scores=np.ones(len(a["bboxes"])), labels=a["labels"])
            for a in annotations]
    assert eval_coco_map(dets, annotations, 3)["mAP"] == pytest.approx(1.0, abs=1e-12)


def test_coco_detection_dump_equals_the_reference(coco):
    cfg = dict(type="CocoDataset", ann_file=coco["ann_file"], img_prefix=coco["img_prefix"],
               img_expected_sizes=(96, 64), test_mode=True)
    dataset = get_datasets(cfg)
    detections, _ = _seeded_eval_inputs(2, 2, True)
    detections = detections[: len(dataset)]
    got = validate.coco_detection_dump(dataset, detections)
    want = jax_validate.coco_detection_dump(jax_get_datasets(cfg), detections)
    assert got == want and {r["category_id"] for r in got} <= {11, 13}


# ---------------------------------------------------------------- checkpoints
def _tiny_cfg(coco):
    """The Faster R-CNN config at ``test_torch_train.py``'s width, float32,
    on the PNG COCO fixture twice (four images in two aspect groups), b2 on
    a 64 x 64 canvas: two steps an epoch."""
    cfg = Config.fromfile(CONFIG)
    train = dict(type="CocoDataset", ann_file=[coco["ann_file"]] * 2,
                 img_prefix=coco["img_prefix"], img_means=MEANS, img_stds=STDS,
                 img_expected_sizes=(64, 48), size_divisor=32, flip_ratio=0.5)
    return dict(cfg, model=dict(TRAIN_MODEL, type="TwoStageDetector"),
                detection=dict(cfg.detection, num_classes=3, max_detections=8),
                data=dict(train=train, sample_per_replica=2, max_gts=8, canvas=(64, 64)),
                runtime=dict(cfg.runtime, compute_dtype="float32"),
                schedule=dict(cfg.schedule, warmup_steps=2))


def _train_objects(coco, seed=0):
    """The training objects of ``_tiny_cfg`` with ``test_torch_train.py``'s
    small proposal and sample counts, and the loss."""
    model, det_cfg, loader, optimizer = builder.build_train_objects(_tiny_cfg(coco), "cpu",
                                                                    seed=seed)
    det_cfg = dataclasses.replace(det_cfg, proposal_train=ProposalConfig(**PROPOSALS), **SAMPLES)
    return model, builder.build_loss_fn(model, det_cfg, rng_seed=1), loader, optimizer


def _equal_states(model_a, opt_a, model_b, opt_b):
    sa, sb = model_a.state_dict(), model_b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert (opt_a.steps, opt_a.count) == (opt_b.steps, opt_b.count)
    for pa, pb in zip(opt_a.params, opt_b.params, strict=True):
        a, b = opt_a.torch_optimizer.state[pa], opt_b.torch_optimizer.state[pb]
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_checkpoint_round_trip_is_bit_for_bit(coco, tmp_path):
    """The tiny detector after an epoch of SGD with momentum, and a toy
    model after two AdamW steps, saved and loaded into models built from
    other seeds."""
    model, loss_fn, loader, optimizer = _train_objects(coco)
    Trainer(loss_fn, model, optimizer, loader).run(1)
    checkpoint.save_checkpoint(str(tmp_path / "epoch_1"), model, optimizer, {"epoch": 1})
    other, _, _, other_opt = _train_objects(coco, seed=7)
    meta = checkpoint.load_checkpoint(other, str(tmp_path / "epoch_1"), strict=True,
                                      optimizer=other_opt)
    assert meta["epoch"] == 1 and "time" in meta
    _equal_states(model, optimizer, other, other_opt)
    assert all("momentum_buffer" in other_opt.torch_optimizer.state[p] for p in other_opt.params)

    toys = [nn.Sequential(nn.Linear(3, 4), nn.Linear(4, 1)) for _ in range(2)]
    opts = [make_optimizer(t.parameters(), 0.1, weight_decay=0.01, kind="adamw") for t in toys]
    for _ in range(2):
        opts[0].zero_grad()
        toys[0](torch.ones(2, 3)).sum().backward()
        opts[0].apply(opts[0].global_norm())
        opts[0].steps += 1
    checkpoint.save_checkpoint(str(tmp_path / "adamw"), toys[0], opts[0])
    checkpoint.load_checkpoint(toys[1], str(tmp_path / "adamw"), strict=True, optimizer=opts[1])
    _equal_states(toys[0], opts[0], toys[1], opts[1])


def test_load_checkpoint_reports_keys_by_name(tmp_path, caplog):
    model = nn.Sequential(nn.Linear(2, 3), nn.Linear(3, 1))
    checkpoint.save_checkpoint(str(tmp_path / "ck"), model, meta={"step": 4})
    wider = nn.Sequential(nn.Linear(2, 3), nn.Linear(3, 1), nn.Linear(1, 1))
    with pytest.raises(RuntimeError, match=r"missing keys: \['2.bias', '2.weight'\]"):
        checkpoint.load_checkpoint(wider, str(tmp_path / "ck"), strict=True)
    assert checkpoint.load_checkpoint(wider, str(tmp_path / "ck"))["step"] == 4
    assert "2.weight" in caplog.text and torch.equal(wider[0].weight, model[0].weight)
    with pytest.raises(NotImplementedError, match="torch_import"):
        checkpoint.load_checkpoint(model, "torch://w.pth")


def test_latest_checkpoint_is_the_newest(tmp_path):
    assert checkpoint.latest_checkpoint(str(tmp_path)) is None
    model = nn.Linear(2, 2)
    for i, name in enumerate(("epoch_2", "step_9", "epoch_10", "best")):
        checkpoint.save_checkpoint(str(tmp_path / name), model)
        os.utime(tmp_path / name / checkpoint.META_FILE, (1000 + i, 1000 + i))
    (tmp_path / "step_99").mkdir()  # no meta: not a checkpoint
    assert checkpoint.latest_checkpoint(str(tmp_path)) == str(tmp_path / "epoch_10")


# ---------------------------------------------------------------- the trainer
class _Batches:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def iter_batches(self, skip_batches=0):
        return iter([dict(b) for b in self.batches[skip_batches:]])

    def __len__(self):
        return len(self.batches)


def _toy_batches(n):
    return [dict(image=np.full((2, 1, 1, 3), i + 1.0, np.float32), img_meta=[{}, {}])
            for i in range(n)]


def test_metrics_records_carry_the_reference_keys(tmp_path):
    """One logged step and one validation record of each trainer, on a toy
    loss with one metric of its own."""
    batches = _toy_batches(1)

    def jax_loss(params, batch_stats, batch):
        loss = jnp.sum((params["w"] * batch["image"].mean()) ** 2)
        return loss, {"loss_toy": loss}

    schedule = detection_lr_schedule(0.1, 1, warmup_steps=1)
    jax_trainer = JaxTrainer(jax_loss, {"params": {"w": jnp.ones(3)}}, optax.sgd(0.1),
                             _Batches(batches), work_dir=str(tmp_path / "jax"), log_interval=1,
                             checkpoint_interval_epochs=100, lr_schedule=schedule,
                             val_hook=lambda v: {"AR_100": 0.5})
    jax_trainer.run(1)
    model = nn.Linear(3, 1, bias=False)

    def loss_fn(batch, step):
        loss = (model(batch["image"].mean(dim=(1, 2))) ** 2).sum()
        return loss, {"loss_toy": loss}

    trainer = Trainer(loss_fn, model, make_optimizer(model.parameters(), schedule), _Batches(batches),
                      work_dir=str(tmp_path / "port"), log_interval=1,
                      checkpoint_interval_epochs=100,
                      val_hook=lambda: {"AR_100": 0.5})
    trainer.run(1)

    def records(path):
        with open(os.path.join(path, "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]

    got, want = records(trainer.work_dir), records(jax_trainer.work_dir)
    assert [set(r) for r in got] == [set(r) for r in want]
    assert got[0]["step"] == want[0]["step"] == 1 and got[0]["lr"] == want[0]["lr"]


def test_best_checkpoint_follows_the_hook(tmp_path):
    model = nn.Linear(3, 1)
    scores = iter([0.1, 0.3, 0.2])

    def loss_fn(batch, step):
        loss = (model(batch["image"].mean(dim=(1, 2))) ** 2).sum()
        return loss, {}

    trainer = Trainer(loss_fn, model, make_optimizer(model.parameters(), 0.01),
                      _Batches(_toy_batches(2)), work_dir=str(tmp_path), log_interval=1,
                      max_keep_checkpoints=5, val_hook=lambda: {"mAP": next(scores)})
    trainer.run(3)
    best = checkpoint.load_checkpoint_file(str(tmp_path / "best"))
    assert best["meta"]["epoch"] == 2 and best["meta"]["mAP"] == 0.3 and best["meta"]["step"] == 4
    second = checkpoint.load_checkpoint_file(str(tmp_path / "epoch_2"))
    for k, v in best["model"].items():
        assert torch.equal(v, second["model"][k])
    assert trainer.best_score == 0.3 and trainer.history[-1] == {"epoch": 2, "val_mAP": 0.2}


def test_checkpoint_retention_keeps_the_newest(tmp_path):
    model = nn.Linear(3, 1)

    def loss_fn(batch, step):
        return (model(batch["image"].mean(dim=(1, 2))) ** 2).sum(), {}

    Trainer(loss_fn, model, make_optimizer(model.parameters(), 0.01), _Batches(_toy_batches(2)),
            work_dir=str(tmp_path), max_keep_checkpoints=2, checkpoint_interval_steps=3).run(3)
    assert sorted(os.listdir(tmp_path)) == ["epoch_3", "step_6"]  # saved last, in this order


@pytest.fixture(scope="module")
def straight(coco):
    """Two epochs of the tiny Faster R-CNN straight through, 2 steps an
    epoch."""
    model, loss_fn, loader, optimizer = _train_objects(coco)
    assert len(loader) == 2
    history = Trainer(loss_fn, model, optimizer, loader, log_interval=1).run(2)
    return model, optimizer, history


@pytest.fixture(scope="module")
def interrupted(coco, tmp_path_factory):
    """The same run with a SIGTERM inside epoch 1's first step: it saves
    ``epoch_1`` at the end of epoch 0, then ``step_3`` with its batch
    position, and returns."""
    work = tmp_path_factory.mktemp("interrupted")
    model, loss_fn, loader, optimizer = _train_objects(coco)

    def preempted_loss(batch, step):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return loss_fn(batch, step)

    handler = signal.getsignal(signal.SIGTERM)
    trainer = Trainer(preempted_loss, model, optimizer, loader, work_dir=str(work),
                      log_interval=1, handle_preemption=True)
    trainer.run(2)
    assert signal.getsignal(signal.SIGTERM) is handler  # the handler is restored
    return trainer, work


def _untimed(history):
    return [{k: v for k, v in h.items() if k != "images_per_sec"} for h in history]


def _resume(coco, path, straight):
    """A model and optimizer built from another seed, resumed from
    ``path`` to the end of epoch 1; the run's history."""
    model, loss_fn, loader, optimizer = _train_objects(coco, seed=5)
    meta = checkpoint.load_checkpoint(model, str(path), strict=True, optimizer=optimizer)
    history = Trainer(loss_fn, model, optimizer, loader, log_interval=1).run(
        2, start_epoch=meta["epoch"], skip_batches=meta.get("batches_done", 0))
    _equal_states(straight[0], straight[1], model, optimizer)
    return meta, history


def test_two_epochs_equal_one_epoch_and_a_resume(coco, straight, interrupted):
    meta, history = _resume(coco, interrupted[1] / "epoch_1", straight)
    assert (meta["epoch"], meta["step"]) == (1, 2) and "batches_done" not in meta
    assert _untimed(history) == _untimed(straight[2][2:])  # epoch 1's losses, steps, rates


def test_a_sigterm_saves_the_batch_and_a_resume_equals_the_straight_run(coco, straight,
                                                                          interrupted):
    trainer, work = interrupted
    assert trainer.preempted and len(trainer.history) == 2
    assert checkpoint.latest_checkpoint(str(work)) == str(work / "step_3")
    meta, history = _resume(coco, work / "step_3", straight)
    assert (meta["epoch"], meta["batches_done"], meta["step"]) == (1, 1, 3)
    assert [h["loss"] for h in history] == [straight[2][3]["loss"]]


# ---------------------------------------------------------------- evaluate_detector
def test_evaluate_detector_equals_the_reference(coco):
    """The port's and the reference's ``evaluate_detector`` on the same
    test-mode dataset (the port's), the same weights and detection config
    (``test_torch_model.py``'s, two detections an image, so that the
    reference's eager fusion compiles for one shape), b2 on a 64 x 64
    canvas: three images in two batches, the second padded."""
    rng = np.random.default_rng(0)
    jax_model = JaxTwoStageDetector(**MODEL)
    jax_cfg = JaxFasterRCNNConfig(num_classes=3, anchor_generator=JaxAnchorGenerator(**ANCHORS),
                                  proposal_test=JaxProposalConfig(**PROPOSALS), max_detections=2)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    roi_vars = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 7, 7, 16)),
                              method=JaxTwoStageDetector.roi_forward)
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **roi_vars["params"]},
         "batch_stats": variables["batch_stats"]}, rng)
    model = TwoStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    cfg = FasterRCNNConfig(num_classes=3, anchor_generator=AnchorGenerator(**ANCHORS),
                           proposal_test=ProposalConfig(**PROPOSALS), max_detections=2)
    dataset = get_datasets(dict(type="CocoDataset", ann_file=coco["ann_file"],
                                img_prefix=coco["img_prefix"], img_means=MEANS, img_stds=STDS,
                                img_expected_sizes=(64, 48), size_divisor=32, test_mode=True))
    got, got_dets = validate.evaluate_detector(model, cfg, dataset, batch=2, canvas=(64, 64),
                                               return_detections=True)
    want, want_dets = jax_validate.evaluate_detector(
        jax_model, jax_cfg, variables, dataset, batch=2, canvas=(64, 64), return_detections=True)
    assert set(got) == set(want) == set(METRICS)
    for key in METRICS:
        assert abs(got[key] - want[key]) <= 1e-6, key
    assert [len(d["boxes"]) for d in got_dets] == [2, 2, 2]
    for g, w in zip(got_dets, want_dets, strict=True):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=1e-4)
