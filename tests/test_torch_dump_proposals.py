"""``tools.dump_proposals`` against the reference's pipeline, the Fast R-CNN
workflow on its pkl, and ``COCO.ann_to_mask``.

A narrow Faster R-CNN (``test_torch_train.py``'s, two classes) initialised
by flax and converted with ``from_jax_variables`` is saved as a checkpoint
of the port; the port's tool dumps its RPN proposals over the PNG COCO
fixture's val split (b2 on a 64 x 64 canvas, 20 an image). The reference's
pipeline runs in-process on the same padded batches: ``model.apply`` ->
``generate_proposals`` -> ``/ scale_factor``. The counts must be equal, and
boxes and scores within 1e-4 relative (1e-4 absolute near 0). The pkl is
read back by ``CocoDataset(proposal_file=...)``, a Fast R-CNN trains one
step on it through ``tools.train`` and ``tools.test`` scores it, on the CPU.
"""

import dataclasses
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_fixtures import make_coco
from test_torch_data import write_png_coco
from test_torch_model import _randomise_frozen_bn
from test_torch_train import TRAIN_MODEL
from torch_detection_tpu.builder import build_detection_cfg as jax_build_detection_cfg
from torch_detection_tpu.data.coco_api import COCO as JaxCOCO
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.heads.rpn_head import generate_proposals as jax_generate_proposals
from torch_detection_tpu.utils import Config as JaxConfig
from torch_detection_tpu_torch.data import COCO, get_datasets, pick_canvas
from torch_detection_tpu_torch.engine.checkpoint import save_checkpoint
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import TwoStageDetector
from torch_detection_tpu_torch.tools import dump_proposals as dump_cli
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli
from torch_detection_tpu_torch.utils.config import Config
from torch_detection_tpu_torch.utils.file_handler import load

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
MODEL = dict(TRAIN_MODEL, bbox_head=dict(TRAIN_MODEL["bbox_head"], num_classes=2))
TOP_K, BATCH = 20, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(coco, **split):
    both = dict(ann_file=coco["ann_file"], img_prefix=coco["img_prefix"],
                img_expected_sizes=(64, 48))
    return dict(train=dict(both, **split.get("train", {})), val=dict(both, **split.get("val", {})),
                sample_per_replica=2, max_gts=8, canvas=(64, 64))


def _write(path, base, model, data, **extra):
    text = f"_base_ = {os.path.abspath(os.path.join(CONFIGS, base))!r}\n"
    text += f"model = dict(_delete_=True, **{model!r})\n"
    text += "detection = dict(num_classes=2, max_detections=8)\n"
    text += f"data = dict(**{data!r})\n"
    text += "schedule = dict(warmup_steps=1)\n"
    text += f"runtime = dict(compute_dtype='float32', log_interval=1, **{extra!r})\n"
    path.write_text(text)
    return str(path)


@pytest.fixture(scope="module")
def dumped(tmp_path_factory):
    """The narrow Faster R-CNN in flax and in the port, its checkpoint, and
    the tool's pkl of each split."""
    root = tmp_path_factory.mktemp("dump")
    coco = write_png_coco(root / "coco")
    config = _write(root / "faster.py", "faster_rcnn_r50_fpn_coco.py",
                    dict(MODEL, type="TwoStageDetector"), _data(coco))
    rng = np.random.default_rng(0)
    jax_model = JaxTwoStageDetector(**MODEL)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    roi_vars = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 7, 7, 16)),
                              method=JaxTwoStageDetector.roi_forward)
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **roi_vars["params"]},
         "batch_stats": variables["batch_stats"]}, rng)
    model = TwoStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    ckpt = str(root / "ckpt")
    save_checkpoint(ckpt, model, meta=dict(epoch=1))
    pkls = {}
    for split in ("train", "val"):
        pkls[split] = str(root / f"proposals_{split}.pkl")
        out = dump_cli.main([config, ckpt, "--split", split, "--out", pkls[split], "--batch",
                             str(BATCH), "--top-k", str(TOP_K), "--device", "cpu"])
        assert len(out) == 3  # the unfiltered view: the image without annotations too
    return dict(root=root, coco=coco, config=config, jax_model=jax_model, variables=variables,
                pkls=pkls)


def test_dump_equals_the_reference_pipeline(dumped):
    cfg = Config.fromfile(dumped["config"])
    det_cfg = jax_build_detection_cfg(JaxConfig.fromfile(dumped["config"])["detection"])
    prop_cfg = dataclasses.replace(det_cfg.proposal_test, post_nms_top_k=TOP_K)
    jax_model, variables = dumped["jax_model"], dumped["variables"]

    @jax.jit
    def rpn_proposals(image, img_shape):
        _, rpn_scores, rpn_deltas = jax_model.apply(variables, image)
        return jax_generate_proposals(prop_cfg, det_cfg.anchor_generator, rpn_scores, rpn_deltas,
                                      img_shapes=img_shape)

    dataset = get_datasets(dict(cfg["data"]["val"], flip_ratio=0, test_mode=True))
    want = [None] * len(dataset)
    pending = {}
    items_all = []
    for i in range(len(dataset)):
        sample = dataset[i]
        img, meta = sample["img"][0], sample["img_meta"][0].data
        bucket = pick_canvas([img.shape[:2]], canvas=(64, 64))
        pending.setdefault(bucket, []).append((i, img, meta["img_shape"][:2], meta["scale_factor"]))
        if len(pending[bucket]) == BATCH:
            items_all.append((bucket, pending.pop(bucket)))
    items_all += [(b, items) for b, items in pending.items() if items]
    for bucket, items in items_all:
        padded = np.zeros((BATCH, *bucket, 3), np.float32)
        shapes = np.ones((BATCH, 2), np.float32)
        for j, (_, img, img_shape, _) in enumerate(items):
            padded[j, : img.shape[0], : img.shape[1]] = img
            shapes[j] = img_shape
        props = rpn_proposals(jnp.asarray(padded), jnp.asarray(shapes))
        boxes, scores, valid = (np.asarray(a) for a in (props.boxes, props.scores, props.valid))
        for j, (idx, _, _, sf) in enumerate(items):
            v = valid[j]
            want[idx] = np.hstack([boxes[j][v] / float(sf), scores[j][v, None]]).astype(np.float32)
    got = load(dumped["pkls"]["val"])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want, strict=True):
        assert g.dtype == np.float32 and g.shape == w.shape and g.shape[1] == 5 and 0 < len(g) <= TOP_K
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        assert np.all(np.diff(g[:, 4]) <= 0)  # scores in non-increasing order


def test_pkl_reads_back_through_coco_dataset(dumped):
    cfg = Config.fromfile(dumped["config"])
    props = load(dumped["pkls"]["val"])
    dataset = get_datasets(dict(cfg["data"]["val"], proposal_file=dumped["pkls"]["val"],
                                test_mode=True))
    for i in range(len(dataset)):
        assert np.array_equal(dataset.proposals[i], props[i])
        sample, info = dataset[i], dataset.img_infos[i]
        (prop,), meta = sample["proposals"], sample["img_meta"][0].data
        assert prop.shape == props[i].shape and np.array_equal(prop[:, 4], props[i][:, 4])
        assert (props[i][:, :4] >= 0).all() and (props[i][:, [0, 2]] <= info["width"]).all()
        assert (props[i][:, [1, 3]] <= info["height"]).all()
        np.testing.assert_allclose(prop[:, :4], props[i][:, :4] * meta["scale_factor"], atol=1e-3)
    train = get_datasets(dict(cfg["data"]["train"], proposal_file=dumped["pkls"]["train"]))
    assert len(train) == 2 and len(train.proposals) == 2  # filtered with its images


def test_fast_rcnn_trains_and_tests_on_the_dump(dumped):
    fast_model = dict(type="FastRCNN", backbone=MODEL["backbone"], neck=MODEL["neck"],
                      bbox_head=MODEL["bbox_head"])
    data = _data(dumped["coco"], train=dict(proposal_file=dumped["pkls"]["train"]),
                 val=dict(proposal_file=dumped["pkls"]["val"]))
    config = _write(dumped["root"] / "fast.py", "fast_rcnn_r50_fpn_coco.py", fast_model,
                    dict(data, max_proposals=TOP_K))
    work = dumped["root"] / "fast_work"
    trainer = train_cli.main([config, "--epochs", "1", "--work-dir", str(work), "--device", "cpu"])
    assert trainer.optimizer.steps == 2  # a landscape and a portrait image: a batch each
    metrics = test_cli.main([config, str(work / "epoch_1"), "--batch", "2", "--device", "cpu"])
    assert len(metrics) == 12 and all(math.isfinite(v) for v in metrics.values())


def test_dump_needs_an_rpn(dumped, tmp_path):
    config = _write(tmp_path / "fast.py", "fast_rcnn_r50_fpn_coco.py",
                    dict(type="FastRCNN", backbone=MODEL["backbone"], neck=MODEL["neck"],
                         bbox_head=MODEL["bbox_head"]), _data(dumped["coco"]))
    with pytest.raises(SystemExit, match="RPN"):
        dump_cli.main([config, "ckpt", "--out", str(tmp_path / "x.pkl"), "--device", "cpu"])


@pytest.mark.parametrize("ann_id", (1, 2, 3))
def test_ann_to_mask_equals_the_reference(tmp_path, ann_id):
    """A polygon, an uncompressed RLE crowd and a portrait image's polygon."""
    ann_file, _ = make_coco(str(tmp_path))
    got, want = COCO(ann_file), JaxCOCO(ann_file)
    ann = got.load_anns([ann_id])[0]
    mask = got.ann_to_mask(ann)
    assert mask.dtype == np.uint8 and np.array_equal(mask, want.ann_to_mask(ann))
    assert np.array_equal(got.annToMask(ann), mask)
    if ann_id == 1:
        assert mask.shape == (60, 100) and mask[20, 20] == 1 and mask[50, 80] == 0
