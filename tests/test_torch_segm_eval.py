"""The port's segmentation evaluation against the JAX package's, on the CPU.

``eval_coco_segm_map`` on seeded detections (dense and RLE, with crowds and
empty images) to 1e-12, the RLE results dump record for record,
``masks_to_original`` with and without flips, ``evaluate_detector(segm=True)``
on a narrow Mask R-CNN with converted weights, and the CLIs: ``tools.train``
with ``runtime.val_segm`` from a torchvision-named ``.pth`` given as
``--pretrained torch://``, then ``tools.test --segm``.
"""

import json
import logging
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_refs
from data_fixtures import make_coco
from test_torch_engine import METRICS
from test_torch_mask_rcnn import DET, MASK_MODEL, PROPOSALS
from test_torch_model import ANCHORS, _randomise_frozen_bn
from torch_detection_tpu.data.ops import mask as jax_mask
from torch_detection_tpu.engine import eval as jax_eval
from torch_detection_tpu.engine import tta as jax_tta
from torch_detection_tpu.engine import validate as jax_validate
from torch_detection_tpu.models.detectors import MaskRCNN as JaxMaskRCNN
from torch_detection_tpu.models.detectors import MaskRCNNConfig as JaxMaskRCNNConfig
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu_torch.data import get_datasets
from torch_detection_tpu_torch.data.ops import mask
from torch_detection_tpu_torch.engine import eval as port_eval
from torch_detection_tpu_torch.engine import tta, validate
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import MaskRCNN, MaskRCNNConfig
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli

MEANS, STDS = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
SEGM_METRICS = tuple(f"segm_{k}" for k in METRICS)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------- eval_coco_segm_map
def _blob(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
    m[y0: y0 + rng.integers(3, h - y0 + 1), x0: x0 + rng.integers(3, w - x0 + 1)] = 1
    m &= (rng.random((h, w)) < 0.9).astype(np.uint8)
    return m


def _segm_case(seed, num_classes=3):
    """Seeded images: gts with masks, crowds, detections that are noisy gt
    copies or random blobs, an image with no detection and one with no gt."""
    rng = np.random.default_rng(seed)
    dets, anns = [], []
    for i in range(6):
        h, w = (int(v) for v in rng.integers(12, 160, 2))
        g = 0 if i == 4 else int(rng.integers(1, 6))
        gt_masks = [_blob(rng, h, w) for _ in range(g)]
        gt_labels = rng.integers(1, num_classes + 1, g)
        c = int(rng.integers(0, 3))
        crowd = [_blob(rng, h, w) for _ in range(c)]
        d = 0 if i == 3 else int(rng.integers(1, 12))
        masks, labels = [], []
        for _ in range(d):
            if g and rng.random() < 0.6:
                j = int(rng.integers(g))
                m = gt_masks[j] ^ (rng.random((h, w)) < rng.uniform(0, 0.3)).astype(np.uint8)
                labels.append(gt_labels[j] if rng.random() < 0.8 else rng.integers(1, num_classes + 1))
            else:
                m = _blob(rng, h, w)
                labels.append(rng.integers(1, num_classes + 1))
            masks.append(m)
        dets.append(dict(masks=np.asarray(masks, np.uint8).reshape(d, h, w),
                         scores=rng.random(d).astype(np.float32),
                         labels=np.asarray(labels, np.int64).reshape(d)))
        anns.append(dict(masks=gt_masks, labels=gt_labels, masks_ignore=crowd,
                         labels_ignore=rng.integers(1, num_classes + 1, c)))
    return dets, anns


@pytest.mark.parametrize("form", ["dense", "rle", "compressed_rle"])
@pytest.mark.parametrize("seed", (0, 1))
def test_eval_coco_segm_map_equals_the_reference(form, seed):
    dets, anns = _segm_case(seed)
    if form != "dense":
        compress = form == "compressed_rle"
        for d in dets:
            d["masks"] = [mask.rle_encode(m, compress=compress) for m in d["masks"]]
        for a in anns:
            a["masks"] = [mask.rle_encode(m, compress=compress) for m in a["masks"]]
            a["masks_ignore"] = [mask.rle_encode(m, compress=compress) for m in a["masks_ignore"]]
    got = port_eval.eval_coco_segm_map(dets, anns, 3)
    want = jax_eval.eval_coco_segm_map(dets, anns, 3)
    assert set(got) == set(want) == set(METRICS)
    assert 0 < got["mAP_50"] < 1
    for k in METRICS:
        assert abs(got[k] - want[k]) <= 1e-12, k


def test_mask_iou_matrix_equals_the_reference_and_the_runs():
    dets, anns = _segm_case(2)
    d, g = dets[0]["masks"], np.asarray(anns[0]["masks"])
    got = port_eval.mask_iou_matrix(d, g)
    assert np.array_equal(got, jax_eval.mask_iou_matrix(d, g))
    rles = port_eval._as_rles(d), port_eval._as_rles(g)
    np.testing.assert_allclose(mask.rle_iou_matrix(*rles), got, atol=1e-12, rtol=0)
    assert port_eval.mask_iou_matrix(d[:0], g).shape == (0, len(g))


class _Dataset:
    img_infos = [{"id": 7}, {"id": 3}, {"id": 12}]
    cat2label = {11: 1, 13: 2, 20: 3}


def test_coco_segm_dump_equals_the_reference():
    dets, _ = _segm_case(3)
    dets = dets[:3]
    dets[1]["masks"] = [mask.rle_encode(m) for m in dets[1]["masks"]]  # RLE as evaluate streams it
    dets[2]["masks"] = [mask.rle_encode(m, compress=False) for m in dets[2]["masks"]]
    got = validate.coco_segm_dump(_Dataset(), dets)
    want = jax_validate.coco_segm_dump(_Dataset(), dets)
    assert got == want and len(got) == sum(len(d["scores"]) for d in dets)
    assert all(isinstance(r["segmentation"]["counts"], str) for r in got)
    json.dumps(got)


@pytest.mark.parametrize("flip", [(False, "horizontal"), (True, "horizontal"), (True, "vertical")])
def test_masks_to_original_equals_the_reference(flip):
    rng = np.random.default_rng(4)
    probs = rng.random((6, 14, 14)).astype(np.float32)
    xy = rng.uniform(-10, 90, (6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(0.5, 60, (6, 2))], 1).astype(np.float32)
    meta = dict(ori_shape=(57, 83, 3), img_shape=(91, 133, 3), scale_factor=1.6,
                flipped_flag=flip[0], flipped_direction=flip[1])
    got_masks, got_boxes = tta.masks_to_original(probs, boxes, meta)
    want_masks, want_boxes = jax_tta.masks_to_original(probs, boxes, meta)
    assert got_masks.shape == (6, 57, 83) and got_masks.any()
    assert np.array_equal(got_masks, want_masks) and np.array_equal(got_boxes, want_boxes)


# ---------------------------------------------------------------- COCO folder with masks
def write_png_coco_masks(root):
    """``make_coco(with_mask=True)`` as PNG, plus a compressed-RLE object on
    the portrait image: its paths as dataset config keys."""
    ann_file, img_dir = make_coco(str(root), with_mask=True)
    with open(ann_file) as f:
        ann = json.load(f)
    for info in ann["images"]:
        jpg = os.path.join(img_dir, info["file_name"])
        info["file_name"] = info["file_name"].replace(".jpg", ".png")
        assert cv2.imwrite(os.path.join(img_dir, info["file_name"]), cv2.imread(jpg))
    blob = np.zeros((100, 60), np.uint8)
    blob[60:90, 20:50] = 1
    rle = jax_mask.rle_encode(blob)
    ann["annotations"].append({"id": 9, "image_id": 2, "category_id": 11, "iscrowd": 0,
                               "bbox": [20, 60, 30, 30], "area": 900,
                               "segmentation": dict(rle, counts=rle["counts"].decode("ascii"))})
    path = os.path.join(str(root), "ann_masks_png.json")
    with open(path, "w") as f:
        json.dump(ann, f)
    return dict(ann_file=path, img_prefix=img_dir)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return write_png_coco_masks(tmp_path_factory.mktemp("coco_segm"))


EVAL_MODEL = dict(MASK_MODEL, bbox_head=dict(MASK_MODEL["bbox_head"], num_classes=2),
                  mask_head=dict(MASK_MODEL["mask_head"], num_classes=2))
EVAL_DET = dict(DET, num_classes=2, max_detections=4)


def test_evaluate_detector_segm_equals_the_reference(coco):
    """Both ``evaluate_detector(segm=True)`` on the same weights and test
    set, b2 on a 64 x 64 canvas; the mask logits are scaled up so that few
    pasted pixels sit near the 0.5 threshold."""
    rng = np.random.default_rng(0)
    jax_model = JaxMaskRCNN(**EVAL_MODEL)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    extra = [jax_model.init(jax.random.PRNGKey(k), jnp.zeros((2, 8, 7, 7, 16)), method=m)["params"]
             for k, m in ((1, JaxMaskRCNN.roi_forward), (2, JaxMaskRCNN.mask_forward))]
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **extra[0], **extra[1]},
         "batch_stats": variables["batch_stats"]}, rng)
    logits = variables["params"]["mask_head"]["logits"]
    logits["kernel"] = np.asarray(logits["kernel"]) * 40.0
    proposals = JaxProposalConfig(**PROPOSALS)
    jax_cfg = JaxMaskRCNNConfig(anchor_generator=JaxAnchorGenerator(**ANCHORS),
                                proposal_train=proposals, proposal_test=proposals, **EVAL_DET)
    cfg = MaskRCNNConfig(anchor_generator=AnchorGenerator(**ANCHORS),
                         proposal_train=ProposalConfig(**PROPOSALS),
                         proposal_test=ProposalConfig(**PROPOSALS), **EVAL_DET)
    model = MaskRCNN(**EVAL_MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    dataset = get_datasets(dict(type="CocoDataset", ann_file=coco["ann_file"],
                                img_prefix=coco["img_prefix"], img_means=MEANS, img_stds=STDS,
                                img_expected_sizes=(64, 48), size_divisor=32, test_mode=True,
                                with_mask=True))
    got, got_dets = validate.evaluate_detector(model, cfg, dataset, batch=2, canvas=(64, 64),
                                               return_detections=True, segm=True)
    want, want_dets = jax_validate.evaluate_detector(
        jax_model, jax_cfg, variables, dataset, batch=2, canvas=(64, 64), return_detections=True,
        segm=True)
    assert set(got) == set(want) == set(METRICS) | set(SEGM_METRICS)
    for key in sorted(got):
        assert abs(got[key] - want[key]) <= 1e-6, key
    same = total = 0
    for i, (g, w) in enumerate(zip(got_dets, want_dets, strict=True)):
        assert len(g["masks"]) == len(w["masks"]) == len(g["scores"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=1e-4)
        oh, ow = dataset.img_infos[i]["height"], dataset.img_infos[i]["width"]
        for gm, wm in zip(g["masks"], w["masks"]):
            assert gm["size"] == [oh, ow] and isinstance(gm["counts"], bytes)
            a, b = mask.rle_decode(gm), jax_mask.rle_decode(wm)
            same, total = same + int((a == b).sum()), total + a.size
    assert same >= 0.999 * total


# ---------------------------------------------------------------- the CLIs
def _write_mask_config(path, coco, **runtime):
    base = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                        "mask_rcnn_r50_fpn_coco.py")
    ann, prefix = coco["ann_file"], coco["img_prefix"]
    runtime = dict(compute_dtype="float32", log_interval=1, val_interval_epochs=1, val_batch=2,
                   **runtime)
    det = dict(num_classes=2, max_detections=8, mask_roi_size=7, mask_size=14)
    path.write_text(f"""_base_ = {os.path.abspath(base)!r}
model = dict(_delete_=True, **{dict(EVAL_MODEL, type="MaskRCNN")!r})
detection = dict(**{det!r})
data = dict(
    train=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    val=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    sample_per_replica=2, max_gts=8, canvas=(64, 64),
)
schedule = dict(warmup_steps=2)
runtime = dict(**{runtime!r})
""")
    return str(path)


def test_train_with_val_segm_from_a_torchvision_pth_then_test_segm(coco, tmp_path, caplog):
    """``tools.train`` (one epoch, validation with the mask metrics) from a
    seeded torchvision-named ResNet-18 ``.pth`` in its envelope, with
    ``fc.*`` and ``num_batches_tracked``: every backbone tensor loads, and
    the frozen stem and stage 1 keep the file's values; then ``tools.test
    --segm`` writes the segm results, each RLE at its image's size."""
    torch.manual_seed(0)
    resnet = torch_refs.randomize_bn_stats(torch_refs.torch_resnet18())
    state = dict(resnet.state_dict(), **{"fc.weight": torch.randn(10, 512), "fc.bias": torch.zeros(10)})
    pth = tmp_path / "resnet18.pth"
    torch.save({"state_dict": state}, str(pth))
    config = _write_mask_config(tmp_path / "mask.py", coco, val_segm=True)
    work = tmp_path / "work"
    with caplog.at_level(logging.INFO):
        trainer = train_cli.main([config, "--epochs", "1", "--work-dir", str(work),
                                  "--pretrained", f"torch://{pth}", "--device", "cpu"])
    n_backbone = sum(k.startswith("backbone.") for k in trainer.model.state_dict())
    assert f"of the backbone's {n_backbone}" in caplog.text
    assert f", {n_backbone} of the backbone's" in caplog.text
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_mAP" in r]
    assert steps and all(np.isfinite(r["loss_mask"]) for r in steps)
    assert set(vals[0]) == {"epoch"} | {f"val_{k}" for k in METRICS + SEGM_METRICS}
    saved = torch.load(str(work / "epoch_1" / "model.pt"), weights_only=True)
    for name in ("stem.conv.weight", "stem.norm.scale", "stem.norm.mean",
                 "layer1_0.block1.conv.weight", "layer1_1.block2.norm.var"):
        torch_name = {"stem.conv.weight": "conv1.weight", "stem.norm.scale": "bn1.weight",
                      "stem.norm.mean": "bn1.running_mean",
                      "layer1_0.block1.conv.weight": "layer1.0.conv1.weight",
                      "layer1_1.block2.norm.var": "layer1.1.bn2.running_var"}[name]
        assert torch.equal(saved["backbone." + name], state[torch_name]), name
    assert not torch.equal(saved["backbone.layer2_0.block1.conv.weight"],
                           state["layer2.0.conv1.weight"])  # trained

    out = tmp_path / "res.json"
    metrics = test_cli.main([config, str(work / "epoch_1"), "--segm", "--out", str(out),
                             "--device", "cpu"])
    assert set(metrics) == set(METRICS) | set(SEGM_METRICS)
    segm = json.loads((tmp_path / "res.segm.json").read_text())
    boxes = json.loads(out.read_text())
    assert len(segm) == len(boxes) > 0
    sizes = {1: [60, 100], 2: [100, 60], 3: [80, 80]}
    for r in segm:
        assert r["segmentation"]["size"] == sizes[r["image_id"]]
        assert mask.rle_decode(r["segmentation"]).shape == tuple(sizes[r["image_id"]])
        assert r["category_id"] in (11, 13)
