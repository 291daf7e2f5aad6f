"""The port's Pascal VOC tier against the JAX package's.

``VOCDataset`` on ``data_fixtures.make_voc`` and on larger seeded folders
(voc07, voc12 and voc07+12, both splits): the infos, the cache pkl and the
difficult objects as ignores; train and test samples bit for bit at scale 1
(both sides decode the same JPEGs; a resize is within one grey level, the
PNG path's rule) and at the VOC config's sizes within one grey level;
``eval_voc_map`` to 1e-12 under both metrics on seeded detections with
ties, ignores and empty classes; ``evaluate_detector(voc_metric=True)`` of
a narrow RetinaNet converted from flax against the reference's;
``tools.train`` with ``runtime.val_voc_metric`` and ``tools.test
--voc-metric`` on the CPU; and R10: the VOC config's canvas holds no
portrait VOC image.
"""

import json
import math
import os
import os.path as osp

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from data_fixtures import VOC_OBJ, VOC_XML, make_voc
from test_torch_model import _randomise_frozen_bn
from torch_detection_tpu.data import VOCDataset as JaxVOCDataset
from torch_detection_tpu.data import collate as jax_collate
from torch_detection_tpu.data.container import DataContainer as JaxDataContainer
from torch_detection_tpu.engine import eval as jax_eval
from torch_detection_tpu.engine import validate as jax_validate
from torch_detection_tpu.models.detectors import RetinaNetConfig as JaxRetinaNetConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu_torch.data import VOC_CLASSES, VOCDataset, collate, get_datasets
from torch_detection_tpu_torch.data.container import DataContainer
from torch_detection_tpu_torch.data.ops.image import rescale_size
from torch_detection_tpu_torch.engine import validate
from torch_detection_tpu_torch.engine.eval import eval_voc_map
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import RetinaNetConfig, SingleStageDetector
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli
from torch_detection_tpu_torch.utils.config import Config
from torch_detection_tpu_torch.utils.file_handler import load

VOC_CONFIG = osp.join(osp.dirname(osp.abspath(__file__)), "..", "configs",
                      "retinanet_r101_fpn_voc.py")
MEANS, STDS = (123.675, 116.28, 103.53), (58.395, 57.12, 57.375)
# (w, h) of the seeded folders' images, landscape, square and portrait
SIZES = ((64, 48), (56, 40), (48, 48), (40, 56))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def write_voc(base, n_train, n_test, seed, sizes=SIZES):
    """A VOC year folder: JPEGImages by cv2 (gradients, rectangles, noise),
    Annotations with 1-6 objects over the 20 classes (every fifth difficult,
    every seventh without a difficult tag), ImageSets/Main lists."""
    rng = np.random.default_rng(seed)
    for sub in ("JPEGImages", "Annotations", "ImageSets/Main"):
        os.makedirs(osp.join(base, sub), exist_ok=True)
    names = [f"{seed:02d}{i:04d}" for i in range(n_train + n_test)]
    k = 0
    for i, name in enumerate(names):
        w, h = sizes[i % len(sizes)]
        img = np.clip(rng.normal(128, 40, (h, w, 3)), 0, 255).astype(np.uint8)
        assert cv2.imwrite(osp.join(base, "JPEGImages", name + ".jpg"), img)
        objects = []
        for _ in range(int(rng.integers(1, 7))):
            x1, y1 = int(rng.integers(1, w - 8)), int(rng.integers(1, h - 8))
            x2, y2 = int(rng.integers(x1 + 4, w + 1)), int(rng.integers(y1 + 4, h + 1))
            cls = VOC_CLASSES[int(rng.integers(0, 20))]
            obj = VOC_OBJ.format(cls=cls.upper() if k % 3 == 0 else cls, difficult=int(k % 5 == 4),
                                 x1=x1, y1=y1, x2=x2, y2=y2)
            if k % 7 == 6:
                obj = obj.replace("<difficult>0</difficult>", "")
            objects.append(obj)
            k += 1
        with open(osp.join(base, "Annotations", name + ".xml"), "w") as f:
            f.write(VOC_XML.format(name=name, w=w, h=h, objects="".join(objects)))
    with open(osp.join(base, "ImageSets/Main/trainval.txt"), "w") as f:
        f.write("\n".join(names[:n_train]) + "\n")
    with open(osp.join(base, "ImageSets/Main/test.txt"), "w") as f:
        f.write("\n".join(names[n_train:]) + "\n\n")
    return base


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """{scope: dataset_root}: make_voc's folder, a seeded VOC2007 and
    VOC2012, and their 07+12 parent."""
    root = str(tmp_path_factory.mktemp("voc"))
    return {"fixture": make_voc(root),
            "voc07": write_voc(osp.join(root, "both", "VOC2007"), 10, 6, seed=7),
            "voc12": write_voc(osp.join(root, "both", "VOC2012"), 8, 3, seed=12),
            "voc07+12": osp.join(root, "both")}


def _pair(voc, tmp_path, folder, test_mode, **kw):
    """The port's and the reference's datasets of ``voc[folder]``, each with a
    cache directory of its own; ``make_voc``'s folder is a voc07 scope."""
    cfg = dict(dataset_scope="voc07" if folder == "fixture" else folder,
               dataset_root=voc[folder], test_mode=test_mode, img_means=MEANS, img_stds=STDS, **kw)
    return (VOCDataset(cache_dir=str(tmp_path / "port"), **cfg),
            JaxVOCDataset(cache_dir=str(tmp_path / "ref"), **cfg), cfg)


@pytest.mark.parametrize("test_mode", (False, True), ids=("train", "test"))
@pytest.mark.parametrize("folder", ("fixture", "voc07", "voc12", "voc07+12"))
def test_voc_dataset_equals_the_reference(voc, tmp_path, folder, test_mode):
    got, want, cfg = _pair(voc, tmp_path, folder, test_mode)
    assert len(got) == len(want) > 0 and got.classes == want.classes == VOC_CLASSES
    assert got.img_prefix == want.img_prefix
    cache = f"{cfg['dataset_scope']}_{'test' if test_mode else 'train'}.pkl"
    got_cache, want_cache = load(str(tmp_path / "port" / cache)), load(str(tmp_path / "ref" / cache))
    assert len(got_cache) == len(got)  # no image of these folders is under 32 pixels
    for g, w in zip(got_cache, want_cache, strict=True):
        assert {k: g[k] for k in ("filename", "width", "height")} == \
            {k: w[k] for k in ("filename", "width", "height")}
        for key in ("bboxes", "labels", "bboxes_ignore"):
            assert g["ann"][key].dtype == w["ann"][key].dtype
            assert np.array_equal(g["ann"][key], w["ann"][key]), key
    for i in range(len(got)):
        g, w = got.get_ann_info(i), want.get_ann_info(i)
        assert got.img_infos[i]["filename"] == want.img_infos[i]["filename"]
        assert all(np.array_equal(g[k], w[k]) for k in ("bboxes", "labels", "bboxes_ignore"))
    if not test_mode:
        assert np.array_equal(got.flag, want.flag)
    # a second build reads the cache, not the folder
    os.rename(osp.join(voc[folder], "ImageSets") if folder != "voc07+12" else voc[folder],
              str(tmp_path / "moved"))
    try:
        again = VOCDataset(cache_dir=str(tmp_path / "port"), **cfg)
    finally:
        os.rename(str(tmp_path / "moved"),
                  osp.join(voc[folder], "ImageSets") if folder != "voc07+12" else voc[folder])
    assert [i["filename"] for i in again.img_infos] == [i["filename"] for i in got.img_infos]


def test_difficult_objects_are_the_ignores(voc, tmp_path):
    got, _, _ = _pair(voc, tmp_path, "voc07", False)
    ignores = [got.get_ann_info(i)["bboxes_ignore"] for i in range(len(got))]
    labels = [got.get_ann_info(i)["labels"] for i in range(len(got))]
    assert sum(map(len, ignores)) > 0 and all(((lb >= 1) & (lb <= 20)).all() for lb in labels)
    fixture, _, _ = _pair(voc, tmp_path / "f", "fixture", False)
    ann = fixture.get_ann_info(0)  # make_voc's t0: a dog, and a difficult cat at 5, 5, 20, 20
    assert ann["labels"].tolist() == [VOC_CLASSES.index("dog") + 1]
    assert ann["bboxes"].tolist() == [[9, 9, 39, 34]] and ann["bboxes_ignore"].tolist() == [[4, 4, 19, 19]]


def test_voc_scope_is_checked(tmp_path):
    with pytest.raises(ValueError, match="dataset_scope"):
        VOCDataset(cache_dir=str(tmp_path), dataset_scope="voc2007")


def _equal_samples(got, want, exact):
    assert sorted(got) == sorted(want)
    gm = got["img_meta"] if isinstance(got["img_meta"], list) else [got["img_meta"]]
    wm = want["img_meta"] if isinstance(want["img_meta"], list) else [want["img_meta"]]
    assert [m.data for m in gm] == [m.data for m in wm]
    gi = got["img"] if isinstance(got["img"], list) else [got["img"].data]
    wi = want["img"] if isinstance(want["img"], list) else [want["img"].data]
    for g, w in zip(gi, wi, strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype
        if exact:
            assert np.array_equal(g, w)
        else:  # one grey level before the normalisation
            assert np.abs((g - w) * np.asarray(STDS, np.float32)).max() <= 1.0
    for key in sorted(set(got) - {"img", "img_meta"}):
        assert np.array_equal(got[key].data, want[key].data), key


@pytest.mark.parametrize("sizes, exact", [((64, 48), True), ((1000, 600), False)],
                         ids=("scale_1_bit_for_bit", "voc_config_sizes"))
@pytest.mark.parametrize("test_mode", (False, True), ids=("train", "test"))
def test_voc_samples_equal_the_reference(voc, tmp_path, sizes, exact, test_mode):
    """At (64, 48) no image of the folder is resized, so the samples are
    the decoded JPEGs, normalised, flipped and padded, and equal bit for
    bit."""
    got_ds, want_ds, _ = _pair(voc, tmp_path, "voc07", test_mode, img_expected_sizes=sizes,
                               size_divisor=32, seed=3, flip_ratio=0.5)
    compared = 0
    for epoch in (0, 1):
        got_ds.set_epoch(epoch)
        want_ds.set_epoch(epoch)
        for idx in range(len(got_ds)):
            hw = (got_ds.img_infos[idx]["height"], got_ds.img_infos[idx]["width"])
            if exact and rescale_size(hw, sizes)[0] != hw:
                continue
            _equal_samples(got_ds[idx], want_ds[idx], exact)
            compared += 1
    assert compared >= len(got_ds)  # two epochs, half of the folder at scale 1


# ---------------------------------------------------------------- VOC AP
def _seeded_voc_inputs(seed, num_classes=6):
    """Per image 0-8 gts over the first classes (the last two classes have
    none), 0-3 difficult regions, detections jittering gts or anywhere with
    scores on a grid of ten values (many ties); an image without gts, one
    without detections."""
    rng = np.random.default_rng(seed)
    detections, annotations = [], []
    for i in range(8):
        g = 0 if i == 2 else int(rng.integers(1, 9))
        xy = rng.uniform(0, 200, (g, 2))
        gts = np.concatenate([xy, xy + rng.uniform(8, 120, (g, 2))], 1)
        labels = rng.integers(1, num_classes - 1, g)
        r = int(rng.integers(0, 4))
        rxy = rng.uniform(0, 200, (r, 2))
        ignores = np.concatenate([rxy, rxy + rng.uniform(8, 80, (r, 2))], 1)
        annotations.append(dict(bboxes=gts.astype(np.float32), labels=labels,
                                bboxes_ignore=ignores.astype(np.float32)))
        d = 0 if i == 5 else int(rng.integers(1, 30))
        pick = rng.integers(0, max(g, 1), d)
        axy = rng.uniform(0, 200, (d, 2))
        anywhere = np.concatenate([axy, axy + rng.uniform(8, 100, (d, 2))], 1)
        near_ignore = ignores[rng.integers(0, r, d)] + rng.normal(0, 2, (d, 4)) if r else anywhere
        boxes = gts[pick] + rng.normal(0, 5, (d, 4)) if g else anywhere
        u = rng.uniform(size=d)
        boxes = np.where((u < 0.25)[:, None], anywhere, np.where((u > 0.85)[:, None],
                                                                 near_ignore, boxes))
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 1)
        det_labels = np.where(rng.uniform(size=d) < 0.8, labels[pick] if g else 1,
                              rng.integers(1, num_classes + 1, d))
        detections.append(dict(boxes=boxes.astype(np.float32),
                               scores=(rng.integers(1, 11, d) / 10).astype(np.float32),
                               labels=det_labels))
    return detections, annotations


@pytest.mark.parametrize("use_07_metric", (True, False), ids=("11_point", "all_point"))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_eval_voc_map_equals_the_reference(seed, use_07_metric):
    detections, annotations = _seeded_voc_inputs(seed)
    got = eval_voc_map(detections, annotations, 6, use_07_metric=use_07_metric)
    want = jax_eval.eval_voc_map(detections, annotations, 6, use_07_metric=use_07_metric)
    assert set(got) == set(want) == {"mAP", "per_class"}
    assert got["per_class"].keys() == want["per_class"].keys() == {1, 2, 3, 4}
    for c, ap in got["per_class"].items():
        assert abs(ap - want["per_class"][c]) <= 1e-12
    assert abs(got["mAP"] - want["mAP"]) <= 1e-12 and 0 < got["mAP"] < 1


def test_gts_as_detections_score_one_and_no_gts_score_zero():
    _, annotations = _seeded_voc_inputs(4)
    oracle = [dict(boxes=a["bboxes"], scores=np.ones(len(a["labels"]), np.float32),
                   labels=a["labels"]) for a in annotations]
    for use_07 in (True, False):
        assert abs(eval_voc_map(oracle, annotations, 6, use_07_metric=use_07)["mAP"] - 1) <= 1e-12
    empty = [dict(bboxes=np.zeros((0, 4), np.float32), labels=np.zeros(0, np.int64))] * 2
    none = [dict(boxes=np.zeros((0, 4)), scores=np.zeros(0), labels=np.zeros(0, int))] * 2
    assert eval_voc_map(none, empty, 3) == {"mAP": 0.0, "per_class": {}}


# ---------------------------------------------------------------- evaluate_detector
NARROW = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3)),
    neck=dict(type="FPN", in_channels=(128, 256, 512), out_channels=16, num_outs=5,
              add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True),
    head=dict(type="RetinaHead", num_classes=20, in_channels=16, feat_channels=16,
              stacked_convs=1, num_base_anchors=9),
)
ANCHORS = dict(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0), octave_base_scale=4.0,
               scales_per_octave=3)


def test_evaluate_detector_voc_metric_equals_the_reference(voc, tmp_path):
    """A narrow RetinaNet (ResNet-18, FPN 16, 20 classes) from flax, converted;
    ``cls_out``'s bias 0 so that scores clear ``score_thr``; two detections an
    image, so the reference's eager fusion compiles one shape; b2 on a
    64 x 64 canvas over the seeded VOC2007 test split."""
    rng = np.random.default_rng(0)
    jax_model = JaxSingleStageDetector(**NARROW)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    variables = _randomise_frozen_bn(dict(variables), rng)
    cls_out = variables["params"]["head"]["cls_out"]
    cls_out = cls_out["conv"] if "conv" in cls_out else cls_out
    cls_out["bias"] = np.zeros_like(cls_out["bias"])
    model = SingleStageDetector(**NARROW, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    cfg = RetinaNetConfig(num_classes=20, anchor_generator=AnchorGenerator(**ANCHORS),
                          max_detections=2)
    jax_cfg = JaxRetinaNetConfig(num_classes=20, anchor_generator=JaxAnchorGenerator(**ANCHORS),
                                 max_detections=2)
    dataset = get_datasets(dict(type="VOCDataset", cache_dir=str(tmp_path), dataset_scope="voc07",
                                dataset_root=voc["voc07"], img_means=MEANS, img_stds=STDS,
                                img_expected_sizes=(64, 48), size_divisor=32, test_mode=True))
    got, got_dets = validate.evaluate_detector(model, cfg, dataset, batch=2, canvas=(64, 64),
                                               voc_metric=True, return_detections=True)
    want, want_dets = jax_validate.evaluate_detector(
        jax_model, jax_cfg, variables, dataset, batch=2, canvas=(64, 64), voc_metric=True,
        return_detections=True)
    assert set(got) == set(want) == {"mAP"} and math.isfinite(got["mAP"])
    assert abs(got["mAP"] - want["mAP"]) <= 1e-6
    assert [len(d["boxes"]) for d in got_dets] == [2] * len(dataset)
    for g, w in zip(got_dets, want_dets, strict=True):
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-5, rtol=0)
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-3, rtol=0)
    annotations = [dataset.get_ann_info(i) for i in range(len(dataset))]
    assert got["mAP"] == eval_voc_map(got_dets, annotations, 20, use_07_metric=True)["mAP"]


# ---------------------------------------------------------------- the CLIs
TINY = dict(
    type="SingleStageDetector",
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3), stem_s2d=True,
                  frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(NARROW["neck"]),
    head=dict(NARROW["head"]),
)


def _write_voc_config(path, root, cache, **runtime):
    runtime = dict(compute_dtype="float32", log_interval=1, val_interval_epochs=1, val_batch=2,
                   **runtime)
    path.write_text(f"""_base_ = {osp.abspath(VOC_CONFIG)!r}
model = dict(_delete_=True, **{TINY!r})
detection = dict(max_detections=8, score_thr=0.0)
data = dict(
    train=dict(dataset_root={root!r}, cache_dir={cache!r}, img_expected_sizes=(64, 48)),
    val=dict(dataset_root={root!r}, cache_dir={cache!r}, img_expected_sizes=(64, 48)),
    sample_per_replica=2, max_gts=8, canvas=(64, 64),
)
schedule = dict(warmup_steps=2)
runtime = dict(**{runtime!r})
""")
    return str(path)


def test_train_with_val_voc_metric_and_test_voc_metric_on_the_cpu(voc, tmp_path):
    config = _write_voc_config(tmp_path / "voc.py", voc["voc07"], str(tmp_path / "cache"),
                               val_voc_metric=True)
    work = tmp_path / "work"
    trainer = train_cli.main([config, "--epochs", "1", "--work-dir", str(work),
                              "--device", "cpu"])
    assert trainer.optimizer.steps == 5  # 10 trainval images, b2
    with open(work / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    vals = [r for r in records if "val_mAP" in r]
    assert len(vals) == 1 and math.isfinite(vals[0]["val_mAP"])
    assert not any(k.startswith("val_AP") for k in vals[0])  # VOC's one metric, not COCO's 12
    out = str(tmp_path / "dets.pkl")
    metrics = test_cli.main([config, str(work / "epoch_1"), "--voc-metric", "--out", out,
                             "--batch", "2", "--device", "cpu"])
    assert set(metrics) == {"mAP"} and math.isfinite(metrics["mAP"])
    assert abs(metrics["mAP"] - vals[0]["val_mAP"]) <= 1e-12
    detections = load(out)
    dataset = get_datasets(dict(Config.fromfile(config)["data"]["val"]))
    annotations = [dataset.get_ann_info(i) for i in range(len(dataset))]
    assert len(detections) == len(dataset) == 6
    again = eval_voc_map(detections, annotations, 20, use_07_metric=True)["mAP"]
    assert abs(again - metrics["mAP"]) <= 1e-12


def test_voc_config_canvas_cannot_hold_a_portrait_voc_image_pin_r10(tmp_path):
    """R10: ``configs/retinanet_r101_fpn_voc.py`` sets ``canvas=(608, 1024)``
    with ``img_expected_sizes=(1000, 600)``; a 375 x 500 (w x h) VOC image
    rescales by min(600 / 375, 1000 / 500) = 1.6 to 600 x 800, 800 rows. The
    reference's collate asserts; the port's raises. Every landscape VOC size
    fits."""
    data = Config.fromfile(VOC_CONFIG)["data"]
    canvas, sizes = tuple(data["canvas"]), tuple(data["train"]["img_expected_sizes"])
    assert canvas == (608, 1024) and sizes == (1000, 600)
    (h, w), sf = rescale_size((500, 375), sizes)
    assert (h, w) == (800, 600) and sf == 1.6
    root = write_voc(str(tmp_path / "portrait"), 1, 1, seed=1, sizes=((375, 500),))
    cfg = dict(data["train"], dataset_root=root, cache_dir=str(tmp_path / "cache"))
    sample = get_datasets(cfg)[0]
    assert sample["img"].data.shape[:2] == (800, 608)  # padded to size_divisor 32
    with pytest.raises(ValueError, match="canvas"):
        collate([sample], canvas=canvas)
    jax_sample = {k: JaxDataContainer(v.data, stack=v.stack, cpu_only=v.cpu_only)
                  for k, v in sample.items() if isinstance(v, DataContainer)}
    with pytest.raises(AssertionError, match="canvas"):
        jax_collate([jax_sample], canvas=canvas)
    for w_, h_ in ((500, 333), (500, 375), (640, 480), (640, 427), (612, 612)):
        (rh, rw), _ = rescale_size((h_, w_), sizes)
        assert rh <= canvas[0] and rw <= canvas[1]
