"""The port's multi-scale and flip evaluation against the JAX package's:
``merge_tta_detections`` with and without ``extras`` (the mask provenance
through the fusion), ``evaluate_detector(tta=True, segm=True)`` on a seeded
two-scale x flip dataset with an oracle ``infer``, and ``tools.test --tta``
end to end on the CPU.

The oracle answers each augmentation with the image's gts in that
augmentation's frame (scaled, then flipped as the dataset flipped it,
horizontally for one image and vertically for the other) and, for each gt,
a 28 x 28 mask patch in that frame: an L-shaped base patch whose missing
quadrant shows a wrong unflip, with a small hole at a place of each
augmentation's own, so that the pasted mask shows which augmentation it
came from. The gt masks are the base patches pasted at the gt boxes. Each gt's
four copies carry different scores, so the fusion keeps a known one.
Both sides must give box and segm mAP 1.0; the port's fused detections
equal the reference's (boxes to 1e-4 px, masks pixel for pixel), and each
fused mask equals its source patch unflipped and pasted at the fused box.
"""

import json

import numpy as np
import pytest
import torch

from test_torch_engine import METRICS
from test_torch_segm_eval import SEGM_METRICS, _write_mask_config, coco  # noqa: F401
from torch_detection_tpu.engine import tta as jax_tta
from torch_detection_tpu.engine import validate as jax_validate
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.data.container import DataContainer
from torch_detection_tpu_torch.data.ops import mask
from torch_detection_tpu_torch.data.ops.bbox import bbox_flip
from torch_detection_tpu_torch.engine import tta, validate
from torch_detection_tpu_torch.engine.checkpoint import save_checkpoint
from torch_detection_tpu_torch.models.heads import paste_masks_np
from torch_detection_tpu_torch.ops.nms import NMSResult
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.utils.config import Config

M = 28
SCALES = (0.8, 1.25)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _metas(rng, n_aug):
    """Metas of one image's augmentations: each scale, unflipped and flipped
    (horizontally, then vertically)."""
    oh, ow = (int(v) for v in rng.integers(40, 90, 2))
    out = []
    for a in range(n_aug):
        s = SCALES[a // 2]
        h, w = int(round(oh * s)), int(round(ow * s))
        out.append(dict(ori_shape=(oh, ow, 3), img_shape=(h, w, 3), pad_shape=(h, w, 3),
                        scale_factor=s, flipped_flag=bool(a % 2),
                        flipped_direction="horizontal" if a < 2 else "vertical"))
    return out


def _dets(rng, meta, n):
    h, w = meta["img_shape"][:2]
    boxes = rng.uniform(0, 0.7, (n, 4)) * [w, h, w, h]
    boxes[:, 2:] += rng.uniform(4, 0.3 * min(h, w), (n, 2))
    return dict(boxes=boxes.astype(np.float32), scores=rng.uniform(0.05, 1, n).astype(np.float32),
                labels=rng.integers(0, 3, n))


@pytest.mark.parametrize("extras", [False, True], ids=["boxes", "extras"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_tta_detections_matches_the_reference(extras, seed):
    """Overlapping detections of four augmentations (one of them empty in
    seed 2), every flip direction, ties of equal scores."""
    rng = np.random.default_rng(seed)
    metas = _metas(rng, 4)
    per_aug = [_dets(rng, m, 0 if (seed == 2 and a == 1) else int(rng.integers(3, 12)))
               for a, m in enumerate(metas)]
    per_aug[0]["scores"][:2] = per_aug[2]["scores"][:2] = 0.5
    probs = [rng.uniform(size=(len(d["boxes"]), M, M)).astype(np.float32) for d in per_aug]
    kw = dict(iou_thr=0.5, max_out=20, extras=probs if extras else None)
    got = tta.merge_tta_detections(per_aug, metas, **kw)
    want = jax_tta.merge_tta_detections(per_aug, metas, **kw)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["labels"], want["labels"])
    np.testing.assert_array_equal(got["scores"], want["scores"])
    np.testing.assert_allclose(got["boxes"], want["boxes"], atol=1e-5, rtol=0)
    if extras:
        assert got["extras"].shape == (len(got["boxes"]), M, M)
        np.testing.assert_array_equal(got["extras"], want["extras"])
        # each kept row is one source row of one augmentation
        sources = np.concatenate(probs)
        for row in got["extras"]:
            assert (sources == row).all(axis=(1, 2)).sum() == 1


def test_merge_tta_detections_without_any_detection():
    metas = _metas(np.random.default_rng(3), 2)
    empty = dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros((0,), np.float32),
                 labels=np.zeros((0,), np.int64))
    extras = [np.zeros((0, M, M), np.float32)] * 2
    got = tta.merge_tta_detections([empty, empty], metas, extras=extras)
    want = jax_tta.merge_tta_detections([empty, empty], metas, extras=extras)
    for key in ("boxes", "scores", "labels", "extras"):
        assert got[key].shape == want[key].shape, key


# ---------------------------------------------------------------- evaluate_detector(tta=True)
def _base_patch():
    """An L: the top-left quadrant empty, so a wrong unflip shows."""
    patch = np.ones((M, M), np.float32)
    patch[: M // 2, : M // 2] = 0.0
    return patch


MARKS = ((16, 4), (16, 20), (4, 20), (22, 12))  # inside the L, one an augmentation


def _aug_patch(a):
    """The base patch with a 3 x 3-cell hole at the augmentation's own place
    (in the original orientation): its mark, which survives the paste."""
    patch = _base_patch()
    y, x = MARKS[a]
    patch[y:y + 3, x:x + 3] = 0.0
    return patch


def _unflip(patch, meta):
    return tta.unflip_masks(patch[None], meta)[0]


class OracleDataset:
    """Test-mode samples of two images, each at two scales unflipped and
    flipped (horizontally for image 0, vertically for image 1); each
    augmentation's pixels hold ``10 * image + augmentation`` so the oracle
    knows what it answers."""

    # every box a few pixels inside its image, so no scaled frame clips it
    BOXES = (np.array([[4, 4, 30, 40], [34, 10, 62, 60], [66, 20, 88, 60]], np.float32),
             np.array([[4, 4, 28, 40], [34, 4, 56, 42], [4, 46, 28, 80], [32, 48, 56, 80]],
                      np.float32))

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.metas, self.anns = [], []
        for i, boxes in enumerate(self.BOXES):
            oh, ow = (70, 96) if i == 0 else (88, 64)
            metas = []
            for a in range(4):
                s = SCALES[a // 2]
                h, w = int(round(oh * s)), int(round(ow * s))
                metas.append(dict(ori_shape=(oh, ow, 3), img_shape=(h, w, 3), pad_shape=(h, w, 3),
                                  scale_factor=s, flipped_flag=bool(a % 2),
                                  flipped_direction="horizontal" if i == 0 else "vertical"))
            # seeded jitter off the pixel grid: a box edge on a pixel centre
            # samples the patch at exactly 0.5, where the one-ulp rounding of
            # the box's round trip through the augmentation's frame decides
            boxes = (boxes + rng.uniform(0.1, 0.9, boxes.shape)).astype(np.float32)
            masks = paste_masks_np(np.stack([_base_patch()] * len(boxes)), boxes, (oh, ow))
            self.metas.append(metas)
            self.anns.append(dict(bboxes=boxes, labels=rng.integers(1, 4, len(boxes)),
                                  bboxes_ignore=np.zeros((0, 4), np.float32),
                                  masks=list(masks.astype(np.uint8)), masks_ignore=[]))

    def __len__(self):
        return 2

    def __getitem__(self, i):
        return dict(img=[np.full(m["img_shape"], 10.0 * i + a, np.float32)
                         for a, m in enumerate(self.metas[i])],
                    img_meta=[DataContainer(m, cpu_only=True) for m in self.metas[i]])

    def get_ann_info(self, i):
        return dict(self.anns[i])

    def source(self, i, k):
        """The augmentation whose copy of gt k scores highest."""
        return (3 - k) % 4

    def answer(self, i, a):
        """Augmentation a's gts in its frame, their scores, and their mask
        patches in its orientation."""
        meta, ann = self.metas[i][a], self.anns[i]
        boxes = ann["bboxes"] * meta["scale_factor"]
        if meta["flipped_flag"]:
            boxes = bbox_flip(boxes, meta["img_shape"][:2], True, meta["flipped_direction"])
        g = len(boxes)
        scores = np.array([0.6 + 0.1 * ((k + a) % 4) for k in range(g)], np.float32)
        patch = _aug_patch(a)
        if meta["flipped_flag"]:
            patch = _unflip(patch, meta)  # mirroring is its own inverse
        return boxes.astype(np.float32), scores, ann["labels"] - 1, np.stack([patch] * g)


def oracle_infer(dataset, max_out=8):
    """``infer(image, img_shape, scale_factor)`` of the port's
    ``make_inference_fn(..., segm=True)`` that answers from the dataset."""

    def infer(image, img_shape, scale_factor):
        b = image.shape[0]
        out = dict(boxes=np.zeros((b, max_out, 4), np.float32),
                   scores=np.zeros((b, max_out), np.float32),
                   labels=np.full((b, max_out), -1, np.int64), valid=np.zeros((b, max_out), bool),
                   mask_probs=np.zeros((b, max_out, M, M), np.float32))
        for j in range(b):
            code = int(round(float(image[j, 0, 0, 0])))
            if float(img_shape[j, 0]) <= 1:  # a padded row of the batch
                continue
            boxes, scores, labels, patches = dataset.answer(code // 10, code % 10)
            n = len(boxes)
            out["boxes"][j, :n], out["scores"][j, :n], out["labels"][j, :n] = boxes, scores, labels
            out["valid"][j, :n], out["mask_probs"][j, :n] = True, patches
        res = NMSResult(*(torch.from_numpy(out[k]) for k in ("boxes", "scores", "labels", "valid")))
        return _MaskResult(res, torch.from_numpy(out["mask_probs"]))

    return infer


class _MaskResult:
    def __init__(self, res, mask_probs):
        self.boxes, self.scores, self.labels, self.valid = res[:4]
        self.mask_probs = mask_probs


class _Model(torch.nn.Module):
    """A parameter for ``evaluate_detector`` to read the device from."""

    def __init__(self):
        super().__init__()
        self.p = torch.nn.Parameter(torch.zeros(1))


class _Cfg:
    num_classes = 3
    nms_iou_thr = 0.5


def test_evaluate_detector_tta_segm_keeps_each_mask_source():
    dataset = OracleDataset()
    infer = oracle_infer(dataset)
    got, got_dets = validate.evaluate_detector(_Model(), _Cfg(), dataset, batch=3, canvas=(64, 64),
                                               tta=True, infer=infer, segm=True,
                                               return_detections=True)

    def jax_infer(variables, image, img_shape, scale_factor):
        return infer(*(torch.from_numpy(np.asarray(a)) for a in (image, img_shape, scale_factor)))

    want, want_dets = jax_validate.evaluate_detector(None, _Cfg(), {}, dataset, batch=3,
                                                     canvas=(64, 64), tta=True, infer=jax_infer,
                                                     segm=True, return_detections=True)
    assert set(got) == set(METRICS) | set(SEGM_METRICS)
    assert got["mAP"] == want["mAP"] == 1.0 and got["segm_mAP"] == want["segm_mAP"] == 1.0
    for key in got:
        assert abs(got[key] - want[key]) <= 1e-12, key
    for i, (g, w) in enumerate(zip(got_dets, want_dets, strict=True)):
        ann, metas = dataset.anns[i], dataset.metas[i]
        assert len(g["boxes"]) == len(ann["bboxes"]) == len(w["boxes"])
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_array_equal(g["scores"], w["scores"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4, rtol=0)
        gt_of = np.abs(g["boxes"][:, None] - ann["bboxes"][None]).sum(-1).argmin(1)
        assert sorted(gt_of) == list(range(len(ann["bboxes"])))  # one fused detection a gt
        np.testing.assert_allclose(g["boxes"], ann["bboxes"][gt_of], atol=1e-4, rtol=0)
        np.testing.assert_array_equal(g["labels"], ann["labels"][gt_of])
        oh, ow = metas[0]["ori_shape"][:2]
        for k, (gm, wm, box) in enumerate(zip(g["masks"], w["masks"], g["boxes"], strict=True)):
            got_mask, want_mask = mask.rle_decode(gm), mask.rle_decode(wm)
            assert got_mask.shape == (oh, ow) and np.array_equal(got_mask, want_mask)
            a = dataset.source(i, gt_of[k])
            assert np.isclose(g["scores"][k], 0.9)
            source = paste_masks_np(_aug_patch(a)[None], box[None], (oh, ow))[0]
            assert np.array_equal(got_mask, source), (i, k, a)
            for other in {0, 1, 2, 3} - {a}:  # the marks tell the augmentations apart
                other_mask = paste_masks_np(_aug_patch(other)[None], box[None], (oh, ow))[0]
                assert not np.array_equal(got_mask, other_mask), (i, k, other)


def test_evaluate_detector_refuses_several_augmentations_without_tta():
    dataset = OracleDataset()
    with pytest.raises(ValueError, match="tta=True"):
        validate.evaluate_detector(_Model(), _Cfg(), dataset, batch=3, infer=oracle_infer(dataset),
                                   segm=True)


def test_tta_buckets_at_each_size_not_at_the_canvas():
    """With ``tta`` each augmentation goes to its size rounded up to 128,
    the ``canvas`` aside, as the reference's."""
    dataset = OracleDataset()
    seen = []
    infer = oracle_infer(dataset)

    def recording(image, img_shape, scale_factor):
        seen.append(tuple(image.shape[1:3]))
        return infer(image, img_shape, scale_factor)

    validate.evaluate_detector(_Model(), _Cfg(), dataset, batch=3, canvas=(64, 64), tta=True,
                               infer=recording, segm=True)
    assert sorted(set(seen)) == [(128, 128)]
    seen.clear()
    validate.evaluate_detector(_Model(), _Cfg(), dataset, batch=3, canvas=(128, 128), tta=False,
                               infer=recording)
    assert set(seen) == {(128, 128)}


# ---------------------------------------------------------------- tools.test --tta
def test_test_cli_tta_segm_end_to_end(coco, tmp_path, monkeypatch):  # noqa: F811
    """``tools.test --tta --segm --device cpu`` on a tiny Mask R-CNN whose
    val config has two sizes and flips: four augmentations an image reach
    ``evaluate_detector(tta=True)``, 24 finite metrics, every RLE at its
    image's original size; without ``--tta`` one augmentation, as before."""
    base = _write_mask_config(tmp_path / "mask.py", coco)
    config = tmp_path / "mask_tta.py"
    config.write_text(f"_base_ = {base!r}\n"
                      "data = dict(val=dict(img_expected_sizes=[(64, 48), (96, 72)], "
                      "flip_ratio=0.5))\n")
    cfg = Config.fromfile(str(config))
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    with torch.no_grad():  # sharp mask logits, so the pasted masks are not empty
        model.mask_head.logits.weight.mul_(40.0)
    save_checkpoint(str(tmp_path / "ckpt"), model)
    calls = []
    real = test_cli.evaluate_detector

    def recording(model, det_cfg, dataset, **kw):
        calls.append((len(dataset[0]["img"]), kw["tta"]))
        return real(model, det_cfg, dataset, **kw)

    monkeypatch.setattr(test_cli, "evaluate_detector", recording)
    out = tmp_path / "res.json"
    metrics = test_cli.main([str(config), str(tmp_path / "ckpt"), "--tta", "--segm", "--out",
                             str(out), "--batch", "2", "--device", "cpu"])
    assert set(metrics) == set(METRICS) | set(SEGM_METRICS)
    assert all(np.isfinite(v) for v in metrics.values())
    segm = json.loads((tmp_path / "res.segm.json").read_text())
    assert len(segm) == len(json.loads(out.read_text())) > 0
    sizes = {1: [60, 100], 2: [100, 60], 3: [80, 80]}
    for r in segm:
        assert mask.rle_decode(r["segmentation"]).shape == tuple(sizes[r["image_id"]])
    test_cli.main([str(config), str(tmp_path / "ckpt"), "--segm", "--batch", "2", "--device", "cpu"])
    assert calls == [(4, True), (1, False)]
