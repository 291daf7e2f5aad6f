"""The port's YOLOv3 (Darknet-53) against the JAX package's.

The detector is the reference tests' narrow one (``tests/test_yolo.py``):
Darknet with one residual block a stage and base width 8 (outputs 64/128/256
at strides 8/16/32), the neck to 64/32/16, the head's bridges to
128/64/32, 5 classes, on a 128 x 160 canvas, b2, with half the COCO anchor
sizes; FrozenBN's statistics and affine, every bias and every kernel drawn
from a numpy seed, carried by ``from_jax_variables`` with ``strict=True``.
Image 1 is smaller than the canvas; its gts include one whose centre sits on
a cell border, two in one cell, and a padding slot.

* ``responsible_flags`` (a per-cell union over the valid gts),
  ``GridAssigner`` (with ``anchor_valid``, duplicate gts), ``yolo_encode``
  and ``yolo_decode``;
* the trunk, neck and head, level by level; ``yolo_loss`` and the gradient
  into every parameter, with and without ``img_shapes``;
* ``decode_yolo`` with exact objectness ties across the preselection cut
  (``pre_select_per_level`` 20 on levels of 60, 240 and 960 anchors);
* the objectness prior of the seeded init; a ``Trainer`` step; the config
  through the builder; a full-width build whose parameter count equals
  ``jax.eval_shape``'s.

Tolerances: flags, assignments and the decode's indices, labels and
validity exactly; IoUs, the coder and the decode's scores and boxes 1e-6 of
max(1, max |want|); features and head outputs 1e-5 relative to each map's
largest value; losses rtol 1e-5; each parameter's gradient 1e-4 in relative
norm of the difference.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import check_trainer_step, rel_norm
from test_torch_ssd import check_reference_tree
from test_torch_vgg import near, rel_close, seeded_variables
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import YOLOV3Config as JaxYOLOV3Config
from torch_detection_tpu.models.detectors import decode_yolo as jax_decode_yolo
from torch_detection_tpu.models.detectors import yolo_loss as jax_yolo_loss
from torch_detection_tpu.models.detectors.yolov3 import yolo_decode as jax_yolo_decode
from torch_detection_tpu.models.detectors.yolov3 import yolo_encode as jax_yolo_encode
from torch_detection_tpu.ops.anchors import YOLOAnchorGenerator as JaxYOLOAnchorGenerator
from torch_detection_tpu.ops.assign import GridAssigner as JaxGridAssigner
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector, build_loss_fn
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    SingleStageDetector,
    YOLOV3Config,
    decode_yolo,
    yolo_loss,
)
from torch_detection_tpu_torch.models.detectors.yolov3 import yolo_decode, yolo_encode
from torch_detection_tpu_torch.models.inits import bias_init_with_prob
from torch_detection_tpu_torch.ops.anchors import YOLOAnchorGenerator
from torch_detection_tpu_torch.ops.assign import GridAssigner
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
C = 5
MODEL = dict(
    backbone=dict(type="Darknet", depth=53, stages=(1, 1, 1, 1, 1), base_channels=8,
                  out_indices=(2, 3, 4)),
    neck=dict(type="YOLOV3Neck", in_channels=(64, 128, 256), out_channels=(64, 32, 16)),
    head=dict(type="YOLOV3Head", num_classes=C, in_channels=(64, 32, 16),
              out_channels=(128, 64, 32)),
)
BASE_SIZES = (((58.0, 45.0), (78.0, 99.0), (186.0, 163.0)),
              ((15.0, 30.0), (31.0, 22.0), (29.0, 59.0)),
              ((5.0, 6.0), (8.0, 15.0), (16.0, 11.0)))
GEN = YOLOAnchorGenerator(base_sizes=BASE_SIZES)
JAX_GEN = JaxYOLOAnchorGenerator(base_sizes=BASE_SIZES)
CFG = YOLOV3Config(num_classes=C, anchor_generator=GEN)
JAX_CFG = JaxYOLOV3Config(num_classes=C, anchor_generator=JAX_GEN)
CANVAS = (128, 160)
SIZES = [(4, 5), (8, 10), (16, 20)]  # strides 32, 16, 8
IMG_SHAPES = np.array([[128, 160], [100, 121]], np.float32)
LOSS_KEYS = ("loss", "loss_xy", "loss_wh", "loss_conf", "loss_cls", "num_pos")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gts():
    """Image 0: four gts, two with centres in one cell at every level, one
    centred on a cell border (x = 64.0); image 1: two gts and two padding
    slots, one of them a stale box."""
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0] = [[10, 12, 50, 60], [8, 14, 50, 58], [40, 30, 88, 100], [100, 20, 150, 70]]
    boxes[1, :3] = [[20, 20, 60, 90], [70, 10, 118, 60], [5, 5, 40, 40]]
    return dict(gt_boxes=boxes,
                gt_labels=np.array([[1, 3, 5, 2], [4, 2, 1, 0]], np.int32),
                gt_valid=np.array([[True] * 4, [True, True, False, False]]))


def batch_of(rng):
    image = rng.normal(size=(2, *CANVAS, 3)).astype(np.float32)
    image[1, 100:] = 0.0
    image[1, :, 121:] = 0.0
    return dict(image=image, img_shape=IMG_SHAPES, **gts())


def tg(batch, *keys):
    return [torch.from_numpy(np.asarray(batch[k])) for k in keys]


# ---------------------------------------------------------------- anchors, assignment, coder


def test_anchors_strides_and_sizes_match_the_reference():
    np.testing.assert_array_equal(GEN.flat_anchors(SIZES).numpy(),
                                  np.asarray(JAX_GEN.flat_anchors(SIZES)))
    np.testing.assert_array_equal(GEN.flat_strides(SIZES).numpy(),
                                  np.asarray(JAX_GEN.flat_strides(SIZES)))
    assert GEN.featmap_sizes_for(CANVAS) == JAX_GEN.featmap_sizes_for(CANVAS) == SIZES
    assert YOLOAnchorGenerator().featmap_sizes_for((608, 608)) == [(19, 19), (38, 38), (76, 76)]
    assert YOLOAnchorGenerator().flat_anchors([(19, 19), (38, 38), (76, 76)]).shape == (22743, 4)


def test_responsible_flags_match_the_reference():
    g = gts()
    got = GEN.responsible_flags(SIZES, *tg(g, "gt_boxes", "gt_valid"))
    for i in range(2):
        want = JAX_GEN.responsible_flags(SIZES, jnp.asarray(g["gt_boxes"][i]),
                                         jnp.asarray(g["gt_valid"][i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    # image 1's stale padding slot marks nothing: its valid gts alone give the same flags
    valid_only = GEN.responsible_flags(SIZES, torch.from_numpy(g["gt_boxes"][1:, :2]),
                                       torch.ones((1, 2), dtype=torch.bool))
    assert torch.equal(got[1], valid_only[0])
    # the two gts of one cell mark it once: 3 cells of 3 anchors on each of 3 levels
    assert int(got[0].sum()) == 3 * 3 * 3


@pytest.mark.parametrize("with_valid", [False, True])
def test_grid_assigner_matches_the_reference(with_valid):
    g = gts()
    anchors = GEN.flat_anchors(SIZES)
    resp = GEN.responsible_flags(SIZES, *tg(g, "gt_boxes", "gt_valid"))
    valid = None
    if with_valid:
        cx = (anchors[:, 0] + anchors[:, 2]) * 0.5
        cy = (anchors[:, 1] + anchors[:, 3]) * 0.5
        shapes = torch.from_numpy(IMG_SHAPES)
        valid = (cx[None] < shapes[:, 1:2]) & (cy[None] < shapes[:, 0:1])
    assigner = GridAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    got = assigner(anchors, resp, *tg(g, "gt_boxes", "gt_valid", "gt_labels"), anchor_valid=valid)
    jax_assigner = JaxGridAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)
    for i in range(2):
        want = jax_assigner(jnp.asarray(anchors.numpy()), jnp.asarray(resp[i].numpy()),
                            jnp.asarray(g["gt_boxes"][i]), jnp.asarray(g["gt_valid"][i]),
                            jnp.asarray(g["gt_labels"][i]),
                            anchor_valid=None if valid is None else jnp.asarray(valid[i].numpy()))
        np.testing.assert_array_equal(got.assigned_gt_inds[i].numpy(),
                                      np.asarray(want.assigned_gt_inds))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))
        near(got.max_overlaps[i].numpy(), want.max_overlaps, 1e-6)
    assert int((got.assigned_gt_inds > 0).sum()) >= 5
    assert bool((got.assigned_gt_inds == -1).any())  # responsible only: some ignored


def test_yolo_coder_matches_the_reference(rng):
    anchors = GEN.flat_anchors(SIZES)
    strides = GEN.flat_strides(SIZES)
    n = anchors.shape[0]
    xy = rng.uniform(-20, 150, (2, n, 2)).astype(np.float32)
    gt = np.concatenate([xy, xy + rng.uniform(1, 90, (2, n, 2))], -1).astype(np.float32)
    got = yolo_encode(anchors, strides, torch.from_numpy(gt))
    for i in range(2):
        want = jax_yolo_encode(jnp.asarray(anchors.numpy()), jnp.asarray(strides.numpy()),
                               jnp.asarray(gt[i]))
        near(got[i].numpy(), want, 1e-6)
    pred = rng.normal(0, 3, (n, 4)).astype(np.float32)  # |t_wh| past the 4.135 cap too
    want = jax_yolo_decode(jnp.asarray(anchors.numpy()), jnp.asarray(strides.numpy()),
                           jnp.asarray(pred))
    near(yolo_decode(anchors, strides, torch.from_numpy(pred)).numpy(), want, 1e-6)


# ---------------------------------------------------------------- model, loss, gradients


@pytest.fixture(scope="module", params=[True, False], ids=["img_shapes", "no_img_shapes"])
def yolo_setup(request):
    """Both detectors on the same seeded weights; from one jit of the JAX
    side its backbone, neck and head outputs, its loss dict and the gradient
    into every parameter; the port's model and its loss dict and gradients
    through ``build_loss_fn`` (the batch without ``img_shape`` where the
    reference's loss takes none)."""
    rng = np.random.default_rng(11)
    batch = batch_of(rng)
    jax_model = JaxSingleStageDetector(**MODEL)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(batch["image"]))
    variables = seeded_variables(shapes, rng)
    with_shapes = request.param
    if not with_shapes:
        batch.pop("img_shape")
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def stages(m, x):
        feats = m.backbone_mod(x)
        necks = m.neck_mod(feats)
        return feats, necks, m.head_mod(necks)

    def loss(params):
        feats, necks, outs = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch["image"],
            method=stages)
        out = jax_yolo_loss(JAX_CFG, outs, jbatch["gt_boxes"], jbatch["gt_labels"],
                            jbatch["gt_valid"], img_shapes=jbatch.get("img_shape"))
        return out["loss"], (out, feats, necks, outs)

    (_, (losses, feats, necks, outs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model = SingleStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    got_loss, got = build_loss_fn(model, CFG)(tbatch)
    got["loss"] = got_loss
    got_loss.backward()
    return dict(model=model, batch=batch, got=got,
                want={k: float(v) for k, v in losses.items()},
                grads=from_jax_variables({"params": grads}),
                stages=[jax.tree_util.tree_map(np.asarray, t) for t in (feats, necks, outs)])


def test_trunk_neck_and_head_match_the_reference(yolo_setup):
    model = yolo_setup["model"]
    x = torch.from_numpy(yolo_setup["batch"]["image"])
    with torch.no_grad():
        feats = model.backbone(x)
        necks = model.neck(feats)
        outs = model.head(necks)
    for what, got, want in zip(("backbone", "neck", "head"), (feats, necks, outs),
                               yolo_setup["stages"]):
        assert len(got) == len(want) == 3
        for lvl, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (what, lvl)
            rel_close(g.numpy(), w, 1e-5, f"{what} {lvl}")
    assert [tuple(o.shape[1:3]) for o in outs] == SIZES


def test_yolo_loss_and_every_gradient_match(yolo_setup):
    got, want = yolo_setup["got"], yolo_setup["want"]
    assert set(got) == set(LOSS_KEYS) and want["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=1e-5, err_msg=k)
    for name, p in yolo_setup["model"].named_parameters():
        assert rel_norm(p.grad.numpy(), yolo_setup["grads"][name].numpy()) <= 1e-4, name


def test_img_shapes_ignore_the_padding_anchors():
    """With ``img_shapes`` the anchors centred in image 1's padding drop out
    of the objectness term (the reference's ``anchor_valid``)."""
    rng = np.random.default_rng(3)
    pred = [torch.from_numpy(rng.normal(size=(2, h, w, 3 * (5 + C))).astype(np.float32))
            for h, w in SIZES]
    b = batch_of(rng)
    args = tg(b, "gt_boxes", "gt_labels", "gt_valid")
    jargs = [jnp.asarray(a.numpy()) for a in args]
    conf = []
    for shapes in (None, IMG_SHAPES):
        out = yolo_loss(CFG, pred, *args,
                        img_shapes=None if shapes is None else torch.from_numpy(shapes))
        conf.append(float(out["loss_conf"]))
        want = jax.jit(functools.partial(jax_yolo_loss, JAX_CFG))(
            [jnp.asarray(p.numpy()) for p in pred], *jargs,
            img_shapes=None if shapes is None else jnp.asarray(shapes))
        for k in LOSS_KEYS:
            np.testing.assert_allclose(float(out[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert conf[1] < conf[0]  # fewer anchors in the objectness term


# ---------------------------------------------------------------- decode


def tied_maps(rng):
    """Prediction maps whose objectness takes a few values only, so that
    every level's 20th and 21st anchors by objectness tie."""
    maps = []
    for h, w in SIZES:
        m = rng.normal(0, 1.5, (2, h, w, 3 * (5 + C))).astype(np.float32)
        m[..., 4::5 + C] = np.round(rng.normal(0, 1.5, (2, h, w, 3)) * 2) / 2 + 1.0
        maps.append(m)
    return maps


def test_decode_yolo_matches_with_ties_at_the_preselection_cut(rng):
    cfg = YOLOV3Config(num_classes=C, anchor_generator=GEN, pre_select_per_level=20,
                       score_thr=0.05)
    jax_cfg = JaxYOLOV3Config(num_classes=C, anchor_generator=JAX_GEN, pre_select_per_level=20,
                              score_thr=0.05)
    maps = tied_maps(rng)
    for m in maps:  # the cut falls inside a tie group in every level of both images
        obj = np.sort(m[..., 4::5 + C].reshape(2, -1), axis=1)[:, ::-1]
        assert (obj[:, 19] == obj[:, 20]).all()
    shapes, scale = IMG_SHAPES, np.array([0.25, 0.2], np.float32)
    want = jax.jit(functools.partial(jax_decode_yolo, jax_cfg))(
        [jnp.asarray(m) for m in maps], img_shapes=jnp.asarray(shapes),
        scale_factors=jnp.asarray(scale))
    got = decode_yolo(cfg, [torch.from_numpy(m) for m in maps], torch.from_numpy(shapes),
                      torch.from_numpy(scale))
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.valid.sum()) > 20
    near(got.scores.numpy(), want.scores, 1e-6, "scores")
    near(got.boxes.numpy(), want.boxes, 1e-6, "boxes")


def test_inference_entry_point(yolo_setup):
    """``make_inference_fn`` reaches ``decode_yolo`` on the model's outputs."""
    model = yolo_setup["model"].eval()
    image, shapes = torch.from_numpy(yolo_setup["batch"]["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, CFG)(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_yolo(CFG, model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    model.train()


# ---------------------------------------------------------------- init, training, configs


def test_seeded_init_gives_the_objectness_prior():
    jax_model = JaxSingleStageDetector(**MODEL)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    model = build_detector(dict(MODEL, type="SingleStageDetector"), "float32", device="cpu")
    for lvl in range(3):
        bias = getattr(model.head, f"pred{lvl}").bias.detach()
        np.testing.assert_array_equal(bias.numpy(),
                                      np.asarray(variables["params"]["head"][f"pred{lvl}"]["bias"]))
        assert float(bias[4]) == np.float32(bias_init_with_prob(0.01)) and float(bias[5]) == 0.0


def test_trainer_step():
    model = build_detector(dict(MODEL, type="SingleStageDetector"), "float32", device="cpu")
    check_trainer_step(model, CFG, batch_of(np.random.default_rng(5)), LOSS_KEYS[:-1])


def test_config_matches_the_reference():
    det = Config.fromfile(os.path.join(CONFIGS, "yolov3_d53_coco.py")).detection
    got, want = build_detection_cfg(det), jax_builder.build_detection_cfg(dict(det))
    assert isinstance(got, YOLOV3Config)
    for field in ("num_classes", "loss_xy_weight", "loss_wh_weight", "loss_conf_weight",
                  "loss_cls_weight", "conf_thr", "score_thr", "nms_iou_thr",
                  "pre_select_per_level", "pre_nms_top_k", "max_detections"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.anchor_generator.strides == want.anchor_generator.strides
    assert got.anchor_generator.base_sizes == want.anchor_generator.base_sizes
    assert isinstance(got.assigner, GridAssigner)
    for field in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
        assert getattr(got.assigner, field) == getattr(want.assigner, field), field
    assert not want.approx_top_k


def test_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg = Config.fromfile(os.path.join(CONFIGS, "yolov3_d53_coco.py"))
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert check_reference_tree(cfg.model, model, 64) == 61949149
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
