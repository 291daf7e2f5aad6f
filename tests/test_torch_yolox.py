"""The port's YOLOX against the JAX package's.

The detector is narrow: CSPDarknet at ``widen_factor`` 0.125 (8 to 128
channels, one CSP block a stage), the PAFPN to 32, the head's towers 32
wide, 8 classes, on a 96 x 128 canvas, b2 (image 1 smaller than the
canvas); FrozenBN's statistics and affine, every bias and every kernel drawn
from a numpy seed, carried by ``from_jax_variables`` with ``strict=True``.
Image 0's gts include an exact duplicate (its points tie across gts) and
one that overlaps both; each image has a padding slot.

* the Focus stem's channel order, SPP's SAME max-pools against flax;
* the trunk, neck and head, level by level; ``yolox_loss`` and the
  gradient into every parameter; the R3 pin (per-image normalisation);
* ``simota_assign`` on inputs whose costs tie at each gt's k_g-th smallest
  (every tied point selected) and across duplicate gts (the first wins),
  and on seeded inputs; ``use_l1``;
* ``decode_yolox`` with score ties at the ``pre_nms_top_k`` cut;
* the seeded init's priors, a ``Trainer`` step, the config through the
  builder, a full-width build whose parameter count equals
  ``jax.eval_shape``'s (6 875 711).

Tolerances: the Focus order, positive sets, matched gts, the decode's
indices, labels and validity exactly; SPP, features and head outputs 1e-5
relative to each map's largest value; IoUs, the decode's scores and boxes
1e-6 of max(1, max |want|); losses rtol 1e-5; each parameter's gradient
1e-4 in relative norm of the difference.
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
from torch_detection_tpu.models.backbones.csp_darknet import SPPBottleneck as JaxSPP
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import YOLOXConfig as JaxYOLOXConfig
from torch_detection_tpu.models.detectors import decode_yolox as jax_decode_yolox
from torch_detection_tpu.models.detectors import simota_assign as jax_simota_assign
from torch_detection_tpu.models.detectors import yolox_loss as jax_yolox_loss
from torch_detection_tpu.models.detectors.yolox import _decode_boxes as jax_decode_boxes
from torch_detection_tpu.models.detectors.yolox import _flat_grid as jax_flat_grid
from torch_detection_tpu.models.inits import bias_init_with_prob as jax_bias_init_with_prob
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector, build_loss_fn
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.backbones.csp_darknet import SPPBottleneck
from torch_detection_tpu_torch.models.backbones.resnet import space_to_depth_2x2
from torch_detection_tpu_torch.models.detectors import (
    SingleStageDetector,
    YOLOXConfig,
    decode_yolox,
    simota_assign,
    yolox_loss,
)
from torch_detection_tpu_torch.models.detectors.yolox import decode_boxes, flat_grid
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
C = 8
MODEL = dict(
    backbone=dict(type="CSPDarknet", deepen_factor=0.33, widen_factor=0.125, out_indices=(2, 3, 4)),
    neck=dict(type="YOLOXPAFPN", in_channels=(32, 64, 128), out_channels=32, num_csp_blocks=1),
    head=dict(type="YOLOXHead", num_classes=C, in_channels=32, feat_channels=32, stacked_convs=2),
)
CFG = YOLOXConfig(num_classes=C)
JAX_CFG = JaxYOLOXConfig(num_classes=C)
CANVAS = (96, 128)
SIZES = [(12, 16), (6, 8), (3, 4)]  # strides 8, 16, 32
IMG_SHAPES = np.array([[96, 128], [80, 100]], np.float32)
LOSS_KEYS = ("loss", "loss_cls", "loss_reg", "loss_obj", "num_pos")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gts():
    """Image 0: a gt, its exact duplicate, one overlapping both and a
    padding slot; image 1: three gts and a stale padding slot."""
    boxes = np.zeros((2, 4, 4), np.float32)
    boxes[0, :3] = [[10, 12, 50, 60], [10, 12, 50, 60], [40, 30, 100, 90]]
    boxes[1] = [[20, 20, 60, 76], [60, 10, 98, 60], [4, 50, 30, 78], [5, 5, 40, 40]]
    return dict(gt_boxes=boxes, gt_labels=np.array([[1, 1, 5, 0], [3, 8, 2, 4]], np.int32),
                gt_valid=np.array([[True, True, True, False], [True, True, True, False]]))


def batch_of(rng):
    image = rng.normal(size=(2, *CANVAS, 3)).astype(np.float32)
    image[1, 80:] = 0.0
    image[1, :, 100:] = 0.0
    return dict(image=image, **gts())


def tg(batch, *keys):
    return [torch.from_numpy(np.asarray(batch[k])) for k in keys]


# ---------------------------------------------------------------- Focus and SPP


def test_focus_channel_order_is_the_reference_s(rng):
    """The stem's space-to-depth is csp_darknet.py's reshape and transpose
    (channel dy * 2c + dx * c + c), and in NCHW the permute the module
    docstring gives."""
    x = rng.normal(size=(2, 6, 10, 3)).astype(np.float32)
    b, h, w, c = x.shape
    want = jnp.asarray(x).reshape(b, h // 2, 2, w // 2, 2, c).transpose(0, 1, 3, 2, 4, 5)
    want = np.asarray(want.reshape(b, h // 2, w // 2, 4 * c))
    got = space_to_depth_2x2(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).reshape(b, c, h // 2, 2, w // 2, 2)
    nchw = nchw.permute(0, 3, 5, 1, 2, 4).reshape(b, 4 * c, h // 2, w // 2)
    np.testing.assert_array_equal(nchw.permute(0, 2, 3, 1).numpy(), want)
    assert want[0, 1, 2, 5] == x[0, 2, 5, 2] and want[0, 1, 2, 6] == x[0, 3, 4, 0]


@pytest.mark.parametrize("hw", [(5, 7), (16, 12)])
def test_spp_matches_flax(rng, hw):
    """SPP at 5, 9 and 13 on maps smaller and larger than the windows: the
    -inf SAME padding, the concat order and the fuse."""
    x = (rng.normal(size=(2, *hw, 32)) - 1.0).astype(np.float32)
    jax_spp = JaxSPP(16, norm_cfg={"type": "FrozenBN"})
    variables = seeded_variables(jax.eval_shape(jax_spp.init, jax.random.PRNGKey(0),
                                                jnp.asarray(x)), rng)
    want = jax.jit(jax_spp.apply)(variables, jnp.asarray(x))
    spp = SPPBottleneck(32, 16, norm_cfg={"type": "FrozenBN"}, device="cpu")
    spp.load_state_dict(from_jax_variables(variables, spp), strict=True)
    with torch.no_grad():
        got = spp(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    rel_close(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------- model, loss, gradients


@pytest.fixture(scope="module")
def yolox_setup():
    """Both detectors on the same seeded weights; from one jit of the JAX
    side its backbone, neck and head outputs, its loss dict and the gradient
    into every parameter; the port's model, its loss dict and gradients
    through ``build_loss_fn``."""
    rng = np.random.default_rng(11)
    batch = batch_of(rng)
    jax_model = JaxSingleStageDetector(**MODEL)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(batch["image"]))
    variables = seeded_variables(shapes, rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def stages(m, x):
        feats = m.backbone_mod(x)
        necks = m.neck_mod(feats)
        return feats, necks, m.head_mod(necks)

    def loss(params):
        feats, necks, outs = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch["image"],
            method=stages)
        out = jax_yolox_loss(JAX_CFG, *outs, jbatch["gt_boxes"], jbatch["gt_labels"],
                             jbatch["gt_valid"])
        return out["loss"], (out, feats, necks, outs)

    (_, (losses, feats, necks, outs)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model = SingleStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    got_loss, got = build_loss_fn(model, CFG)(tg_all(batch))
    got["loss"] = got_loss
    got_loss.backward()
    return dict(model=model, batch=batch, got=got,
                want={k: float(v) for k, v in losses.items()},
                grads=from_jax_variables({"params": grads}),
                stages=[jax.tree_util.tree_map(np.asarray, t) for t in (feats, necks, outs)])


def tg_all(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_trunk_neck_and_head_match_the_reference(yolox_setup):
    model = yolox_setup["model"]
    x = torch.from_numpy(yolox_setup["batch"]["image"])
    with torch.no_grad():
        feats = model.backbone(x)
        necks = model.neck(feats)
        outs = model.head(necks)
    got_maps = [("backbone", feats), ("neck", necks)] + [
        (f"head {branch}", o) for branch, o in zip(("cls", "reg", "obj"), outs)]
    want_feats, want_necks, want_outs = yolox_setup["stages"]
    want_maps = [want_feats, want_necks, *want_outs]
    for (what, got), want in zip(got_maps, want_maps, strict=True):
        assert len(got) == len(want) == 3
        for lvl, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape, (what, lvl)
            rel_close(g.numpy(), w, 1e-5, f"{what} {lvl}")
    assert [tuple(o.shape[1:3]) for o in outs[0]] == SIZES


def test_yolox_loss_and_every_gradient_match(yolox_setup):
    got, want = yolox_setup["got"], yolox_setup["want"]
    assert set(got) == set(LOSS_KEYS) and want["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=1e-5, err_msg=k)
    for name, p in yolox_setup["model"].named_parameters():
        assert rel_norm(p.grad.numpy(), yolox_setup["grads"][name].numpy()) <= 1e-4, name


def test_r3_each_image_over_its_own_positive_count(yolox_setup):
    """R3: each image's sums over its own positive count, then the mean over
    the images (the reference's); the official YOLOX divides the batch's
    sums by the batch's count, which differs where the counts differ."""
    outs = [tuple(torch.from_numpy(o.copy()) for o in branch)
            for branch in yolox_setup["stages"][2]]
    b = tg_all(yolox_setup["batch"])
    per_image = [yolox_loss(CFG, *(tuple(o[i:i + 1] for o in branch) for branch in outs),
                            b["gt_boxes"][i:i + 1], b["gt_labels"][i:i + 1],
                            b["gt_valid"][i:i + 1]) for i in range(2)]
    counts = [max(float(p["num_pos"]), 1.0) for p in per_image]
    assert counts[0] != counts[1]
    whole = yolox_loss(CFG, *outs, b["gt_boxes"], b["gt_labels"], b["gt_valid"])
    mean = sum(float(p["loss"]) for p in per_image) / 2
    pooled = sum(float(p["loss"]) * n for p, n in zip(per_image, counts)) / sum(counts)
    np.testing.assert_allclose(float(whole["loss"]), mean, rtol=1e-6)
    np.testing.assert_allclose(float(whole["loss"]), yolox_setup["want"]["loss"], rtol=1e-5)
    assert abs(pooled - mean) > 1e-3 * abs(mean)


# ---------------------------------------------------------------- SimOTA


def assign_inputs(rng, ties: bool):
    """Per-image SimOTA inputs on ``SIZES``: with ``ties`` every point
    predicts one class vector and objectness, and the points of each gt's
    centre region one box shared by them all, so their costs tie exactly;
    else seeded logits and boxes around the points."""
    grid, strides = flat_grid(CFG, SIZES)
    n = grid.shape[0]
    centers = (grid + 0.5 * strides[:, None]).numpy()
    if ties:
        cls = np.broadcast_to(rng.normal(0, 1, C), (2, n, C)).astype(np.float32)
        obj = np.full((2, n), 0.25, np.float32)
        wh = np.full((2, n, 2), 24.0, np.float32)
        boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1).astype(np.float32)
        for i, gt in enumerate(gts()["gt_boxes"]):
            for j, (x1, y1, x2, y2) in enumerate(gt[:2]):
                cx, cy = (x1 + x2) / 2, (y1 + y2) / 2
                near_c = ((np.abs(centers[:, 0] - cx) < 2.5 * strides.numpy())
                          & (np.abs(centers[:, 1] - cy) < 2.5 * strides.numpy()))
                boxes[i, near_c] = [x1 + 4.0, y1 + 6.0, x2 - 8.0, y2 + 2.0]
    else:
        cls = rng.normal(0, 2, (2, n, C)).astype(np.float32)
        obj = rng.normal(0, 2, (2, n)).astype(np.float32)
        wh = rng.uniform(8, 60, (2, n, 2)).astype(np.float32)
        c = centers + rng.normal(0, 4, (2, n, 2))
        boxes = np.concatenate([c - wh / 2, c + wh / 2], -1).astype(np.float32)
    return cls, obj, boxes, grid, strides


@pytest.mark.parametrize("ties", [True, False], ids=["ties", "seeded"])
def test_simota_matches_the_reference(rng, ties):
    cls, obj, boxes, grid, strides = assign_inputs(rng, ties)
    g = gts()
    got = simota_assign(CFG, torch.from_numpy(cls), torch.from_numpy(obj), torch.from_numpy(boxes),
                        grid, strides, *tg(g, "gt_boxes", "gt_labels", "gt_valid"))
    jgrid, jstrides = jax_flat_grid(JAX_CFG, SIZES)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    np.testing.assert_array_equal(strides.numpy(), np.asarray(jstrides))
    want = jax.jit(jax.vmap(functools.partial(jax_simota_assign, JAX_CFG),
                            in_axes=(0, 0, 0, None, None, 0, 0, 0)))(
        jnp.asarray(cls), jnp.asarray(obj), jnp.asarray(boxes), jgrid, jstrides,
        *(jnp.asarray(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
    np.testing.assert_array_equal(got.fg.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got.matched.numpy(), np.asarray(want[1]))
    near(got.matched_iou.numpy(), want[2], 1e-6)
    assert int(got.fg.sum()) >= 6
    if ties:
        # each of image 0's first two gts selects every point tied at its k_g-th
        # cost, more than k_g of them; their duplicates go to the first gt
        cost, kth = got.cost[0], got.kth[0]
        for j in range(2):
            tied = int((cost[:, j] == kth[j]).sum())
            assert tied > 1 and int((cost[:, j] <= kth[j]).sum()) > CFG.candidate_topk // 2
        both = (cost[:, 0] <= kth[0]) & (cost[:, 1] <= kth[1])
        assert bool(both.any()) and bool((got.matched[0][both] == 0).all())


def test_use_l1_adds_the_raw_box_term(rng):
    """``use_l1`` on seeded head outputs: the port's loss dict equals the
    reference's, and the box term grows by the L1."""
    outs = [tuple(rng.normal(0, 1, (2, h, w, d)).astype(np.float32) for h, w in SIZES)
            for d in (C, 4, 1)]
    g = gts()
    cfg_l1 = YOLOXConfig(num_classes=C, use_l1=True)
    want = jax.jit(functools.partial(jax_yolox_loss, JaxYOLOXConfig(num_classes=C, use_l1=True)))(
        *([jnp.asarray(m) for m in branch] for branch in outs),
        *(jnp.asarray(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
    t_outs = [tuple(torch.from_numpy(m) for m in branch) for branch in outs]
    got = yolox_loss(cfg_l1, *t_outs, *tg(g, "gt_boxes", "gt_labels", "gt_valid"))
    plain = yolox_loss(CFG, *t_outs, *tg(g, "gt_boxes", "gt_labels", "gt_valid"))
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    assert float(got["loss_reg"]) > float(plain["loss_reg"]) + 0.1
    assert float(got["loss_cls"]) == float(plain["loss_cls"])


# ---------------------------------------------------------------- decode


def test_decode_boxes_match_the_reference(rng):
    grid, strides = flat_grid(CFG, SIZES)
    reg = rng.normal(0, 6, (grid.shape[0], 4)).astype(np.float32)  # past the [-10, 8] clip too
    want = jax_decode_boxes(jnp.asarray(reg), *jax_flat_grid(JAX_CFG, SIZES))
    near(decode_boxes(torch.from_numpy(reg), grid, strides).numpy(), want, 1e-6)


def test_decode_yolox_matches_with_ties_at_the_pre_nms_cut(rng):
    """Class logits on a grid of halves and objectness 0, so that the scores
    tie in groups across the ``pre_nms_top_k`` cut of 60 pairs."""
    cfg = YOLOXConfig(num_classes=C, pre_nms_top_k=60, score_thr=0.05)
    jax_cfg = JaxYOLOXConfig(num_classes=C, pre_nms_top_k=60, score_thr=0.05)
    cls = [(np.round(rng.normal(0, 1.5, (2, h, w, C)) * 2) / 2).astype(np.float32)
           for h, w in SIZES]
    reg = [rng.normal(0, 0.5, (2, h, w, 4)).astype(np.float32) for h, w in SIZES]
    obj = [np.zeros((2, h, w, 1), np.float32) for h, w in SIZES]
    flat = np.sort(np.concatenate([c.reshape(2, -1) for c in cls], 1), axis=1)[:, ::-1]
    assert (flat[:, 59] == flat[:, 60]).all()
    shapes, scale = IMG_SHAPES, np.array([0.5, 0.25], np.float32)
    want = jax.jit(functools.partial(jax_decode_yolox, jax_cfg))(
        [jnp.asarray(m) for m in cls], [jnp.asarray(m) for m in reg], [jnp.asarray(m) for m in obj],
        img_shapes=jnp.asarray(shapes), scale_factors=jnp.asarray(scale))
    got = decode_yolox(cfg, *([torch.from_numpy(m) for m in branch] for branch in (cls, reg, obj)),
                       torch.from_numpy(shapes), torch.from_numpy(scale))
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.valid.sum()) > 20
    near(got.scores.numpy(), want.scores, 1e-6, "scores")
    near(got.boxes.numpy(), want.boxes, 1e-6, "boxes")


def test_inference_entry_point(yolox_setup):
    """``make_inference_fn`` reaches ``decode_yolox`` on the model's outputs."""
    model = yolox_setup["model"].eval()
    image, shapes = torch.from_numpy(yolox_setup["batch"]["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, CFG)(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_yolox(CFG, *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    model.train()


# ---------------------------------------------------------------- init, training, configs


def test_seeded_init_gives_the_priors():
    model = build_detector(dict(MODEL, type="SingleStageDetector"), "float32", device="cpu")
    prior = np.float32(jax_bias_init_with_prob(0.01))
    for lvl in range(3):
        for name, value in (("cls_out", prior), ("obj_out", prior), ("reg_out", 0.0)):
            bias = getattr(model.head, f"{name}{lvl}").bias.detach()
            assert bool((bias == float(value)).all()), (name, lvl)


def test_trainer_step():
    """A step through ``Trainer``; small gts beside the large ones, so that
    SimOTA places positives on every level and every parameter moves."""
    model = build_detector(dict(MODEL, type="SingleStageDetector"), "float32", device="cpu")
    batch = batch_of(np.random.default_rng(5))
    batch["gt_boxes"][:, 3] = [[60, 8, 70, 18], [100, 70, 111, 79]]
    batch["gt_labels"][:, 3] = [6, 7]
    batch["gt_valid"][:, 3] = True
    check_trainer_step(model, CFG, batch, LOSS_KEYS[:-1])


def test_config_matches_the_reference():
    det = Config.fromfile(os.path.join(CONFIGS, "yolox_s_coco.py")).detection
    got, want = build_detection_cfg(det), jax_builder.build_detection_cfg(dict(det))
    assert isinstance(got, YOLOXConfig)
    for field in ("num_classes", "strides", "center_radius", "candidate_topk", "iou_cost_weight",
                  "reg_loss_weight", "use_l1", "score_thr", "nms_iou_thr", "pre_nms_top_k",
                  "max_detections"):
        assert getattr(got, field) == getattr(want, field), field
    assert not want.approx_top_k
    with pytest.raises(NotImplementedError, match="approx_top_k"):
        build_detection_cfg(dict(det, approx_top_k=True))


def test_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg = Config.fromfile(os.path.join(CONFIGS, "yolox_s_coco.py"))
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert check_reference_tree(cfg.model, model, 64) == 6875711
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
