"""The port's SOLOv2 (heads, targets, loss, Matrix NMS, decode) against the JAX package's.

The detector is a ResNet-18 with FPN 16 on P2-P6, 2-conv GN(8) towers of
16, kernels of E = 8, grids (12, 10, 8, 6, 4), 3 classes, on a 64 x 96
canvas (a 16 x 24 stride-4 mask map; 96 is not a power of two, so the
canvas ratios round), b2; every tensor drawn from a numpy seed and carried
by ``from_jax_variables`` with ``strict=True``. The reference runs under
jit, as it trains and serves. The gts include two of equal area whose
centre regions overlap (the first wins), a valid gt with an empty mask,
masks off the 4 x 4 grid and padding slots.

* ``coord_channels`` bit for bit against the reference's under jit; the
  antialiased resize against ``jax.image.resize`` at the full config's
  ratios, down (P2-P6 to their grids) and up (P3-P5 to P2);
* ``dice_loss``, ``mask_iou_matrix`` and ``matrix_nms`` (gauss and linear);
* the head and mask-feature maps; the pooled masks, the targets and the
  loss's positives-first slate bit for bit; the loss and every gradient;
  R12 (the reference's loss breaks on the collate's bucketed masks);
* ``mask_extent_boxes``, ``crop_patches``; the decode on the model's
  outputs and on constructed maps, and the R3 pin: a candidate whose
  rescored score lies in (``update_thr``, ``score_thr``] is output by the
  reference and not by the port;
* the builder on ``configs/solov2_r50_fpn_coco.py`` and a full-width build
  whose parameter count is ``jax.eval_shape``'s, the entry points'
  dispatch, ``evaluate_detector(segm=True)`` against the reference's,
  ``tools.train`` with ``runtime.val_segm`` then ``tools.test --segm``, the
  seeded prior and a ``Trainer`` step.

Tolerances: the coordinates, pooled masks, targets, slate, IoUs of 0/1
masks, extent boxes and the decode's labels, validity and boxes exactly;
the resize 1e-6 and the maps 1e-5 of each map's largest value; the losses
rtol 1e-5; each gradient 1e-4 in relative norm of the difference; Matrix
NMS, dice and the decode's scores and patches 1e-6 of max(1, max |want|);
the crops of random probabilities 1e-5 (both sides' float32 sample
positions and hat weights lie 1.7e-6 from float64's).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import check_trainer_step, rel_norm
from test_torch_segm_eval import write_png_coco_masks
from test_torch_vgg import near, rel_close, seeded_variables
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.engine import validate as jax_validate
from torch_detection_tpu.models.detectors import SOLOV2 as JaxSOLOV2
from torch_detection_tpu.models.detectors import SOLOV2Config as JaxSOLOV2Config
from torch_detection_tpu.models.detectors import decode_solov2 as jax_decode_solov2
from torch_detection_tpu.models.detectors import solov2_loss as jax_solov2_loss
from torch_detection_tpu.models.detectors import solov2_targets as jax_solov2_targets
from torch_detection_tpu.models.detectors.solov2 import _crop_patches as jax_crop_patches
from torch_detection_tpu.models.detectors.solov2 import _downsample_masks as jax_downsample
from torch_detection_tpu.models.detectors.solov2 import _mask_extent_boxes as jax_extent_boxes
from torch_detection_tpu.models.heads.solov2_head import _coord_channels as jax_coord_channels
from torch_detection_tpu.models.heads.solov2_head import _resize_bilinear as jax_resize
from torch_detection_tpu.models.inits import bias_init_with_prob as jax_bias_init_with_prob
from torch_detection_tpu.ops import losses as jax_losses
from torch_detection_tpu.ops.nms import mask_iou_matrix as jax_mask_iou_matrix
from torch_detection_tpu.ops.nms import matrix_nms as jax_matrix_nms
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector, build_loss_fn
from torch_detection_tpu_torch.data import get_datasets
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.engine.validate import evaluate_detector
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    SOLOV2,
    SOLOV2Config,
    decode_solov2,
    solov2_loss,
    solov2_targets,
)
from torch_detection_tpu_torch.models.detectors.mask_rcnn import MaskDetections
from torch_detection_tpu_torch.models.detectors.solov2 import (
    crop_patches,
    downsample_masks,
    mask_extent_boxes,
)
from torch_detection_tpu_torch.models.heads.solov2_head import coord_channels, resize_bilinear
from torch_detection_tpu_torch.ops.losses import dice_loss
from torch_detection_tpu_torch.ops.nms import mask_iou_matrix, matrix_nms, top_k_stable
from torch_detection_tpu_torch.utils.config import Config

CONFIG = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs",
                      "solov2_r50_fpn_coco.py")
C, E = 3, 8
GRIDS = (12, 10, 8, 6, 4)
SCALES = ((1, 32), (16, 48), (32, 64), (48, 96), (64, 256))
MODEL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16, num_outs=5),
    head=dict(type="SOLOV2Head", num_classes=C, in_channels=16, feat_channels=16,
              kernel_channels=E, stacked_convs=2, grid_numbers=GRIDS, norm_groups=8),
    mask_feat_head=dict(type="MaskFeatHead", in_channels=16, feat_channels=16, out_channels=E,
                        num_inputs=4, norm_groups=8),
)
CFG_KW = dict(num_classes=C, grid_numbers=GRIDS, scale_ranges=SCALES, max_pos_cells=32,
              pre_nms_top_k=16, max_detections=8, mask_out_size=14)
CFG, JAX_CFG = SOLOV2Config(**CFG_KW), JaxSOLOV2Config(**CFG_KW)
CANVAS = (64, 96)
LOSS_KEYS = ("loss", "loss_cls", "loss_mask", "num_pos")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tt(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def gts():
    """Image 0: a gt whose mask is off the 4 x 4 grid, two of equal area
    and class-different whose centre regions overlap, padding; image 1: a
    large gt, a valid gt with an empty mask, a small one, padding."""
    boxes = np.zeros((2, 4, 4), np.float32)
    masks = np.zeros((2, 4, *CANVAS), np.uint8)
    boxes[0, :3] = [[9, 7, 41, 31], [50, 20, 74, 44], [52, 22, 76, 46]]
    masks[0, 0, 7:31, 9:41] = 1
    masks[0, 0, 7:10, 9:14] = 0
    masks[0, 1, 20:44, 50:74] = 1
    masks[0, 2, 22:46, 52:76] = 1
    boxes[1, :3] = [[10, 10, 90, 60], [2, 2, 20, 18], [60, 5, 80, 25]]
    masks[1, 0, 10:60, 10:90] = 1
    masks[1, 0, 30:60, 10:40] = 0  # an L: its mass centre is off the box centre
    masks[1, 2, 5:25, 60:80] = 1
    return dict(gt_boxes=boxes, gt_labels=np.array([[1, 2, 3, 0], [3, 1, 2, 0]], np.int32),
                gt_valid=np.array([[1, 1, 1, 0], [1, 1, 1, 0]], bool), gt_masks=masks)


def batch_of(rng):
    return dict(image=rng.normal(size=(2, *CANVAS, 3)).astype(np.float32), **gts())


def jax_targets(g):
    """The reference's pooled masks and targets of ``g``, under jit."""
    def one(b, lab, v, m):
        ds = jax_downsample(m, 4)
        return (ds,) + tuple(jax_solov2_targets(JAX_CFG, b, lab, v, ds, CANVAS))

    return [np.asarray(t) for t in jax.jit(jax.vmap(one))(
        *(jnp.asarray(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid", "gt_masks")))]


# ---------------------------------------------------------------- coordinates, resize


@pytest.mark.parametrize("hw", [(200, 336), (100, 168), (50, 84), (25, 42), (13, 21), (16, 24),
                                (1, 1), (7, 3)])
def test_coord_channels_match_the_reference_under_jit_bit_for_bit(hw):
    want = np.asarray(jax.jit(jax_coord_channels, static_argnums=(0, 1, 2))(*hw, jnp.float32))
    got = coord_channels(1, *hw, torch.float32, "cpu")[0].permute(1, 2, 0).numpy()
    assert got.shape == want.shape == (*hw, 2)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("src,dst", [
    ((200, 336), (40, 40)), ((100, 168), (36, 36)), ((50, 84), (24, 24)), ((25, 42), (16, 16)),
    ((13, 21), (12, 12)), ((100, 168), (200, 336)), ((50, 84), (200, 336)),
    ((25, 42), (200, 336)), ((13, 21), (16, 16))])
def test_resize_matches_jax_image_resize_at_the_config_ratios(rng, src, dst):
    """The full config's levels at 800 x 1344: each down to its grid (an
    antialiased triangle filter 5 and 8.4 px wide on P2), P3-P5 up to P2,
    and 13 x 21 to 16 (one axis up, one down)."""
    x = rng.normal(size=(1, *src, 3)).astype(np.float32)
    want = jax.jit(jax_resize, static_argnums=1)(jnp.asarray(x), dst)
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), dst)
    assert got.is_contiguous(memory_format=torch.channels_last)
    rel_close(got.permute(0, 2, 3, 1).numpy(), want, 1e-6)


# ---------------------------------------------------------------- dice, Matrix NMS


def test_dice_loss_matches_the_reference(rng):
    probs = rng.uniform(size=(2, 5, 40)).astype(np.float32)
    targets = (rng.uniform(size=(2, 5, 40)) > 0.6).astype(np.float32)
    weight = (rng.uniform(size=(2, 5)) > 0.3).astype(np.float32)
    for kw in (dict(), dict(weight=weight, avg_factor=3.0), dict(weight=weight, avg_factor=0.5)):
        want = jax_losses.dice_loss(jnp.asarray(probs), jnp.asarray(targets),
                                    **{k: jnp.asarray(v) for k, v in kw.items()})
        got = dice_loss(tt(probs), tt(targets), **{k: torch.as_tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def nms_case(rng, k=24, m=60):
    """Sorted scores, 0/1 masks with duplicates and empties, three classes,
    some invalid."""
    masks = (rng.uniform(size=(k, m)) > 0.5).astype(np.float32)
    masks[3] = masks[1]
    masks[7] = masks[1]
    masks[10] = 0.0
    labels = rng.integers(0, 3, k).astype(np.int32)
    labels[3] = labels[7] = labels[1]
    scores = np.sort(rng.uniform(0.05, 1.0, k).astype(np.float32))[::-1].copy()
    valid = scores > 0.2
    return masks, labels, scores, valid


def test_mask_iou_matrix_is_exact_and_matches_the_reference(rng):
    masks, *_ = nms_case(rng)
    got = mask_iou_matrix(tt(masks)).numpy()
    want = np.asarray(jax_mask_iou_matrix(jnp.asarray(masks)))
    np.testing.assert_array_equal(got, want)
    inter = masks @ masks.T  # counts, exact in float32
    union = masks.sum(1)[:, None] + masks.sum(1)[None] - inter
    np.testing.assert_array_equal(got, inter / np.maximum(union, 1e-6))
    batched = mask_iou_matrix(tt(np.stack([masks, masks[::-1]])))
    assert torch.equal(batched[0], torch.from_numpy(got))


@pytest.mark.parametrize("method", ["gauss", "linear"])
def test_matrix_nms_matches_the_reference(rng, method):
    masks, labels, scores, valid = nms_case(rng)
    want = jax_matrix_nms(*(jnp.asarray(a) for a in (masks, labels, scores, valid)),
                              method=method, sigma=2.0)
    got = matrix_nms(*(tt(a) for a in (masks, labels, scores, valid)), method=method, sigma=2.0)
    near(got.numpy(), want, 1e-6)
    assert float(got[3]) < float(tt(scores)[3]) and float(got[0]) == float(scores[0])


# ---------------------------------------------------------------- model, targets, loss


@pytest.fixture(scope="module")
def solo_setup():
    """Both detectors on the same seeded weights; from one jit of the JAX
    side its FPN levels, head outputs and mask features, its loss dict and
    the gradient into every parameter; the port's model, loss dict and
    gradients through ``build_loss_fn``."""
    rng = np.random.default_rng(11)
    batch = batch_of(rng)
    jax_model = JaxSOLOV2(**MODEL)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(batch["image"]))
    variables = seeded_variables(shapes, rng)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def stages(m, x):
        feats = m.neck_mod(m.backbone_mod(x))
        return feats, m.head_mod(feats), m.mask_feat_mod(feats)

    def loss(params):
        feats, (cls, kern), mfeat = jax_model.apply(
            {"params": params, "batch_stats": variables["batch_stats"]}, jbatch["image"],
            method=stages)
        out = jax_solov2_loss(JAX_CFG, cls, kern, mfeat, jbatch["gt_boxes"], jbatch["gt_labels"],
                              jbatch["gt_valid"], jbatch["gt_masks"])
        return out["loss"], (out, feats, cls, kern, mfeat)

    (_, (losses, *maps)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    model = SOLOV2(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    got_loss, got = build_loss_fn(model, CFG)({k: tt(v) for k, v in batch.items()})
    got["loss"] = got_loss
    got_loss.backward()
    return dict(model=model, batch=batch, variables=variables, got=got,
                want={k: float(v) for k, v in losses.items()},
                grads=from_jax_variables({"params": grads}, model),
                maps=jax.tree_util.tree_map(np.asarray, maps))


def test_levels_heads_and_mask_features_match_the_reference(solo_setup):
    model = solo_setup["model"]
    with torch.no_grad():
        feats = model.features(tt(solo_setup["batch"]["image"]))
        cls, kern, mfeat = model.heads(feats)
    want_feats, want_cls, want_kern, want_mfeat = solo_setup["maps"]
    for what, got, want in (("FPN", feats, want_feats), ("cls", cls, want_cls),
                            ("kernels", kern, want_kern), ("mask features", (mfeat,),
                                                           (want_mfeat,))):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, what
            rel_close(g.numpy(), w, 1e-5, what)
    assert [tuple(c.shape) for c in cls] == [(2, s, s, C) for s in GRIDS]
    assert tuple(mfeat.shape) == (2, 16, 24, E)


def test_targets_and_slate_match_bit_for_bit():
    g = gts()
    ds = downsample_masks(tt(g["gt_masks"]), 4)
    label0, gtidx = solov2_targets(CFG, tt(g["gt_boxes"]), tt(g["gt_labels"]),
                                   tt(g["gt_valid"]), ds, CANVAS)
    want_ds, want_label0, want_gtidx = jax_targets(g)
    np.testing.assert_array_equal(ds.numpy(), want_ds)
    np.testing.assert_array_equal(label0.numpy(), want_label0)
    np.testing.assert_array_equal(gtidx.numpy(), want_gtidx)
    pos = label0 >= 0
    flag, idx = top_k_stable(pos.float(), CFG.max_pos_cells)
    want_flag, want_idx = jax.lax.top_k(jnp.asarray(want_label0 >= 0, jnp.float32),
                                        CFG.max_pos_cells)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(flag.numpy(), np.asarray(want_flag))
    # the slate: every positive, in index order, then the negatives
    n = int(pos[0].sum())
    assert 0 < n < CFG.max_pos_cells and idx[0, :n].tolist() == torch.nonzero(pos[0])[:, 0].tolist()

    # each in-band gt with a mask is positive at its mass centre's cell
    offsets = np.cumsum([0] + [s * s for s in GRIDS])
    for b, gi, lvl in ((0, 0, 0), (0, 0, 1), (1, 0, 2), (1, 0, 3), (1, 2, 0)):
        m = want_ds[b, gi]
        ys, xs = np.nonzero(m)
        cy, cx = (ys + 0.5).mean() * 4, (xs + 0.5).mean() * 4
        s = GRIDS[lvl]
        cell = offsets[lvl] + int(cy / CANVAS[0] * s) * s + int(cx / CANVAS[1] * s)
        assert int(label0[b, cell]) >= 0, (b, gi, lvl)
    # the tied pair (equal areas): every cell both cover goes to the first; the
    # valid gt with an empty mask takes no cell
    assert (gtidx[0][pos[0]] != 2).any() and not bool(((gtidx[1] == 1) & pos[1]).any())
    assert 1 in gtidx[0][pos[0]].tolist()


def test_solov2_loss_and_every_gradient_match(solo_setup):
    got, want = solo_setup["got"], solo_setup["want"]
    assert set(got) == set(LOSS_KEYS) and want["num_pos"] > 0
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=1e-5, err_msg=k)
    for name, p in solo_setup["model"].named_parameters():
        if p.requires_grad:
            assert rel_norm(p.grad.numpy(), solo_setup["grads"][name].numpy()) <= 1e-4, name


def test_r12_the_reference_loss_breaks_on_bucketed_masks(solo_setup):
    """The collate pads ``gt_masks`` to a bucket of fewer rows than
    ``max_gts`` (the valid gts first). The reference's loss broadcasts its
    (G,) gts against the (G_mask,) masks and raises; the port takes the
    gts up to the masks' count, which gives the loss of the gts cut to
    that count."""
    maps = solo_setup["maps"]
    g = gts()
    padded = {k: np.concatenate([v, np.zeros((2, 4) + v.shape[2:], v.dtype)], axis=1)
              for k, v in g.items() if k != "gt_masks"}
    outs = (maps[1], maps[2], maps[3])
    with pytest.raises((TypeError, ValueError)):
        jax_solov2_loss(JAX_CFG, *outs, *(jnp.asarray(padded[k]) for k in
                                          ("gt_boxes", "gt_labels", "gt_valid")),
                        jnp.asarray(g["gt_masks"]))
    touts = ([tt(x) for x in maps[1]], [tt(x) for x in maps[2]], tt(maps[3]))
    got = solov2_loss(CFG, *touts, *(tt(padded[k]) for k in ("gt_boxes", "gt_labels",
                                                              "gt_valid")), tt(g["gt_masks"]))
    want = solov2_loss(CFG, *touts, *(tt(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid",
                                                         "gt_masks")))
    for k in LOSS_KEYS:
        assert torch.equal(got[k], want[k]), k


# ---------------------------------------------------------------- decode


def test_mask_extent_boxes_and_crops_match_the_reference(rng):
    binary = (rng.uniform(size=(6, 16, 24)) > 0.97).astype(np.float32)
    binary[2] = 0.0
    binary[4, 3:9, 5:20] = 1.0
    probs = rng.uniform(size=(6, 16, 24)).astype(np.float32)
    want_boxes = np.asarray(jax_extent_boxes(jnp.asarray(binary), 4))
    got_boxes = mask_extent_boxes(tt(binary)[None], 4)[0].numpy()
    np.testing.assert_array_equal(got_boxes, want_boxes)
    assert (got_boxes[2] == 0).all()
    boxes = np.concatenate([want_boxes, [[3.5, 2.0, 3.5, 50.0], [80, 40, 95, 63]]])[:6]
    want = jax.jit(jax_crop_patches, static_argnums=(2, 3))(jnp.asarray(probs),
                                                            jnp.asarray(boxes), 4, 14)
    got = crop_patches(tt(probs)[None], tt(boxes)[None].float(), 4, 14)[0]
    # float32's sample positions and hat weights: both sides lie 1.7e-6 from float64's
    near(got.numpy(), want, 1e-5)


def check_decode(got, want, what=""):
    assert isinstance(got, MaskDetections)
    for field in ("valid", "labels", "boxes"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=what + field)
    near(got.scores.numpy(), want.scores, 1e-6, what + "scores")
    near(got.mask_probs.numpy(), want.mask_probs, 1e-6, what + "patches")


def test_decode_on_the_models_outputs_matches_the_reference(solo_setup):
    """The decode of the seeded model's maps, ``score_thr`` equal to
    ``update_thr`` so that no candidate lies in R3's band."""
    kw = dict(CFG_KW, score_thr=0.05, update_thr=0.05, mask_thr=0.5)
    _, cls, kern, mfeat = solo_setup["maps"]
    shapes, scale = np.array([[64, 96], [50, 80]], np.float32), np.array([1.0, 2.0], np.float32)
    want = jax.jit(functools.partial(jax_decode_solov2, JaxSOLOV2Config(**kw)))(
        cls, kern, mfeat, img_shapes=jnp.asarray(shapes), scale_factors=jnp.asarray(scale))
    got = decode_solov2(SOLOV2Config(**kw), [tt(c) for c in cls], [tt(k) for k in kern],
                        tt(mfeat), tt(shapes), tt(scale))
    check_decode(got, want)
    assert int(got.valid.sum()) >= 4


def constructed_maps(r3: bool):
    """Maps whose masks are rectangles: mask channel j is +1 inside
    rectangle j and -1 outside; a chosen cell's kernel is 8 times a one-hot
    of its rectangle (mask probabilities 0.9997 in, 0.0003 out), every other
    kernel 0 (probabilities exactly 0.5: an empty mask). Same-class
    overlapping rectangles decay each other; with ``r3`` one candidate
    scores 0.08 (``update_thr`` 0.05 < 0.08 <= ``score_thr`` 0.1)."""
    rects = [(1, 9, 2, 12), (2, 10, 4, 14), (5, 15, 10, 22), (0, 4, 18, 24), (9, 15, 1, 6)]
    mfeat = -np.ones((1, 16, 24, E), np.float32)
    for j, (y0, y1, x0, x1) in enumerate(rects):
        mfeat[0, y0:y1, x0:x1, j] = 1.0
    cls = [np.full((1, s, s, C), -6.0, np.float32) for s in GRIDS]
    kern = [np.zeros((1, s, s, E), np.float32) for s in GRIDS]
    picks = [(0, 2, 3, 1, 3.0, 0), (0, 3, 4, 1, 2.0, 1), (1, 5, 5, 0, 2.5, 2),
             (2, 1, 6, 2, 1.5, 3), (3, 4, 1, 2, 1.0, 1)]
    if r3:
        picks.append((1, 8, 2, 0, float(np.log(0.08 / 0.92)), 4))
    for lvl, i, j, c, logit, rect in picks:
        cls[lvl][0, i, j, c] = logit
        kern[lvl][0, i, j, rect] = 8.0
    return cls, kern, mfeat


@pytest.mark.parametrize("r3", [False, True])
def test_decode_on_constructed_maps_and_the_r3_pin(r3):
    cls, kern, mfeat = constructed_maps(r3)
    shapes = np.array([[64, 96]], np.float32)
    want = jax.jit(functools.partial(jax_decode_solov2, JAX_CFG))(
        cls, kern, mfeat, img_shapes=jnp.asarray(shapes))
    got = decode_solov2(CFG, [tt(c) for c in cls], [tt(k) for k in kern], tt(mfeat), tt(shapes))
    n = 5
    assert int(got.valid.sum()) == n and bool(got.valid[0, :n].all())
    if not r3:
        check_decode(got, want)
        return
    # the reference outputs the candidate under score_thr; the port drops it
    assert int(np.asarray(want.valid).sum()) == n + 1
    extra = np.asarray(want.scores)[0]
    assert any(0.05 < s <= 0.1 for s in extra[np.asarray(want.valid)[0]])
    keep = np.asarray(want.scores)[0] > 0.1
    np.testing.assert_array_equal(got.labels[0, :n].numpy(), np.asarray(want.labels)[0][keep])
    near(got.scores[0, :n].numpy(), np.asarray(want.scores)[0][keep], 1e-6)
    assert not bool(((got.scores > 0.05) & (got.scores <= 0.1)).any())


# ---------------------------------------------------------------- entry points, configs


def test_inference_entry_points(solo_setup):
    """``make_inference_fn(segm=True)`` is the decode on the model's maps;
    the box route its boxes, scores, labels and validity."""
    model = solo_setup["model"].eval()
    image = tt(solo_setup["batch"]["image"])
    shapes, scale = torch.tensor([[64.0, 96.0], [50.0, 80.0]]), torch.ones(2)
    masks = make_inference_fn(model, CFG, segm=True)(image, shapes, scale)
    boxes = make_inference_fn(model, CFG)(image, shapes, scale)
    with torch.no_grad():
        want = decode_solov2(CFG, *model(image), shapes, scale)
    for g, w in zip(masks, want, strict=True):
        assert torch.equal(g, w)
    for field in ("boxes", "scores", "labels", "valid"):
        assert torch.equal(getattr(boxes, field), getattr(want, field)), field
    assert boxes.indices is None
    model.train()


def test_evaluate_detector_segm_equals_the_reference(tmp_path):
    """Both ``evaluate_detector(segm=True)`` on the same seeded weights (the
    kernel output scaled so that few mask pixels sit near 0.5) over a tiny
    PNG COCO set with polygon and RLE masks, b2 on a 64 x 64 canvas,
    ``score_thr`` equal to ``update_thr`` (no candidate in R3's band)."""
    coco = write_png_coco_masks(tmp_path)
    rng = np.random.default_rng(4)
    model_cfg = dict(MODEL, head=dict(MODEL["head"], num_classes=2))
    jax_model = JaxSOLOV2(**model_cfg)
    variables = seeded_variables(
        jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3))), rng)
    kernel_out = variables["params"]["head"]["kernel_out"]
    kernel_out["kernel"] = np.asarray(kernel_out["kernel"]) * 20.0
    kw = dict(CFG_KW, num_classes=2, score_thr=0.05, update_thr=0.05)
    model = SOLOV2(**model_cfg, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    dataset = get_datasets(dict(type="CocoDataset", ann_file=coco["ann_file"],
                                img_prefix=coco["img_prefix"], img_means=(0, 0, 0),
                                img_stds=(255, 255, 255), img_expected_sizes=(64, 48),
                                size_divisor=32, test_mode=True, with_mask=True))
    got, got_dets = evaluate_detector(model, SOLOV2Config(**kw), dataset, batch=2,
                                      canvas=(64, 64), return_detections=True, segm=True)
    want, want_dets = jax_validate.evaluate_detector(
        jax_model, JaxSOLOV2Config(**kw), variables, dataset, batch=2, canvas=(64, 64),
        return_detections=True, segm=True)
    assert set(got) == set(want) and len(got) == 24
    for key in sorted(got):
        assert abs(got[key] - want[key]) <= 1e-6, key
    for g, w in zip(got_dets, want_dets, strict=True):
        assert len(g["masks"]) == len(w["masks"]) == len(g["scores"]) > 0
        np.testing.assert_array_equal(g["labels"], w["labels"])
        np.testing.assert_allclose(g["boxes"], w["boxes"], atol=1e-4)
        np.testing.assert_allclose(g["scores"], w["scores"], atol=1e-6)


def write_cli_config(path, coco) -> str:
    """The SOLOv2 config with the tiny model and the PNG set: b2 on 64 x 64,
    ``max_gts`` 16 (the collate's masks bucket to 8 rows: R12), validation
    with the mask metrics after each epoch."""
    ann, prefix = coco["ann_file"], coco["img_prefix"]
    model = dict(MODEL, type="SOLOV2", head=dict(MODEL["head"], num_classes=2))
    det = dict(CFG_KW, num_classes=2, score_thr=0.0, update_thr=0.0)
    path.write_text(f"""_base_ = {os.path.abspath(CONFIG)!r}
model = dict(_delete_=True, **{model!r})
detection = dict(_delete_=True, style="solov2", **{det!r})
data = dict(
    train=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    val=dict(ann_file={ann!r}, img_prefix={prefix!r}, img_expected_sizes=(64, 48)),
    sample_per_replica=2, max_gts=16, canvas=(64, 64),
)
schedule = dict(warmup_steps=2)
runtime = dict(compute_dtype="float32", log_interval=1, val_interval_epochs=1, val_batch=2)
""")
    return str(path)


def test_train_with_val_segm_then_test_segm(tmp_path):
    """``tools.train`` (one epoch of the masked PNG set, validation with the
    mask metrics from the config's ``runtime.val_segm``), then ``tools.test
    --segm --out``: 24 metrics, each segm RLE at its image's size."""
    from torch_detection_tpu_torch.data.ops.mask import rle_decode
    from torch_detection_tpu_torch.tools import test as test_cli
    from torch_detection_tpu_torch.tools import train as train_cli

    coco = write_png_coco_masks(tmp_path)
    config = write_cli_config(tmp_path / "solov2.py", coco)
    work = tmp_path / "work"
    trainer = train_cli.main([config, "--epochs", "1", "--work-dir", str(work), "--device", "cpu"])
    records = [json.loads(line) for line in (work / "metrics.jsonl").read_text().splitlines()]
    steps = [r for r in records if "loss" in r]
    vals = [r for r in records if "val_mAP" in r]
    assert len(steps) == len(trainer.dataloader) and vals
    assert all(np.isfinite(r[k]) for r in steps for k in LOSS_KEYS)
    assert "val_segm_mAP" in vals[0] and len(vals[0]) == 25  # the epoch and 24 metrics
    out = tmp_path / "res.json"
    metrics = test_cli.main([config, str(work / "epoch_1"), "--segm", "--out", str(out),
                             "--device", "cpu"])
    assert len(metrics) == 24 and all(np.isfinite(v) for v in metrics.values())
    segm = json.loads((tmp_path / "res.segm.json").read_text())
    sizes = {info["id"]: [info["height"], info["width"]]
             for info in json.loads(open(coco["ann_file"]).read())["images"]}
    assert segm and all(list(rle_decode(r["segmentation"]).shape) == sizes[r["image_id"]]
                        for r in segm)


def test_seeded_init_gives_the_prior_and_a_trainer_step(solo_setup):
    model = build_detector(dict(MODEL, type="SOLOV2"), "float32", device="cpu")
    prior = float(np.float32(jax_bias_init_with_prob(0.01)))
    assert bool((model.head.cls_out.bias == prior).all())
    assert bool((model.head.kernel_out.bias == 0).all())
    history = check_trainer_step(model, CFG, solo_setup["batch"], LOSS_KEYS[:-1])
    assert history["num_pos"] == solo_setup["want"]["num_pos"]


def test_config_matches_the_reference_and_refuses_approx_top_k():
    cfg = Config.fromfile(CONFIG)
    got, want = build_detection_cfg(cfg.detection), jax_builder.build_detection_cfg(
        dict(cfg.detection))
    assert isinstance(got, SOLOV2Config)
    for field in ("num_classes", "grid_numbers", "scale_ranges", "sigma", "mask_stride",
                  "focal_gamma", "focal_alpha", "dice_weight", "max_pos_cells", "score_thr",
                  "update_thr", "mask_thr", "pre_nms_top_k", "max_detections", "nms_method",
                  "nms_sigma", "mask_out_size"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.num_cells == 3872 and cfg.data.canvas == (800, 1344)
    assert cfg.data.train.with_mask and cfg.runtime.val_segm
    with pytest.raises(NotImplementedError, match="approx_top_k"):
        build_detection_cfg(dict(cfg.detection, approx_top_k=True))


def test_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    jax_model = JaxSOLOV2(**{k: v for k, v in cfg.model.items() if k != "type"})
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model.load_state_dict(from_jax_variables(zeros, model), strict=True)
    count = sum(p.numel() for p in model.parameters())
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    assert count == 33_258_768
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
