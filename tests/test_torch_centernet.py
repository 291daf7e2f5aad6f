"""The port's CenterNet (ResNet-18, deconvolution neck) against the JAX package's.

The detector is ResNet-18 to C5 (FrozenBN, the plain 7 x 7 stem; the trunk
has no width knob), the neck's deconvolutions narrowed to (32, 16, 8) and
the head's branches to 8, 8 classes, on a 128 x 128 canvas (a 32 x 32
stride-4 map), b2; FrozenBN's statistics and affine, every bias and every
kernel drawn from a numpy seed, carried by ``from_jax_variables`` with
``strict=True``. The gts include two of one class whose Gaussians overlap,
one whose centre lies past the canvas (clipped to the last cell), one too
small for a radius, and padding slots.

* flax's 4 x 4 stride-2 ``ConvTranspose`` against the converted
  ``ConvTranspose2d``;
* the trunk, neck and head; ``centernet_loss`` and the gradient into every
  parameter;
* ``gaussian_radius``; ``centernet_targets`` against the reference and bit
  for bit against a NumPy transcription of its one-gt-at-a-time fold;
* ``decode_centernet`` on logits with plateaus (blocks of equal logits)
  and ties across the top-k cut;
* the seeded init's prior, a ``Trainer`` step, the config through the
  builder, a full-width build whose parameter count equals
  ``jax.eval_shape``'s (14 219 092).

Tolerances: the targets' centre cells, offsets, sizes, masks, peak set and
zero set exactly, their Gaussian values within 2e-6 relative of the
reference's (XLA computes sigma's division by 6 as a product by 1/6, and
its float32 exp is within an ulp of the correctly rounded one the port
takes) and bit for bit against the NumPy fold; the decode's indices, labels
and validity exactly; features and head outputs 1e-5 relative to each map's
largest value; radii, the decode's scores and boxes 1e-6 of max(1,
max |want|); losses rtol 1e-5; each parameter's gradient 1e-4 in relative
norm of the difference from the reference's and from the port's own
float64 evaluation, except that a trunk parameter below C4 may part from
the reference's by up to 2e-3: a ReLU input that the reference's float32
forward rounds across 0 sends its gradient the other way (the port's
float32 gradients stay within 1e-5 of float64 there, the reference's part
by up to 1.1e-3).
"""

import copy
import functools
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_fcos import check_trainer_step, rel_norm
from test_torch_ssd import check_reference_tree
from test_torch_vgg import near, rel_close, seeded_variables
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import CenterNetConfig as JaxCenterNetConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import centernet_loss as jax_centernet_loss
from torch_detection_tpu.models.detectors import decode_centernet as jax_decode_centernet
from torch_detection_tpu.models.detectors.centernet import centernet_targets as jax_targets
from torch_detection_tpu.models.detectors.centernet import gaussian_radius as jax_gaussian_radius
from torch_detection_tpu.models.inits import bias_init_with_prob as jax_bias_init_with_prob
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector, build_loss_fn
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    CenterNetConfig,
    SingleStageDetector,
    centernet_targets,
    decode_centernet,
)
from torch_detection_tpu_torch.models.detectors.centernet import centernet_peaks, gaussian_radius
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
C = 8
MODEL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,),
                  norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="CTResNetNeck", in_channels=512, num_deconv_filters=(32, 16, 8)),
    head=dict(type="CenterNetHead", num_classes=C, in_channels=8, feat_channels=8),
)
CFG = CenterNetConfig(num_classes=C)
JAX_CFG = JaxCenterNetConfig(num_classes=C)
CANVAS = (128, 128)
MAP = (32, 32)
LOSS_KEYS = ("loss", "loss_heatmap", "loss_wh", "loss_offset", "num_pos")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gts():
    """Image 0: two class-3 gts whose Gaussians overlap, one whose centre
    lies past the canvas (clipped to the map's last cell), one too small for
    a radius, a padding slot; image 1: two gts and stale padding."""
    boxes = np.zeros((2, 5, 4), np.float32)
    boxes[0] = [[10, 12, 60, 70], [20, 18, 74, 66], [118, 120, 142, 140], [40, 90, 42, 91],
                [0, 0, 0, 0]]
    boxes[1] = [[5, 30, 90, 100], [60, 4, 120, 50], [1, 1, 9, 9], [3, 3, 20, 30], [0, 0, 0, 0]]
    return dict(gt_boxes=boxes,
                gt_labels=np.array([[3, 3, 8, 1, 0], [2, 5, 7, 4, 0]], np.int32),
                gt_valid=np.array([[True, True, True, True, False],
                                   [True, True, False, False, False]]))


def batch_of(rng):
    return dict(image=rng.normal(size=(2, *CANVAS, 3)).astype(np.float32), **gts())


def tg(batch, *keys):
    return [torch.from_numpy(np.asarray(batch[k])) for k in keys]


# ---------------------------------------------------------------- the transposed conv


@pytest.mark.parametrize("hw", [(4, 4), (5, 7), (16, 16)])
def test_transposed_conv_matches_flax(rng, hw):
    """flax's ``ConvTranspose(ch, (4, 4), strides=(2, 2), padding="SAME")``
    is ``ConvTranspose2d(ch, ch, 4, stride=2, padding=1)`` on the flipped
    kernel, which ``from_jax_variables`` gives."""
    x = rng.normal(size=(2, *hw, 6)).astype(np.float32)
    flax_up = fnn.ConvTranspose(5, (4, 4), strides=(2, 2), padding="SAME", use_bias=False)
    variables = {"params": {"up": {"kernel": rng.normal(size=(4, 4, 6, 5)).astype(np.float32)}}}
    want = flax_up.apply({"params": variables["params"]["up"]}, jnp.asarray(x))
    model = nn.ModuleDict({"up": nn.ConvTranspose2d(6, 5, 4, stride=2, padding=1, bias=False)})
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    with torch.no_grad():
        got = model["up"](torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert got.shape == want.shape == (2, 2 * hw[0], 2 * hw[1], 5)
    near(got.numpy(), want, 1e-5)


# ---------------------------------------------------------------- model, loss, gradients


@pytest.fixture(scope="module")
def centernet_setup():
    """Both detectors on the same seeded weights; from one jit of the JAX
    side its C5, neck and head outputs, its loss dict and the gradient into
    every parameter; the port's model, its loss dict and gradients through
    ``build_loss_fn``."""
    rng = np.random.default_rng(13)
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
        out = jax_centernet_loss(JAX_CFG, *outs, jbatch["gt_boxes"], jbatch["gt_labels"],
                                 jbatch["gt_valid"])
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
    # the port's own float64 evaluation, which the trunk's gradients are also held to
    model64 = copy.deepcopy(model).double()
    model64.dtype = model64.param_dtype = torch.float64
    model64.zero_grad()
    tbatch["image"] = tbatch["image"].double()
    build_loss_fn(model64, CFG)(tbatch)[0].backward()
    return dict(model=model, batch=batch, got=got,
                want={k: float(v) for k, v in losses.items()},
                grads=from_jax_variables({"params": grads}, model),
                grads64={n: p.grad.numpy() for n, p in model64.named_parameters()},
                stages=[jax.tree_util.tree_map(np.asarray, t) for t in (feats, necks, outs)])


def test_trunk_neck_and_head_match_the_reference(centernet_setup):
    model = centernet_setup["model"]
    x = torch.from_numpy(centernet_setup["batch"]["image"])
    with torch.no_grad():
        feats = model.backbone(x)
        necks = model.neck(feats)
        outs = model.head(necks)
    want_feats, want_necks, want_outs = centernet_setup["stages"]
    for what, got, want in (("C5", feats, want_feats), ("neck", necks, want_necks),
                            ("head", outs, want_outs)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape, what
            rel_close(g.numpy(), w, 1e-5, what)
    assert tuple(feats[0].shape) == (2, 4, 4, 512)
    assert [tuple(o.shape) for o in outs] == [(2, *MAP, C), (2, *MAP, 2), (2, *MAP, 2)]


def test_centernet_loss_and_every_gradient_match(centernet_setup):
    got, want = centernet_setup["got"], centernet_setup["want"]
    assert set(got) == set(LOSS_KEYS) and want["num_pos"] == 3.0  # 6 valid gts over 2 images
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(got[k].detach()), want[k], rtol=1e-5, err_msg=k)
    kinked = []
    for name, p in centernet_setup["model"].named_parameters():
        err = rel_norm(p.grad.numpy(), centernet_setup["grads"][name].numpy())
        if err > 1e-4:
            # below C4 a ReLU input within the reference's float32 rounding of 0 can
            # take the other side of the kink there: such a trunk gradient is held to
            # the port's float64 evaluation, and near the reference's
            assert name.startswith(("backbone.stem.", "backbone.layer1_", "backbone.layer2_")), name
            assert err <= 2e-3 and rel_norm(p.grad.numpy(),
                                            centernet_setup["grads64"][name]) <= 1e-4, name
            kinked.append(name)
        assert rel_norm(p.grad.numpy(), centernet_setup["grads64"][name]) <= 1e-4, name
    assert len(kinked) < 40


# ---------------------------------------------------------------- targets


def test_gaussian_radius_matches_the_reference(rng):
    h = rng.uniform(0.1, 200, 4000).astype(np.float32)
    w = rng.uniform(0.1, 200, 4000).astype(np.float32)
    for overlap in (0.3, 0.7):
        want = jax_gaussian_radius(jnp.asarray(h), jnp.asarray(w), overlap)
        near(gaussian_radius(torch.from_numpy(h), torch.from_numpy(w), overlap).numpy(), want,
             1e-6)


def numpy_fold(cfg, featmap_size, boxes, labels, valid) -> np.ndarray:
    """The reference's ``centernet_targets`` heatmap in NumPy float32: one
    gt at a time max-folded into (H, W, C), its exp in float64 rounded to
    float32 (correctly rounded)."""
    hh, ww = featmap_size
    f = np.float32
    dr = f(cfg.down_ratio)
    w_f = (boxes[:, 2] - boxes[:, 0] + f(1)) / dr
    h_f = (boxes[:, 3] - boxes[:, 1] + f(1)) / dr
    cx_i = np.clip(np.floor(f(0.5) * (boxes[:, 0] + boxes[:, 2]) / dr), 0, ww - 1)
    cy_i = np.clip(np.floor(f(0.5) * (boxes[:, 1] + boxes[:, 3]) / dr), 0, hh - 1)
    mask = valid & (w_f > 0) & (h_f > 0)
    # the reference's expressions, its Python scalars rounded to float32 at use
    mo = cfg.min_overlap
    b1, c1 = h_f + w_f, w_f * h_f * (1.0 - mo) / (1.0 + mo)
    r1 = (b1 - np.sqrt(np.maximum(b1 * b1 - 4.0 * c1, 0.0))) / 2.0
    b2, c2 = 2.0 * (h_f + w_f), (1.0 - mo) * w_f * h_f
    r2 = (b2 - np.sqrt(np.maximum(b2 * b2 - 4.0 * 4.0 * c2, 0.0))) / (2.0 * 4.0)
    a3, b3, c3 = 4.0 * mo, -2.0 * mo * (h_f + w_f), (mo - 1.0) * w_f * h_f
    r3 = (b3 + np.sqrt(np.maximum(b3 * b3 - 4.0 * a3 * c3, 0.0))) / (2.0 * a3)
    radius = np.floor(np.maximum(np.minimum(np.minimum(r1, r2), r3), f(0)))
    sigma = (f(2) * radius + f(1)) / f(6)
    heat = np.zeros((hh, ww, cfg.num_classes), np.float32)
    for g in range(len(boxes)):
        dx = np.arange(ww, dtype=np.float32) - cx_i[g]
        dy = np.arange(hh, dtype=np.float32) - cy_i[g]
        arg = -(dx[None, :] ** 2 + dy[:, None] ** 2) / (f(2) * sigma[g] ** 2 + f(1e-12))
        g2d = np.exp(arg.astype(np.float64)).astype(np.float32)
        window = (np.abs(dx)[None, :] <= radius[g]) & (np.abs(dy)[:, None] <= radius[g])
        if mask[g] and 1 <= labels[g] <= cfg.num_classes:
            c = labels[g] - 1
            heat[:, :, c] = np.maximum(heat[:, :, c], np.where(window, g2d, f(0)))
    return heat


def test_targets_match_the_reference_and_its_fold_bit_for_bit():
    g = gts()
    got = centernet_targets(CFG, MAP, *tg(g, "gt_boxes", "gt_labels", "gt_valid"))
    want = jax.jit(jax.vmap(functools.partial(jax_targets, JAX_CFG, MAP)))(
        *(jnp.asarray(g[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")))
    heat, want_heat = got.heat.numpy(), np.asarray(want[0])
    for field, w in zip(("wh", "offset", "ind", "mask"), want[1:]):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(w), err_msg=field)
    np.testing.assert_array_equal(heat == 0, want_heat == 0)
    np.testing.assert_array_equal(heat == 1, want_heat == 1)
    # XLA computes sigma's (2 r + 1) / 6 as a product by 1/6, an ulp off the quotient
    # for some radii, which the exp carries |exponent| times
    np.testing.assert_allclose(heat, want_heat, rtol=2e-6, atol=0)
    for i in range(2):
        np.testing.assert_array_equal(heat[i], numpy_fold(CFG, MAP, g["gt_boxes"][i],
                                                          g["gt_labels"][i], g["gt_valid"][i]))
    # image 0: the class-3 pair overlaps (cells where the second's Gaussian wins), the
    # corner gt's centre is clipped to the last cell, the tiny gt has radius 0
    assert (heat[0] == 1).sum() == 4 and heat[0, 31, 31, 7] == 1
    assert ((heat[0, :, :, 0] > 0).sum()) == 1
    assert got.mask.sum() == 6


# ---------------------------------------------------------------- decode


def plateau_logits(rng):
    """Logits on a grid of quarters (many equal scores, ties across the top
    100) with 3 x 3 and 2 x 4 blocks of equal high logits (plateaus: every
    cell of one is its own 3 x 3 maximum)."""
    heat = (np.round(rng.normal(-1, 1.5, (2, *MAP, C)) * 4) / 4).astype(np.float32)
    heat[0, 5:8, 9:12, 2] = 6.0
    heat[0, 20:22, 3:7, 5] = 6.0
    heat[1, 0:3, 29:32, 0] = 5.5
    return heat


def test_decode_centernet_on_plateaus_matches_the_reference(rng):
    heat = plateau_logits(rng)
    wh = rng.uniform(1, 12, (2, *MAP, 2)).astype(np.float32)
    off = rng.uniform(0, 1, (2, *MAP, 2)).astype(np.float32)
    shapes, scale = np.array([[128, 128], [96, 128]], np.float32), np.array([0.5, 2.0], np.float32)
    want = jax.jit(functools.partial(jax_decode_centernet, JAX_CFG))(
        jnp.asarray(heat), jnp.asarray(wh), jnp.asarray(off), img_shapes=jnp.asarray(shapes),
        scale_factors=jnp.asarray(scale))
    got = decode_centernet(CFG, torch.from_numpy(heat), torch.from_numpy(wh),
                           torch.from_numpy(off), torch.from_numpy(shapes),
                           torch.from_numpy(scale))
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    near(got.scores.numpy(), want.scores, 1e-6, "scores")
    near(got.boxes.numpy(), want.boxes, 1e-6, "boxes")
    # the plateaus lead, every cell of each kept, in NHWC order; the cut ties
    assert got.indices[0, :17].tolist() == sorted(got.indices[0, :17].tolist())
    assert got.labels[0, :17].tolist() == [2] * 9 + [5] * 8
    assert got.labels[1, :9].tolist() == [0] * 9
    peaks = centernet_peaks(torch.from_numpy(heat)).sort(dim=1, descending=True).values
    assert bool((peaks[:, 99] == peaks[:, 100]).all())


def test_inference_entry_point(centernet_setup):
    """``make_inference_fn`` reaches ``decode_centernet`` on the model's outputs."""
    model = centernet_setup["model"].eval()
    image, shapes = torch.from_numpy(centernet_setup["batch"]["image"]), torch.tensor(
        [[128.0, 128.0], [100.0, 120.0]])
    got = make_inference_fn(model, CFG)(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_centernet(CFG, *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)
    model.train()


# ---------------------------------------------------------------- init, training, configs


def test_seeded_init_gives_the_prior():
    model = build_detector(dict(MODEL, type="SingleStageDetector"), "float32", device="cpu")
    prior = float(np.float32(jax_bias_init_with_prob(0.1)))
    assert bool((model.head.heatmap_out.bias == prior).all()) and round(prior, 3) == -2.197
    for name in ("wh_out", "offset_out", "heatmap_feat"):
        assert bool((getattr(model.head, name).bias == 0).all()), name


def test_trainer_step():
    model = build_detector(dict(MODEL, type="SingleStageDetector"), "float32", device="cpu")
    check_trainer_step(model, CFG, batch_of(np.random.default_rng(5)), LOSS_KEYS[:-1])


def test_config_matches_the_reference():
    cfg = Config.fromfile(os.path.join(CONFIGS, "centernet_r18_coco.py"))
    got, want = build_detection_cfg(cfg.detection), jax_builder.build_detection_cfg(
        dict(cfg.detection))
    assert isinstance(got, CenterNetConfig)
    for field in ("num_classes", "down_ratio", "min_overlap", "heat_weight", "wh_weight",
                  "off_weight", "score_thr", "max_detections", "nms_iou_thr"):
        assert getattr(got, field) == getattr(want, field), field
    # the base's SGD at the config's lr (its comment speaks of Adam; it sets no type)
    assert cfg.optimizer.get("type", "sgd") == "sgd" and cfg.optimizer["lr"] == 5e-4


def test_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch):
    cfg = Config.fromfile(os.path.join(CONFIGS, "centernet_r18_coco.py"))
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert check_reference_tree(cfg.model, model, 64) == 14219092
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")
