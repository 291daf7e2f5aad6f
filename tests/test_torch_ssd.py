"""The port's SSD300 and SSD512 against the JAX package's.

* the ``SSDVGG`` trunk at full width (it has no width knob), b1 on 300 x 300
  and on 512 x 512: every map, on weights carried by ``from_jax_variables``
  with ``strict=True``; ``L2Norm``; the head (a narrow one, C = 4);
* the anchors: 8 732 and 24 564, equal to the reference's bit for bit;
* ``ssd_loss`` and its gradients into every head output on a padded canvas:
  image 1 is a 640 x 480 picture on the 300 canvas (75 rows of padding), and
  the anchors over the padding have equal outputs, so their
  cross-entropies tie exactly and a tie group straddles the 3:1 mining cut;
  the gradient's support is the kept set, so equal gradients mean the same
  anchors kept (the lower index first, XLA's order); R11: padding anchors
  among the kept negatives on both sides;
* ``decode_ssd``; ``make_inference_fn``; the committed configs through the
  builder against an ``SSDConfig`` written from the files' values, R1 (the
  reference's builder raises ``UnboundLocalError`` on them); full-width
  builds whose parameter counts equal ``jax.eval_shape``'s; a ``Trainer``
  step.

Tolerances: trunk maps 1e-4 relative to each map's largest value; L2Norm
and the head 1e-5 of max(1, max |want|); anchors exactly; losses rtol 1e-5;
gradients 1e-5 relative to their largest value, their zero patterns exactly;
the decode exactly in its indices, labels and validity, scores and boxes
1e-6 of max(1, max |want|).
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_fcos import check_trainer_step
from test_torch_vgg import near, rel_close, seeded_variables
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.backbones import SSDVGG as JaxSSDVGG
from torch_detection_tpu.models.backbones.ssd_vgg import L2Norm as JaxL2Norm
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import SSDConfig as JaxSSDConfig
from torch_detection_tpu.models.detectors import decode_ssd as jax_decode_ssd
from torch_detection_tpu.models.detectors import ssd_loss as jax_ssd_loss
from torch_detection_tpu.models.heads import SSDHead as JaxSSDHead
from torch_detection_tpu.ops.anchors import SSDAnchorGenerator as JaxSSDAnchorGenerator
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.backbones import SSDVGG, L2Norm
from torch_detection_tpu_torch.models.detectors import SSDConfig, decode_ssd, ssd_loss
from torch_detection_tpu_torch.models.detectors.ssd import (
    cross_entropy,
    flatten_ssd_outputs,
    hard_negatives,
    ssd_targets,
)
from torch_detection_tpu_torch.models.heads import SSDHead
from torch_detection_tpu_torch.ops.anchors import SSDAnchorGenerator
from torch_detection_tpu_torch.ops.assign import MaxIoUAssigner
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")
SIZES = {300: [(38, 38), (19, 19), (10, 10), (5, 5), (3, 3), (1, 1)],
         512: [(64, 64), (32, 32), (16, 16), (8, 8), (4, 4), (2, 2), (1, 1)]}
COUNTS = {300: 8732, 512: 24564}
C = 4  # foreground classes of the narrow head
CFG, JAX_CFG = SSDConfig(num_classes=C), JaxSSDConfig(num_classes=C)
IMG_SHAPES = np.array([[300, 300], [225, 300]], np.float32)  # image 1: 640 x 480 resized
LOSS_KEYS = ("loss", "loss_cls", "loss_reg", "num_pos")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config(size):
    return Config.fromfile(os.path.join(CONFIGS, f"ssd{size}_vgg16_coco.py"))


# ---------------------------------------------------------------- modules


@pytest.mark.parametrize("size", [300, 512])
def test_ssdvgg_trunk_matches_the_reference(rng, size):
    x = rng.normal(size=(1, size, size, 3)).astype(np.float32)
    jax_trunk = JaxSSDVGG(input_size=size)
    shapes = jax.eval_shape(jax_trunk.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = seeded_variables(shapes, rng)
    want = jax.jit(jax_trunk.apply)(variables, jnp.asarray(x))
    trunk = SSDVGG(input_size=size, device="cpu").to(memory_format=torch.channels_last)
    trunk.load_state_dict(from_jax_variables(variables, trunk), strict=True)
    with torch.no_grad():
        got = trunk(torch.from_numpy(x))
    assert [tuple(g.shape[1:3]) for g in got] == SIZES[size]
    assert tuple(g.shape[-1] for g in got) == trunk.out_channels
    for lvl, (g, w) in enumerate(zip(got, want, strict=True)):
        rel_close(g.numpy(), w, 1e-4, f"map {lvl}")


def test_l2norm_matches_the_reference(rng):
    """float32 inside, eps after the square root, ``scale`` float32 and
    the result in the input's dtype (bf16 under autocast)."""
    x = rng.normal(size=(2, 5, 6, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps term decides this one
    scale = rng.uniform(10, 30, 16).astype(np.float32)
    want = JaxL2Norm().apply({"params": {"scale": scale}}, jnp.asarray(x))
    norm = L2Norm(16)
    norm.load_state_dict(from_jax_variables({"params": {"scale": scale}}), strict=True)
    got = norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    near(got.detach().numpy(), want, 1e-5)
    xb = torch.from_numpy(x).permute(0, 3, 1, 2).to(torch.bfloat16)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        out = norm(xb)
    assert out.dtype == torch.bfloat16 and norm.scale.dtype == torch.float32
    assert torch.equal(out, norm(xb.float()).to(torch.bfloat16))


def test_ssd_head_matches_the_reference(rng):
    widths = (8, 16, 8, 8, 8, 8)
    feats = [rng.normal(size=(2, h, w, c)).astype(np.float32)
             for (h, w), c in zip(SIZES[300], widths)]
    jax_head = JaxSSDHead(num_classes=C, in_channels=widths)
    shapes = jax.eval_shape(jax_head.init, jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats])
    variables = seeded_variables(shapes, rng)
    want = jax_head.apply(variables, [jnp.asarray(f) for f in feats])
    head = SSDHead(num_classes=C, in_channels=widths)
    head.load_state_dict(from_jax_variables(variables, head), strict=True)
    with torch.no_grad():
        got = head([torch.from_numpy(f) for f in feats])
    for branch_got, branch_want in zip(got, want, strict=True):
        for g, w in zip(branch_got, branch_want, strict=True):
            assert g.shape == w.shape
            near(g.numpy(), w, 1e-5)


@pytest.mark.parametrize("size", [300, 512])
def test_anchors_match_the_reference(size):
    anchor = config(size).detection["anchor"]
    gen = build_detection_cfg(config(size).detection).anchor_generator
    jax_gen = JaxSSDAnchorGenerator(strides=tuple(anchor["strides"]),
                                    min_sizes=tuple(anchor["min_sizes"]),
                                    max_sizes=tuple(anchor["max_sizes"]),
                                    ratios=tuple(tuple(r) for r in anchor["ratios"]))
    assert isinstance(gen, SSDAnchorGenerator)
    assert gen.featmap_sizes_for((size, size)) == SIZES[size]
    assert gen.num_base_anchors_per_level == jax_gen.num_base_anchors_per_level
    got = gen.flat_anchors(SIZES[size])
    assert got.shape == (COUNTS[size], 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_gen.flat_anchors(SIZES[size])))


# ---------------------------------------------------------------- loss, mining, decode


def padded_outputs(rng):
    """Head outputs of b2 at the 300 geometry, C = 4. Image 1's anchors
    whose centre lies in the 75 padded rows have one output vector a level
    and anchor kind, as a conv over zeros gives; on level 0 the background
    logit is 8 lower, so those 4 x 380 anchors lead the negatives' ranking
    in four tie groups. Image 0's gts and image 1's three gts (one
    padding slot) lie inside the images."""
    apl = SSDAnchorGenerator().num_base_anchors_per_level
    cls, reg = [], []
    for lvl, ((h, w), a, stride) in enumerate(zip(SIZES[300], apl, SSDAnchorGenerator().strides)):
        c = rng.normal(0, 1, (2, h, w, a * (C + 1))).astype(np.float32)
        r = rng.normal(0, 0.5, (2, h, w, a * 4)).astype(np.float32)
        rows = (np.arange(h) + 0.5) * stride >= IMG_SHAPES[1, 0]
        const = rng.normal(0, 1, a * (C + 1)).astype(np.float32)
        if lvl == 0:
            const[0::C + 1] -= 8.0
        c[1, rows] = const
        r[1, rows] = rng.normal(0, 0.5, a * 4).astype(np.float32)
        cls.append(c)
        reg.append(r)
    gts = dict(gt_boxes=np.array([[[20, 30, 120, 160], [150, 40, 290, 200], [60, 200, 140, 290],
                                   [0, 0, 0, 0]],
                                  [[30, 20, 90, 100], [120, 60, 260, 210], [200, 10, 240, 60],
                                   [0, 0, 0, 0]]], np.float32),
               gt_labels=np.array([[1, 3, 4, 0], [2, 4, 1, 0]], np.int32),
               gt_valid=np.array([[True, True, True, False], [True, True, True, False]]))
    return cls, reg, gts


@pytest.fixture(scope="module")
def padded_setup():
    """The JAX loss dict and its gradients into every head output (one jit),
    and the port's on the same outputs."""
    cls, reg, gts = padded_outputs(np.random.default_rng(7))
    jgts = [jnp.asarray(gts[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")]

    def jloss(c, r):
        out = jax_ssd_loss(JAX_CFG, c, r, *jgts)
        return out["loss"], out

    (_, want), (wc, wr) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg])
    tc = [torch.from_numpy(c).requires_grad_() for c in cls]
    tr = [torch.from_numpy(r).requires_grad_() for r in reg]
    tg = [torch.from_numpy(gts[k]) for k in ("gt_boxes", "gt_labels", "gt_valid")]
    got = ssd_loss(CFG, tc, tr, *tg)
    got["loss"].backward()
    return dict(cls=cls, reg=reg, gts=gts, tc=tc, tr=tr, got=got,
                want={k: float(v) for k, v in want.items()},
                grad_cls=[np.asarray(g) for g in wc], grad_reg=[np.asarray(g) for g in wr])


def test_ssd_loss_and_gradients_match_with_ties_at_the_mining_cut(padded_setup):
    s = padded_setup
    for k in LOSS_KEYS:
        np.testing.assert_allclose(float(s["got"][k].detach()), s["want"][k], rtol=1e-5, err_msg=k)
    for what, got, want in (("cls", s["tc"], s["grad_cls"]), ("reg", s["tr"], s["grad_reg"])):
        for lvl, (g, w) in enumerate(zip(got, want, strict=True)):
            np.testing.assert_array_equal(g.grad.numpy() != 0, w != 0, err_msg=f"{what} {lvl}")
            rel_close(g.grad.numpy(), w, 1e-5, f"{what} {lvl}")

    # the cut falls inside a tie group: equal losses, some kept, some not
    tg = [torch.from_numpy(s["gts"][k]) for k in ("gt_boxes", "gt_labels", "gt_valid")]
    flat_c, _ = flatten_ssd_outputs(CFG, [torch.from_numpy(c) for c in s["cls"]],
                                    [torch.from_numpy(r) for r in s["reg"]])
    anchors = CFG.anchor_generator.flat_anchors(SIZES[300])
    t = ssd_targets(CFG, anchors, *tg)
    ce = cross_entropy(flat_c, t.labels)
    keep = hard_negatives(CFG, ce, t.pos, t.neg)
    limit = int(3 * int(t.pos[1].sum()))
    assert int(keep[1].sum()) == limit
    top = ce[1][t.neg[1]].max()
    group = t.neg[1] & (ce[1] == top)
    assert 0 < int((keep[1] & group).sum()) < int(group.sum())
    kept = torch.nonzero(keep[1] & group)[:, 0]
    assert torch.equal(kept, torch.nonzero(group)[:, 0][:len(kept)])  # the lower indices


def test_r11_the_mining_keeps_padding_anchors_on_both_sides(padded_setup):
    """R11: ``ssd_loss`` takes no ``img_shapes``, so the anchors over image
    1's padding are negatives, and the mining keeps some of them: the
    reference's gradient and the port's reach them alike."""
    s = padded_setup
    anchors = CFG.anchor_generator.flat_anchors(SIZES[300])
    in_padding = ((anchors[:, 1] + anchors[:, 3]) * 0.5 >= float(IMG_SHAPES[1, 0])).numpy()
    b = 2
    want = np.concatenate([g.reshape(b, -1, C + 1) for g in s["grad_cls"]], 1)[1]
    got = torch.cat([g.grad.reshape(b, -1, C + 1) for g in s["tc"]], 1)[1].numpy()
    want_kept = (want != 0).any(-1) & in_padding
    assert want_kept.sum() > 0
    np.testing.assert_array_equal((got != 0).any(-1) & in_padding, want_kept)


def test_decode_ssd_matches_the_reference(rng):
    cls, reg, _ = padded_outputs(rng)
    shapes, scale = IMG_SHAPES, np.array([0.5, 0.46875], np.float32)
    want = jax.jit(functools.partial(jax_decode_ssd, JAX_CFG))(
        [jnp.asarray(c) for c in cls], [jnp.asarray(r) for r in reg],
        img_shapes=jnp.asarray(shapes), scale_factors=jnp.asarray(scale))
    got = decode_ssd(CFG, [torch.from_numpy(c) for c in cls], [torch.from_numpy(r) for r in reg],
                     torch.from_numpy(shapes), torch.from_numpy(scale))
    for field in ("valid", "labels", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      err_msg=field)
    assert int(got.valid.sum()) > 100
    near(got.scores.numpy(), want.scores, 1e-6, "scores")
    near(got.boxes.numpy(), want.boxes, 1e-6, "boxes")


# ---------------------------------------------------------------- configs and builds


@pytest.mark.parametrize("size", [300, 512])
def test_config_builds_and_pins_r1(size):
    """R1: the reference's ``build_detection_cfg`` raises on both SSD
    configs (they set an ``assigner``); the port's builds each, equal to the
    ``SSDConfig`` the files' values give."""
    det = config(size).detection
    with pytest.raises(UnboundLocalError):
        jax_builder.build_detection_cfg(dict(det))
    anchor = det["anchor"]
    want = SSDConfig(
        num_classes=80,
        anchor_generator=SSDAnchorGenerator(
            strides=tuple(anchor["strides"]), min_sizes=tuple(anchor["min_sizes"]),
            max_sizes=tuple(anchor["max_sizes"]), ratios=tuple(tuple(r) for r in anchor["ratios"])),
        assigner=MaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0),
        target_stds=(0.1, 0.1, 0.2, 0.2), neg_pos_ratio=3.0, smooth_l1_beta=1.0, score_thr=0.02,
        nms_iou_thr=0.45, max_detections=200)
    assert build_detection_cfg(det) == want
    with pytest.raises(NotImplementedError, match="approx_top_k"):
        build_detection_cfg(dict(det, approx_top_k=True))


def check_reference_tree(model_cfg, model, size):
    """Every tensor of the JAX model's variables (``jax.eval_shape``,
    nothing compiled) loads into ``model`` with ``strict=True``, and the
    parameter counts agree."""
    jax_model = JaxSingleStageDetector(**{k: v for k, v in model_cfg.items() if k != "type"})
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3), jnp.float32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model.load_state_dict(from_jax_variables(zeros, model), strict=True)
    count = sum(p.numel() for p in model.parameters())
    assert count == sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    return count


@pytest.mark.parametrize("size", [300, 512])
def test_full_width_loads_the_reference_tree_and_needs_a_gpu(monkeypatch, size):
    cfg = config(size)
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert type(model.backbone).__name__ == "SSDVGG" and model.neck is None
    assert torch.equal(model.backbone.l2_norm.scale.detach(), torch.full((512,), 20.0))
    assert check_reference_tree(cfg.model, model, size) == {300: 34305206, 512: 36038196}[size]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(cfg.model, "float32")


@pytest.fixture(scope="module")
def ssd300_model():
    """SSD300 with C = 4 on the CPU, seeded, float32."""
    cfg = config(300)
    cfg.model["head"]["num_classes"] = C
    return build_detector(cfg.model, "float32", device="cpu", seed=0)


def padded_batch(rng):
    """b2 on the 300 canvas, image 1 a 640 x 480 picture (75 rows of zero
    padding), with ``padded_outputs``' gts and two more in image 0: a box of
    291 x 291, which the two coarsest levels' anchors match, and one of
    22 x 22, which the finest level's match (so that every layer has a
    gradient)."""
    image = rng.normal(size=(2, 300, 300, 3)).astype(np.float32)
    image[1, 225:] = 0.0
    gts = padded_outputs(rng)[2]
    pad = {"gt_boxes": [[4, 4, 294, 294], [250, 250, 271, 271]], "gt_labels": [2, 3],
           "gt_valid": [True, True]}
    for k, extra in pad.items():
        rows = np.zeros((2, 2) + gts[k].shape[2:], gts[k].dtype)
        rows[0] = extra
        gts[k] = np.concatenate([gts[k], rows], axis=1)
    return dict(image=image, img_shape=IMG_SHAPES, **gts)


def test_inference_entry_point(ssd300_model, rng):
    """``make_inference_fn`` reaches ``decode_ssd`` on the model's outputs."""
    model = ssd300_model.eval()
    batch = padded_batch(rng)
    image, shapes = torch.from_numpy(batch["image"]), torch.from_numpy(IMG_SHAPES)
    got = make_inference_fn(model, CFG)(image, shapes, torch.ones(2))
    with torch.no_grad():
        want = decode_ssd(CFG, *model(image), shapes, torch.ones(2))
    for g, w in zip(got, want, strict=True):
        assert torch.equal(g, w)


def test_trainer_step(ssd300_model, rng):
    check_trainer_step(ssd300_model, CFG, padded_batch(rng), ("loss", "loss_cls", "loss_reg"))
