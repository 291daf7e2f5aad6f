"""The port's RetinaNet serving path against the JAX package's, on converted
weights.

The detector is a tiny RetinaNet on the flagship's layout: ResNet-18 with
the space-to-depth stem and ``out_indices=(1, 2, 3)``, FPN 32 channels with
extra convs on its inputs, a head of 2 stacked convs of 32, 9 anchors, 3
classes, on a 64 x 96 canvas, batch 2. Its JAX variables are initialised by
flax; FrozenBN's statistics and affine parameters, the head towers' and
``reg_out``'s biases are drawn from a numpy seed, ``cls_out``'s bias is 0 on
both sides (the focal prior would put every score under ``score_thr``).
They are converted with ``from_jax_variables`` and loaded with
``strict=True``. Both sides run in float32. The JAX config is built
directly, since the reference's ``build_detection_cfg`` fails on an
``assigner`` key (``ROADMAP.md``, fault R1).

Tolerances: the preprocess exactly; module outputs atol = rtol = 1e-4
(convolutions sum in another order); detections with identical ``valid``,
``labels`` and ``indices``, boxes to 1e-3 px and scores to 1e-5. The decode
cases feed the JAX side's head outputs to both decoders, so the
comparison is of the decode alone.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_model import _randomise_frozen_bn
from torch_detection_tpu.models.backbones import ResNet as JaxResNet
from torch_detection_tpu.models.detectors import RetinaNetConfig as JaxRetinaNetConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import decode_detections as jax_decode_detections
from torch_detection_tpu.models.heads.anchor_head import RetinaHead as JaxRetinaHead
from torch_detection_tpu.models.heads.anchor_head import (
    flatten_head_outputs as jax_flatten_head_outputs,
)
from torch_detection_tpu.ops import preprocess as jax_preprocess
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.ops.assign import MaxIoUAssigner as JaxMaxIoUAssigner
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.backbones import ResNet
from torch_detection_tpu_torch.models.backbones.resnet import FoldedStemConv, space_to_depth_2x2
from torch_detection_tpu_torch.models.detectors import (
    RetinaNetConfig,
    SingleStageDetector,
    decode_detections,
)
from torch_detection_tpu_torch.models.heads import RetinaHead, flatten_head_outputs
from torch_detection_tpu_torch.ops import preprocess
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "retinanet_r50_fpn_coco.py"
TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3), stem_s2d=True),
    neck=dict(type="FPN", in_channels=(128, 256, 512), out_channels=32, num_outs=5,
              add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True),
    head=dict(type="RetinaHead", num_classes=3, in_channels=32, feat_channels=32,
              stacked_convs=2, num_base_anchors=9),
)
CANVAS = (64, 96)
IMG_SHAPES = np.array([[64, 96], [57, 83]], np.float32)


def _randomise_head_biases(variables, rng):
    """Tower and ``reg_out`` biases from ``rng``; ``cls_out``'s bias 0."""
    head = variables["params"]["head"]
    for name, module in head.items():
        leaf = module["conv"] if "conv" in module else module
        leaf["bias"] = (np.zeros_like(leaf["bias"]) if name == "cls_out"
                        else rng.normal(0, 0.1, leaf["bias"].shape).astype(np.float32))
    return variables


@pytest.fixture(scope="module")
def retina():
    """JAX and port detectors on the same weights, and the JAX side's
    per-module outputs on one seeded s2d batch."""
    rng = np.random.default_rng(0)
    jax_model = JaxSingleStageDetector(**MODEL)
    u8 = rng.integers(0, 256, (2, *CANVAS, 3), dtype=np.uint8)
    wire = jax_preprocess.space_to_depth_2x2_np(u8)
    images = np.array(jax_preprocess.fused_normalize_pad_s2d(
        jnp.asarray(wire), jnp.asarray(IMG_SHAPES.astype(np.int32)), out_dtype=jnp.float32))
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), images)
    variables = _randomise_head_biases(_randomise_frozen_bn(dict(variables), rng), rng)

    def stages(m, x):
        feats = m.backbone_mod(x)
        levels = m.neck_mod(feats)
        return feats, levels, m.head_mod(levels)

    feats, levels, (cls, reg) = jax.jit(lambda v, x: jax_model.apply(v, x, method=stages))(
        variables, images)
    want = jax.tree_util.tree_map(np.array, dict(feats=feats, levels=levels, cls=cls, reg=reg))

    model = SingleStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    return jax_model, variables, model, torch.from_numpy(images), want


def _close(got, want, **tol):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), w, **(tol or TOL))


@pytest.mark.parametrize("s2d", [False, True], ids=["plain", "s2d"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_normalize_pad_matches_exactly(rng, s2d, dtype):
    """Odd valid shapes, so the s2d mask's p/q rule decides cells whose
    2x2 block straddles the border."""
    u8 = rng.integers(0, 256, (3, 10, 14, 3), dtype=np.uint8)
    shapes = np.array([[10, 14], [7, 9], [3, 13]], np.int32)
    if s2d:
        u8 = jax_preprocess.space_to_depth_2x2_np(u8)
    jax_fn = jax_preprocess.fused_normalize_pad_s2d if s2d else jax_preprocess.fused_normalize_pad
    fn = preprocess.fused_normalize_pad_s2d if s2d else preprocess.fused_normalize_pad
    want = np.asarray(jax_fn(jnp.asarray(u8), jnp.asarray(shapes), out_dtype=getattr(jnp, dtype)))
    got = fn(torch.from_numpy(u8), torch.from_numpy(shapes), out_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def test_space_to_depth_matches(rng):
    x = rng.integers(0, 256, (2, 6, 10, 3), dtype=np.uint8)
    want = jax_preprocess.space_to_depth_2x2_np(x)
    np.testing.assert_array_equal(preprocess.space_to_depth_2x2_np(x), want)
    np.testing.assert_array_equal(space_to_depth_2x2(torch.from_numpy(x)).numpy(), want)
    with pytest.raises(ValueError, match="even"):
        preprocess.space_to_depth_2x2_np(x[:, :5])


@pytest.mark.parametrize("wire", ["s2d", "plain"])
def test_s2d_stem_matches_the_reference(rng, wire):
    """The folded stem on the 12-channel wire and on a plain image (relaid
    in the model), against the JAX ResNet with ``stem_s2d=True``."""
    x = rng.normal(size=(2, 32, 48, 3)).astype(np.float32)
    jax_net = JaxResNet(depth=18, num_stages=1, out_indices=(0,), stem_s2d=True)
    variables = _randomise_frozen_bn(dict(jax_net.init(jax.random.PRNGKey(1), x)), rng)
    assert variables["params"]["stem"]["conv"]["kernel"].shape == (7, 7, 3, 64)
    if wire == "s2d":
        x = jax_preprocess.space_to_depth_2x2_np(x)
    want = jax.tree_util.tree_map(np.asarray, jax_net.apply(variables, x))
    net = ResNet(depth=18, num_stages=1, out_indices=(0,), stem_s2d=True, device="cpu")
    net.load_state_dict(from_jax_variables(variables, net), strict=True)
    with torch.no_grad():
        _close(net.to(memory_format=torch.channels_last)(torch.from_numpy(x)), want)


def test_folded_stem_is_the_7x7_stride_2_conv():
    """In float64 the fold differs from the plain conv by summation order only."""
    gen = torch.Generator().manual_seed(0)
    conv = FoldedStemConv(3, 64, dtype=torch.float64, device="cpu")
    x = torch.randn((2, 30, 46, 3), generator=gen, dtype=torch.float64)
    with torch.no_grad():
        conv.weight.normal_(generator=gen)
        got = conv(space_to_depth_2x2(x).permute(0, 3, 1, 2))
        want = F.conv2d(x.permute(0, 3, 1, 2), conv.weight, stride=2, padding=3)
    assert got.shape == want.shape == (2, 64, 15, 23)
    assert got.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got, want, atol=1e-12, rtol=0)
    assert conv.weight.shape == (64, 3, 7, 7)


def test_backbone_fpn_and_head_per_level(retina):
    _, _, model, images, want = retina
    with torch.no_grad():
        feats = model.backbone(images)
        levels = model.neck(feats)
        cls, reg = model.head(levels)
    _close(feats, want["feats"])
    _close(levels, want["levels"])
    _close(cls, want["cls"])
    _close(reg, want["reg"])
    assert [tuple(c.shape[1:]) for c in cls] == [(8, 12, 27), (4, 6, 27), (2, 3, 27), (1, 2, 27),
                                                  (1, 1, 27)]


def test_retina_head_alone(rng):
    """A head on its own, with flax's default initialisers (the prior bias
    on ``cls_out``)."""
    feats = tuple(rng.normal(size=(2, s, s + 1, 16)).astype(np.float32) for s in (6, 3, 2))
    jax_head = JaxRetinaHead(num_classes=4, in_channels=16, feat_channels=8, stacked_convs=3,
                             num_base_anchors=2)
    variables = jax_head.init(jax.random.PRNGKey(2), feats)
    want = jax.tree_util.tree_map(np.asarray, jax_head.apply(variables, feats))
    head = RetinaHead(num_classes=4, in_channels=16, feat_channels=8, stacked_convs=3,
                      num_base_anchors=2, device="cpu")
    head.load_state_dict(from_jax_variables(variables, head), strict=True)
    with torch.no_grad():
        cls, reg = head.to(memory_format=torch.channels_last)([torch.from_numpy(f) for f in feats])
    _close(cls, want[0])
    _close(reg, want[1])
    flat = flatten_head_outputs([torch.from_numpy(np.array(c)) for c in want[0]],
                                [torch.from_numpy(np.array(r)) for r in want[1]], 4)
    flat_want = jax_flatten_head_outputs(want[0], want[1], 4)
    for g, w in zip(flat, flat_want, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert flat[0].shape == (2, sum(2 * s * (s + 1) for s in (6, 3, 2)), 4)


def _jax_cfg(**kw):
    return JaxRetinaNetConfig(num_classes=3, **kw)


@pytest.mark.parametrize(
    "pre_select,scale,clip",
    [(1000, "b", True), (40, "b4", True), (40, None, False)],
    ids=["every_anchor", "position_and_anchor_paths", "unclipped"],
)
def test_decode_detections_matches(retina, pre_select, scale, clip):
    """At 64 x 96 a level holds 9-864 anchors: ``pre_select_per_level=40``
    sends P3 down the position path, P4 and P5 down the anchor path, and
    keeps P6 and P7 whole; 1000 keeps every anchor."""
    want_head = retina[4]
    scale_factors = {None: None, "b": np.array([1.0, 2.0], np.float32),
                     "b4": np.array([[1.0, 2.0, 1.0, 2.0], [0.5, 0.5, 1.5, 1.5]], np.float32)}[scale]
    img_shapes = IMG_SHAPES if clip else None
    jax_cfg = _jax_cfg(pre_select_per_level=pre_select)
    want = jax.jit(lambda c, r, s, f: jax_decode_detections(jax_cfg, c, r, s, f))(
        want_head["cls"], want_head["reg"], img_shapes, scale_factors)
    cfg = RetinaNetConfig(num_classes=3, pre_select_per_level=pre_select)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    got = decode_detections(cfg, [torch.from_numpy(c) for c in want_head["cls"]],
                            [torch.from_numpy(r) for r in want_head["reg"]], as_t(img_shapes),
                            as_t(scale_factors))
    assert got.boxes.shape == (2, 100, 4) and bool(got.valid.any(dim=1).all())
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)


def test_inference_end_to_end(retina):
    """The s2d wire through ``make_inference_fn`` against the JAX model and
    ``decode_detections``."""
    jax_model, variables, model, images, _ = retina
    scale = np.array([2.0, 1.0], np.float32)
    jax_cfg = _jax_cfg()
    want = jax.jit(lambda v, x, s, f: jax_decode_detections(jax_cfg, *jax_model.apply(v, x), s, f))(
        variables, images.numpy(), IMG_SHAPES, scale)
    got = make_inference_fn(model, RetinaNetConfig(num_classes=3))(
        images, torch.from_numpy(IMG_SHAPES), torch.from_numpy(scale))
    assert bool(got.valid.any())
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="segm=True"):
        make_inference_fn(model, RetinaNetConfig(num_classes=3), segm=True)


def test_detection_cfg_matches_a_hand_built_reference():
    cfg = build_detection_cfg(Config.fromfile(CONFIG).detection)
    want = JaxRetinaNetConfig(
        num_classes=80,
        anchor_generator=JaxAnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                                            octave_base_scale=4.0, scales_per_octave=3),
        assigner=JaxMaxIoUAssigner(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
        target_means=(0.0, 0.0, 0.0, 0.0), target_stds=(1.0, 1.0, 1.0, 1.0),
        score_thr=0.05, nms_iou_thr=0.5, max_detections=100,
    )
    assert isinstance(cfg, RetinaNetConfig)
    for field in ("num_classes", "target_means", "target_stds", "focal_gamma", "focal_alpha",
                  "smooth_l1_beta", "reg_loss_weight", "score_thr", "nms_iou_thr",
                  "pre_select_per_level", "pre_nms_top_k", "max_detections"):
        assert getattr(cfg, field) == getattr(want, field), field
    for field in ("strides", "ratios", "resolved_scales", "num_base_anchors"):
        assert getattr(cfg.anchor_generator, field) == getattr(want.anchor_generator, field), field
    for field in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
        assert getattr(cfg.assigner, field) == getattr(want.assigner, field), field
    # the port's constants: every gt's best anchors take it, no ignore regions
    assert want.assigner.gt_max_assign_all and want.assigner.ignore_iof_thr < 0
    assert not want.approx_top_k and want.nms_method == "hard"


@pytest.mark.parametrize("key,error", [(dict(approx_top_k=True), NotImplementedError),
                                       (dict(nms_method="matrix"), ValueError)],
                         ids=["approx_top_k", "nms_method"])
def test_detection_cfg_refuses_what_is_not_ported(key, error):
    """``approx_top_k`` (a TPU approximation) is not ported; Soft-NMS is
    (``tests/test_torch_soft_nms.py``), and an ``nms_method`` other than
    ``hard`` or ``soft``, which the reference runs as greedy NMS, is
    refused."""
    det = dict(Config.fromfile(CONFIG).detection, **key)
    with pytest.raises(error, match=next(iter(key))):
        build_detection_cfg(det)


def test_full_width_retinanet_answers_on_cpu():
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    # the JAX model's count: flax's ``SingleStageDetector`` on this config
    assert sum(p.numel() for p in model.parameters()) == 37_968_692
    assert torch.allclose(model.head.cls_out.bias, torch.tensor(-4.59511985013459))
    frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
    assert "backbone.stem.conv.weight" in frozen and not any(n.startswith("head.") for n in frozen)
    with torch.no_grad():
        model.head.cls_out.bias.zero_()
    u8 = np.random.default_rng(0).integers(0, 256, (1, 64, 96, 3), dtype=np.uint8)
    shape = torch.tensor([[64, 96]])
    wire = preprocess.fused_normalize_pad_s2d(
        torch.from_numpy(preprocess.space_to_depth_2x2_np(u8)), shape, out_dtype=torch.float32)
    res = make_inference_fn(model, build_detection_cfg(cfg.detection))(wire, shape, torch.tensor([2.0]))
    assert res.boxes.shape == (1, 100, 4) and res.valid.shape == (1, 100)
    assert torch.isfinite(res.boxes).all() and bool(res.valid.any())
    assert float(res.boxes[res.valid].max()) <= 95.0 / 2.0
