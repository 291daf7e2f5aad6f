"""The port's Faster R-CNN against the JAX package's, on converted weights.

The detector is the one of ``test_two_stage.py``'s ``frcnn_setup``:
ResNet-18, FPN 16 channels, fc 32, 3 classes, 64 x 64 images, batch 2.
Its JAX variables are initialised by flax, their FrozenBN statistics and
affine parameters randomised from a numpy seed (so the fold is exercised),
then converted with ``from_jax_variables`` and loaded with ``strict=True``.
Both sides run in float32. The JAX side is jitted once per module.

Tolerances: module outputs atol=rtol=1e-4 (convolutions sum in another
order); end to end, identical ``valid``, ``labels`` and ``indices``, boxes
to 1e-3 and scores to 1e-5. At 64 x 64 every level is smaller than the
fused RoIAlign's 40-cell window, so the JAX path equals its gather oracle.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from torch_detection_tpu.models.detectors import FasterRCNNConfig as JaxFasterRCNNConfig
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.detectors import faster_rcnn_inference as jax_inference
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.models.heads import generate_proposals as jax_generate_proposals
from torch_detection_tpu.models.necks import FPN as JaxFPN
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.backbones import ResNet
from torch_detection_tpu_torch.models.detectors import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_inference,
)
from torch_detection_tpu_torch.models.heads import ProposalConfig, generate_proposals
from torch_detection_tpu_torch.models.layers import (
    FrozenBatchNorm,
    max_pool_same_torch,
    resize_nearest,
)
from torch_detection_tpu_torch.models.necks import FPN
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator

TOL = dict(atol=1e-4, rtol=1e-4)
MODEL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16, num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=16, feat_channels=16, num_base_anchors=3),
    bbox_head=dict(type="BBoxHead", num_classes=3, fc_channels=32),
)
ANCHORS = dict(strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0), scales=(8.0,),
               octave_base_scale=None)
PROPOSALS = dict(pre_nms_per_level=64, post_nms_top_k=32)
DET = dict(num_classes=3, max_detections=8)


def _randomise_frozen_bn(variables, rng):
    """FrozenBN scale/bias/mean/var drawn from ``rng`` (flax inits them to
    the identity, which would leave the fold untested)."""

    def walk(params, stats):
        for key in stats:
            if set(stats[key]) == {"mean", "var"}:
                n = stats[key]["mean"].shape
                stats[key]["mean"] = rng.normal(0, 0.5, n).astype(np.float32)
                stats[key]["var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
                params[key]["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                params[key]["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
            else:
                walk(params[key], stats[key])

    variables = jax.tree_util.tree_map(np.asarray, variables)
    walk(variables["params"], variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def frcnn():
    """JAX and port detectors on the same weights, and the JAX side's
    outputs on one seeded batch."""
    rng = np.random.default_rng(0)
    jax_model = JaxTwoStageDetector(**MODEL)
    jax_cfg = JaxFasterRCNNConfig(
        num_classes=3, anchor_generator=JaxAnchorGenerator(**ANCHORS),
        proposal_test=JaxProposalConfig(**PROPOSALS), max_detections=8,
    )
    x0 = jnp.zeros((2, 64, 64, 3), jnp.float32)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), x0)
    roi_vars = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, 16, 7, 7, 16)),
                              method=JaxTwoStageDetector.roi_forward)
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **roi_vars["params"]},
         "batch_stats": variables["batch_stats"]},
        rng,
    )

    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    img_shapes = np.array([[64, 64], [60, 56]], np.float32)
    scale_factors = np.array([1.0, 2.0], np.float32)
    roi_feats = rng.normal(size=(2, 16, 7, 7, 16)).astype(np.float32)

    forward = jax.jit(lambda v, x: jax_model.apply(v, x))
    backbone = jax.jit(lambda v, x: jax_model.apply(v, x, method=lambda m, x: m.backbone_mod(x)))
    roi_forward = jax.jit(lambda v, r: jax_model.apply(v, r, method=JaxTwoStageDetector.roi_forward))
    infer = jax.jit(lambda v, x, s, f: jax_inference(jax_cfg, jax_model, v, x, s, f))
    feats, rpn_s, rpn_d = forward(variables, images)
    proposals = jax_generate_proposals(jax_cfg.proposal_test, jax_cfg.anchor_generator,
                                       rpn_s, rpn_d, jnp.asarray(img_shapes))
    want = dict(
        backbone=backbone(variables, images), feats=feats, rpn_scores=rpn_s, rpn_deltas=rpn_d,
        proposals=proposals, head=roi_forward(variables, roi_feats),
        dets=infer(variables, images, img_shapes, scale_factors),
    )
    want = jax.tree_util.tree_map(np.asarray, want)

    model = TwoStageDetector(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables), strict=True)
    model = model.to(memory_format=torch.channels_last).eval()
    cfg = FasterRCNNConfig(num_classes=3, anchor_generator=AnchorGenerator(**ANCHORS),
                           proposal_test=ProposalConfig(**PROPOSALS), max_detections=8)
    inputs = dict(images=images, img_shapes=img_shapes, scale_factors=scale_factors,
                  roi_feats=roi_feats)
    return model, cfg, {k: torch.from_numpy(v) for k, v in inputs.items()}, want


def _close(got, want, **tol):
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), w, **(tol or TOL))


def test_backbone_per_level(frcnn):
    model, _, x, want = frcnn
    with torch.no_grad():
        _close(model.backbone(x["images"]), want["backbone"])


def test_fpn_and_rpn_outputs(frcnn):
    model, _, x, want = frcnn
    with torch.no_grad():
        feats, scores, deltas = model(x["images"])
    _close(feats, want["feats"])
    _close(scores, want["rpn_scores"])
    _close(deltas, want["rpn_deltas"])


def test_proposals(frcnn):
    model, cfg, x, want = frcnn
    with torch.no_grad():
        _, scores, deltas = model(x["images"])
    got = generate_proposals(cfg.proposal_test, cfg.anchor_generator, scores, deltas,
                             x["img_shapes"])
    np.testing.assert_array_equal(got.valid.numpy(), want["proposals"].valid)
    np.testing.assert_allclose(got.boxes.numpy(), want["proposals"].boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), want["proposals"].scores, atol=1e-5, rtol=0)


def test_bbox_head_outputs(frcnn):
    model, _, x, want = frcnn
    with torch.no_grad():
        _close(model.roi_forward(x["roi_feats"]), want["head"])


def test_faster_rcnn_inference_end_to_end(frcnn):
    model, cfg, x, want = frcnn
    with torch.no_grad():
        got = faster_rcnn_inference(cfg, model, x["images"], x["img_shapes"], x["scale_factors"])
    want = want["dets"]
    assert got.boxes.shape == (2, 8, 4) and bool(got.valid.any())
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_array_equal(got.indices.numpy(), want.indices)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-5, rtol=0)


@pytest.mark.parametrize("out_hw", [(10, 14), (13, 19), (7, 9), (3, 4)])
def test_resize_nearest_matches(rng, out_hw):
    from torch_detection_tpu.models.layers import resize_nearest as jax_resize

    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out_hw))
    got = resize_nearest(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (1, 2, 0), (2, 2, 0)])
def test_max_pool_matches(rng, window, stride, padding):
    from torch_detection_tpu.models.layers import max_pool_same_torch as jax_pool

    x = rng.normal(size=(2, 9, 12, 4)).astype(np.float32)
    want = np.asarray(jax_pool(jnp.asarray(x), window, stride, padding))
    got = max_pool_same_torch(torch.from_numpy(x).permute(0, 3, 1, 2), window, stride, padding)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("mode", ["grad", "no_grad", "inference"])
def test_frozen_bn_fold_follows_its_statistics(rng, mode):
    """The fold matches the reference, and without autograd its cache is
    refreshed when the statistics are replaced (steps 0, 1: fresh tensors of
    one version) or edited in place (step 2)."""
    from torch_detection_tpu.models.layers import FrozenBatchNorm as JaxFrozenBN

    x = rng.normal(size=(2, 5, 6, 4)).astype(np.float32)
    bn = FrozenBatchNorm(4, device="cpu")
    jax_bn = JaxFrozenBN()
    ctx = {"grad": torch.enable_grad, "no_grad": torch.no_grad,
           "inference": torch.inference_mode}[mode]
    for step in range(3):
        stats = {k: rng.uniform(0.5, 1.5, 4).astype(np.float32) for k in ("scale", "var")}
        stats.update({k: rng.normal(size=4).astype(np.float32) for k in ("bias", "mean")})
        with torch.no_grad():
            for k, v in stats.items():
                if step == 2:
                    getattr(bn, k).copy_(torch.from_numpy(v))
                else:  # as load_state_dict(assign=True) would
                    fresh = torch.from_numpy(v)
                    setattr(bn, k, nn.Parameter(fresh) if k in ("scale", "bias") else fresh)
        variables = {"params": {k: stats[k] for k in ("scale", "bias")},
                     "batch_stats": {k: stats[k] for k in ("mean", "var")}}
        want = np.asarray(jax_bn.apply(variables, jnp.asarray(x)))
        with ctx():
            got = bn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6, rtol=1e-6)


def test_resnet50_bottleneck_stages(rng):
    """Depth 50 (Bottleneck, with downsample and stride), cut to 2 stages."""
    from torch_detection_tpu.models.backbones import ResNet as JaxResNet

    x = rng.normal(size=(1, 32, 48, 3)).astype(np.float32)
    jax_net = JaxResNet(depth=50, num_stages=2, out_indices=(0, 1))
    variables = _randomise_frozen_bn(dict(jax_net.init(jax.random.PRNGKey(2), x)), rng)
    want = jax.tree_util.tree_map(np.asarray, jax_net.apply(variables, x))
    net = ResNet(depth=50, num_stages=2, out_indices=(0, 1), device="cpu")
    net.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        _close(net.to(memory_format=torch.channels_last)(torch.from_numpy(x)), want)


@pytest.mark.parametrize(
    "kw",
    [
        dict(),  # Faster R-CNN: P6 by stride-2 subsampling
        dict(add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True),
        dict(add_extra_convs=True, extra_convs_on_inputs=False, start_level=1),
    ],
    ids=["subsample", "convs_on_inputs", "convs_on_outputs"],
)
def test_fpn_variants(rng, kw):
    chans = (8, 16, 24, 32)
    xs = [rng.normal(size=(1, 32 // 2**i, 40 // 2**i, c)).astype(np.float32)
          for i, c in enumerate(chans)]
    jax_fpn = JaxFPN(in_channels=chans, out_channels=8, num_outs=5, **kw)
    variables = jax_fpn.init(jax.random.PRNGKey(3), tuple(xs))
    want = jax.tree_util.tree_map(np.asarray, jax_fpn.apply(variables, tuple(xs)))
    fpn = FPN(in_channels=chans, out_channels=8, num_outs=5, device="cpu", **kw)
    fpn.load_state_dict(from_jax_variables(variables), strict=True)
    with torch.no_grad():
        got = fpn.to(memory_format=torch.channels_last)([torch.from_numpy(x) for x in xs])
    _close(got, want)
