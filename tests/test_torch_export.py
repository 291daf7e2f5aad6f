"""The port's serving export against the JAX package's, and RoIAlign as registered ops.

The families are those of the reference's export tests
(``tests/test_export.py`` and the ``test_export_roundtrip`` of
``test_gfl.py``, ``test_detr.py``, ``test_sparse_rcnn.py``,
``test_fcos.py``, ``test_atss.py`` and ``test_foveabox.py``), on their
narrow models, configs, canvases and batches, plus Cascade R-CNN,
FreeAnchor and RetinaNet with Soft-NMS. For each, the JAX variable tree
of the reference's builder (``init_detector_variables`` under
``jax.eval_shape``, nothing compiled) is filled from a numpy seed
(``test_torch_vgg.seeded_variables``, its kernels at flax's default
variance) and carried into the port by
``from_jax_variables`` with ``strict=True``. One seeded
uint8 batch (the first image filling the canvas, the others smaller, scale
factors 1 and 2) goes through

* the reference's ``make_serving_fn`` under ``jax.jit``, float32 (the
  two-stage families through its plain RoIAlign off the TPU, as its own
  tests run them);
* the port's ``export_serving``, saved with ``torch.export.save`` to a
  ``BytesIO`` and loaded back with ``load_serving``;
* the port's live ``make_serving_fn`` module.

The loaded artifact must equal the live module bit for bit. Against the
reference, the port's per-family inference tolerances
(``tests/test_torch_model.py``, ``test_torch_mask_rcnn.py``): equal
``valid`` and ``labels``, boxes within 1e-3, scores within 1e-5 and mask
probabilities within 1e-5 (absolute), with one addition: boxes and
scores also within 1e-4 of their value (relative). Those tests feed both
sides the same float images; here each normalizes the uint8 wire itself,
the reference dividing by the std and the port multiplying by its float32
reciprocal (its ``ops/preprocess.py``, the reference's on-device formula),
so the two start one rounding apart, and Cascade R-CNN's three stages,
each decoding the boxes of the last and the scores their mean, carry that
gap to 4e-5 of a coordinate (1.2e-3 px at 30 px) and 1.8e-5 of a score.

This file holds Faster, Mask and Cascade Mask R-CNN (the RoIAlign op
inside the exported graph), the registered ops themselves, the NMS
fixpoint's ``while_loop`` and the Fast R-CNN refusal;
``test_torch_export_sets.py``, ``test_torch_export_dense.py`` and
``test_torch_export_single.py`` hold the other families, so that no file
takes much more than a minute. Torch runs on one thread.
"""

import importlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_vgg import seeded_variables
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.engine.export import make_serving_fn as jax_make_serving_fn
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.engine import (
    export_serving,
    load_serving,
    make_serving_fn,
    save_serving,
)
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import FastRCNNConfig
from torch_detection_tpu_torch.ops import nms
from torch_detection_tpu_torch.ops import roi_align as port

# ---------------------------------------------------------------- the families

R18_P3 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3))
R18_P2 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3))
FPN_P3 = dict(type="FPN", in_channels=(128, 256, 512), out_channels=32, num_outs=5,
              add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True)
FPN_P2 = dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=5)
RPN = dict(type="RPNHead", in_channels=32, feat_channels=32, num_base_anchors=3)
BBOX = dict(type="BBoxHead", num_classes=4, fc_channels=64)
FCN = dict(type="FCNMaskHead", num_classes=4, in_channels=32, conv_channels=16, num_convs=1)
RETINA_HEAD = dict(type="RetinaHead", num_classes=4, in_channels=32, feat_channels=32,
                   stacked_convs=1, num_base_anchors=9)
TOP = dict(max_detections=10, pre_nms_top_k=64, score_thr=0.0)


def dense(head):
    return dict(type="SingleStageDetector", backbone=R18_P3, neck=FPN_P3, head=head)


def tower(kind, **kw):
    return dense(dict(type=kind, num_classes=4, in_channels=32, feat_channels=32,
                      stacked_convs=1, **kw))


def retina_anchors(a):
    return a.AnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(0.5, 1.0, 2.0),
                             octave_base_scale=4.0, scales_per_octave=3)


def square_anchors(a):
    return a.AnchorGenerator(strides=(8, 16, 32, 64, 128), ratios=(1.0,), octave_base_scale=8.0,
                             scales_per_octave=1)


def retina(config_name, **kw):
    return lambda d, a: getattr(d, config_name)(
        num_classes=4, anchor_generator=retina_anchors(a), max_detections=10,
        pre_nms_top_k=100, score_thr=0.0, **kw)


# name: (model dict, config(detectors module, anchors module) of either package, canvas, batch)
FAMILIES = {
    "faster_rcnn": (dict(type="TwoStageDetector", backbone=R18_P2, neck=FPN_P2, rpn_head=RPN,
                         bbox_head=BBOX),
                    lambda d, a: d.FasterRCNNConfig(num_classes=4, max_detections=8,
                                                    score_thr=0.0), (64, 64), 1),
    "mask_rcnn": (dict(type="MaskRCNN", backbone=R18_P2, neck=FPN_P2, rpn_head=RPN,
                       bbox_head=BBOX, mask_head=FCN),
                  lambda d, a: d.MaskRCNNConfig(num_classes=4, max_detections=8, score_thr=0.0,
                                                mask_roi_size=7, mask_size=14), (64, 64), 1),
    "cascade_rcnn": (dict(type="CascadeRCNN", backbone=R18_P2, neck=FPN_P2, rpn_head=RPN,
                          bbox_head=BBOX, num_stages=3),
                     lambda d, a: d.CascadeRCNNConfig(num_classes=4, max_detections=8,
                                                      score_thr=0.0), (64, 64), 1),
    "cascade_mask_rcnn": (dict(type="CascadeMaskRCNN", backbone=R18_P2, neck=FPN_P2,
                               rpn_head=RPN, bbox_head=BBOX, mask_head=FCN, num_stages=3),
                          lambda d, a: d.CascadeMaskRCNNConfig(
                              num_classes=4, max_detections=8, score_thr=0.0, mask_roi_size=7,
                              mask_size=14), (64, 64), 1),
    "sparse_rcnn": (dict(type="SparseRCNN", backbone=R18_P2,
                         neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32,
                                   num_outs=4),
                         num_proposals=8, num_stages=2, num_classes=3, d_model=32, nhead=4,
                         dim_feedforward=64, dynamic_dim=16, roi_size=7,
                         roi_strides=(4, 8, 16, 32)),
                    lambda d, a: d.SparseRCNNConfig(num_classes=3, num_proposals=8,
                                                    max_detections=8, score_thr=0.0),
                    (64, 64), 1),
    "retina": (dense(RETINA_HEAD), retina("RetinaNetConfig"), (64, 64), 2),
    "retina_soft_nms": (dense(RETINA_HEAD), retina("RetinaNetConfig", nms_method="soft"),
                        (64, 64), 2),
    "free_anchor": (dense(RETINA_HEAD), retina("FreeAnchorConfig"), (64, 64), 2),
    "fcos": (tower("FCOSHead"), lambda d, a: d.FCOSConfig(num_classes=4, **TOP), (64, 64), 1),
    "atss": (tower("ATSSHead"),
             lambda d, a: d.ATSSConfig(num_classes=4, anchor_generator=square_anchors(a), **TOP),
             (64, 64), 1),
    "gfl": (tower("GFLHead", reg_max=8),
            lambda d, a: d.GFLConfig(num_classes=4, reg_max=8,
                                     anchor_generator=square_anchors(a), **TOP), (64, 64), 1),
    "fovea": (tower("FoveaHead"), lambda d, a: d.FoveaConfig(num_classes=4, **TOP), (64, 64), 1),
    "paa": (tower("PAAHead"),
            lambda d, a: d.PAAConfig(num_classes=4, anchor_generator=square_anchors(a),
                                     max_detections=10, pre_nms_top_k=100, score_thr=0.0),
            (64, 64), 1),
    "ssd": (dict(type="SingleStageDetector", backbone=dict(type="SSDVGG", depth=16), neck=None,
                 head=dict(type="SSDHead", num_classes=4,
                           in_channels=(512, 1024, 512, 256, 256, 256),
                           anchors_per_level=(4, 6, 6, 6, 4, 4))),
            lambda d, a: d.SSDConfig(num_classes=4, anchor_generator=a.SSDAnchorGenerator(),
                                     max_detections=10, pre_nms_top_k=100, score_thr=0.0),
            (300, 300), 1),
    "yolo": (dict(type="SingleStageDetector",
                  backbone=dict(type="Darknet", depth=53, stages=(1, 1, 1, 1, 1), base_channels=8,
                                out_indices=(2, 3, 4)),
                  neck=dict(type="YOLOV3Neck", in_channels=(64, 128, 256),
                            out_channels=(64, 32, 16)),
                  head=dict(type="YOLOV3Head", num_classes=4, anchors_per_level=1,
                            in_channels=(64, 32, 16), out_channels=(128, 64, 32))),
             lambda d, a: d.YOLOV3Config(
                 num_classes=4, anchor_generator=a.YOLOAnchorGenerator(
                     strides=(32, 16, 8),
                     base_sizes=(((48.0, 48.0),), ((24.0, 24.0),), ((12.0, 12.0),))),
                 max_detections=10, pre_nms_top_k=100, score_thr=0.0, conf_thr=0.0,
                 pre_select_per_level=50), (64, 64), 2),
    "yolox": (dict(type="SingleStageDetector",
                   backbone=dict(type="CSPDarknet", deepen_factor=0.33, widen_factor=0.125,
                                 out_indices=(2, 3, 4)),
                   neck=dict(type="YOLOXPAFPN", in_channels=(32, 64, 128), out_channels=32,
                             num_csp_blocks=1),
                   head=dict(type="YOLOXHead", num_classes=4, in_channels=32, feat_channels=32,
                             stacked_convs=1)),
              lambda d, a: d.YOLOXConfig(num_classes=4, max_detections=8, pre_nms_top_k=64,
                                         score_thr=0.0), (64, 64), 1),
    "centernet": (dict(type="SingleStageDetector",
                       backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,)),
                       neck=dict(type="CTResNetNeck", in_channels=512,
                                 num_deconv_filters=(32, 16, 16)),
                       head=dict(type="CenterNetHead", num_classes=4, in_channels=16,
                                 feat_channels=16)),
                  lambda d, a: d.CenterNetConfig(num_classes=4, max_detections=10, score_thr=0.0),
                  (64, 64), 2),
    "detr": (dict(type="DETR", backbone=dict(type="ResNet", depth=18, num_stages=4,
                                             out_indices=(3,)),
                  num_classes=3, d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                  dim_feedforward=64, num_queries=8),
             lambda d, a: d.DETRConfig(num_classes=3, num_queries=8, max_detections=8,
                                       score_thr=0.0), (64, 64), 1),
    "solov2": (dict(type="SOLOV2", backbone=R18_P2,
                    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16,
                              num_outs=5),
                    head=dict(type="SOLOV2Head", num_classes=4, in_channels=16, feat_channels=16,
                              kernel_channels=8, stacked_convs=1,
                              grid_numbers=(12, 10, 8, 6, 4), norm_groups=4),
                    mask_feat_head=dict(type="MaskFeatHead", in_channels=16, feat_channels=16,
                                        out_channels=8, num_inputs=4, norm_groups=4)),
               lambda d, a: d.SOLOV2Config(
                   num_classes=4, grid_numbers=(12, 10, 8, 6, 4),
                   scale_ranges=((1, 32), (16, 48), (32, 64), (48, 96), (64, 256)),
                   pre_nms_top_k=16, max_detections=8, mask_out_size=14, score_thr=0.0,
                   update_thr=0.0), (64, 64), 1),
}
TWO_STAGE = ("faster_rcnn", "mask_rcnn", "cascade_mask_rcnn")
MASK_KEYS = {"mask_rcnn", "cascade_mask_rcnn", "solov2"}
BOX_ATOL, SCORE_ATOL, RTOL, MASK_ATOL = 1e-3, 1e-5, 1e-4, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch in this module: the test workers share
    the cores, and at these sizes threads contend more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def family_config(name: str, package: str):
    """``name``'s detection config from ``package``'s classes (both
    packages name them alike)."""
    detectors = importlib.import_module(f"{package}.models.detectors")
    anchors = importlib.import_module(f"{package}.ops.anchors")
    return FAMILIES[name][1](detectors, anchors)


def flax_scaled_variables(shapes, rng):
    """``seeded_variables`` with each kernel at flax's default variance,
    1 / fan_in (lecun normal), not ReLU's 2 / fan_in: activations keep
    the scale they have on the reference's own initialisation, where the
    port's box tolerance was set."""
    variables = seeded_variables(shapes, rng)

    def rescale(path, leaf):
        return leaf / np.float32(np.sqrt(2.0)) if path[-1].key == "kernel" else leaf

    return jax.tree_util.tree_map_with_path(rescale, variables)


def serving_batch(rng, canvas, batch):
    """uint8 images, (h, w) int32 (the first filling the canvas, the others
    smaller) and scale factors 1, 2, ..."""
    h, w = canvas
    images = rng.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    shapes = np.array([[h, w]] + [[h - 9, w - 13]] * (batch - 1), np.int32)
    return images, shapes, np.arange(1, batch + 1, dtype=np.float32)


def serve_family(name: str, seed: int = 0):
    """The reference's jitted serving function, the port's loaded artifact
    and the port's live module on one seeded batch: three output dicts,
    numpy for the reference."""
    model_dict, _, canvas, batch = FAMILIES[name]
    rng = np.random.default_rng(seed)
    jax_model = jax_builder.build_detector(model_dict)
    jax_cfg = family_config(name, "torch_detection_tpu")
    shapes = jax.eval_shape(lambda x: jax_builder.init_detector_variables(
        jax_model, jax_cfg, model_dict, x), jax.ShapeDtypeStruct((1, *canvas, 3), jnp.float32))
    variables = flax_scaled_variables(shapes, rng)
    inputs = serving_batch(rng, canvas, batch)
    serve = jax.jit(lambda v, *x: jax_make_serving_fn(jax_model, jax_cfg, v,
                                                      compute_dtype=jnp.float32)(*x))
    want = jax.tree_util.tree_map(np.asarray, serve(variables, *inputs))

    model = build_detector(model_dict, "float32", device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    cfg = family_config(name, "torch_detection_tpu_torch")
    buffer = io.BytesIO()
    save_serving(export_serving(model, cfg, batch, canvas), buffer)
    buffer.seek(0)
    got = load_serving(buffer)(*inputs)
    live = make_serving_fn(model, cfg)(*(torch.from_numpy(a) for a in inputs))
    return got, live, want


def check_family(name: str) -> None:
    got, live, want = serve_family(name)
    keys = {"boxes", "scores", "labels", "valid"} | ({"mask_probs"} if name in MASK_KEYS else set())
    assert set(got) == set(live) == set(want) == keys
    for k in keys:
        assert torch.equal(got[k], live[k]), f"{name}: the artifact's {k} is not the live module's"
    valid = got["valid"].numpy()
    assert valid.any(), f"{name}: no detection at score_thr 0"
    np.testing.assert_array_equal(valid, want["valid"], err_msg=f"{name} valid")
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"], err_msg=f"{name} labels")
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"], atol=BOX_ATOL, rtol=RTOL,
                               err_msg=f"{name} boxes")
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"], atol=SCORE_ATOL,
                               rtol=RTOL, err_msg=f"{name} scores")
    if "mask_probs" in keys:
        np.testing.assert_allclose(got["mask_probs"].numpy(), want["mask_probs"], atol=MASK_ATOL,
                                   rtol=0, err_msg=f"{name} mask_probs")


@pytest.mark.parametrize("name", TWO_STAGE)
def test_export_round_trip_equals_live_and_the_reference(name):
    check_family(name)


# ---------------------------------------------------------------- RoIAlign as registered ops

STRIDES = (4, 8, 16, 32)


def _roi_inputs(seed=0, b=2, c=6):
    rng = np.random.default_rng(seed)
    feats = [torch.from_numpy(rng.normal(size=(b, 64 // 2**i, 96 // 2**i, c)).astype(np.float32))
             for i in range(4)]
    lo = rng.uniform(-20, 300, (b, 24, 2))
    size = rng.uniform(8, 700, (b, 24, 2))
    rois = torch.from_numpy(np.concatenate([lo, lo + size], -1).astype(np.float32))
    return feats, rois, port.map_rois_to_levels(rois, len(STRIDES))


@pytest.mark.parametrize("out_size,ratio", [(7, 2), (14, 2), (5, 3)])
def test_registered_roi_align_and_its_gradient_equal_the_plain_versions(out_size, ratio):
    feats, rois, levels = _roi_inputs()
    assert set(levels.unique().tolist()) == {0, 1, 2, 3}
    leaves = [f.clone().requires_grad_() for f in feats]
    out = torch.ops.torch_detection_tpu_torch.roi_align(leaves, rois, levels, list(STRIDES),
                                                        out_size, ratio)
    assert torch.equal(out, port.multilevel_roi_align(feats, rois, levels, STRIDES, out_size,
                                                      ratio))
    g = torch.from_numpy(np.random.default_rng(1).normal(size=out.shape).astype(np.float32))
    grads = torch.autograd.grad(out, leaves, g)
    want = port.multilevel_roi_align_backward(g, rois, levels, [f.shape[1:3] for f in feats],
                                              STRIDES, out_size, ratio)
    for a, b in zip(grads, want, strict=True):
        assert torch.equal(a, b)


def test_roi_align_ops_pass_opcheck():
    """Schema, fake tensors and the autograd registration, by
    ``torch.library.opcheck``."""
    feats, rois, levels = _roi_inputs(c=4)
    leaves = [f.requires_grad_() for f in feats]
    tests = ("test_schema", "test_autograd_registration", "test_faketensor")
    torch.library.opcheck(port.roi_align_op, (leaves, rois, levels, list(STRIDES), 7, 2),
                          test_utils=tests)
    grad = torch.ones((2, 24, 7, 7, 4))
    heights, widths = [f.shape[1] for f in feats], [f.shape[2] for f in feats]
    torch.library.opcheck(port.roi_align_backward_op,
                          (grad, rois, levels, heights, widths, list(STRIDES), 7, 2),
                          test_utils=tests)


class _Align(torch.nn.Module):
    def forward(self, p2, p3, p4, p5, rois):
        return port.batched_multilevel_roi_align([p2, p3, p4, p5], rois, STRIDES)


def test_exported_roi_align_is_one_op_node_and_round_trips():
    feats, rois, _ = _roi_inputs()
    program = torch.export.export(_Align(), (*feats, rois), strict=False)
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert targets.count("torch_detection_tpu_torch.roi_align.default") == 1
    assert not any("nonzero" in t for t in targets)  # the plain version stays inside the op
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    buffer.seek(0)
    got = torch.export.load(buffer).module()(*feats, rois)
    assert torch.equal(got, port.batched_multilevel_roi_align(feats, rois, STRIDES))


# ---------------------------------------------------------------- the NMS fixpoint


class _Suppress(torch.nn.Module):
    def forward(self, iou):
        return nms._greedy_suppress(iou, 0.5)


def sequential_greedy(iou: np.ndarray, thr: float) -> np.ndarray:
    """Greedy NMS one candidate at a time, for each image."""
    keep = np.zeros(iou.shape[:2], bool)
    for b in range(iou.shape[0]):
        for j in range(iou.shape[1]):
            keep[b, j] = not any(keep[b, i] and iou[b, i, j] > thr for i in range(j))
    return keep


def chain_iou(k: int) -> np.ndarray:
    """IoU 0.6 between neighbours and 0 elsewhere: each candidate
    suppresses the next, so greedy keeps every other one and the fixpoint
    settles one place a step."""
    iou = np.eye(k, dtype=np.float32)
    idx = np.arange(k - 1)
    iou[idx, idx + 1] = iou[idx + 1, idx] = 0.6
    return iou[None]


def random_iou(seed: int, b: int = 3, k: int = 40) -> np.ndarray:
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 60, (b, k, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(10, 40, (b, k, 2))], -1).astype(np.float32)
    t = torch.from_numpy(boxes)
    return nms.bbox_overlaps(t, t, offset=1.0).numpy()


@pytest.mark.parametrize("kind", ["random", "chain"])
def test_traced_fixpoint_gives_the_eager_keep_mask(kind):
    """The exported and reloaded fixpoint against the eager one and the
    sequential greedy answer, on the input it was traced on and another of
    its shape (random IoUs) or on the chain, where the eager loop needs
    more than half the candidates' count of steps."""
    iou = random_iou(3) if kind == "random" else chain_iou(24)
    program = torch.export.export(_Suppress(), (torch.from_numpy(iou),), strict=False)
    assert any("while_loop" in str(n.target) for n in program.graph.nodes)
    buffer = io.BytesIO()
    torch.export.save(program, buffer)
    buffer.seek(0)
    loaded = torch.export.load(buffer).module()
    syncs = nms.suppress_syncs()
    eager = nms._greedy_suppress(torch.from_numpy(iou), 0.5)
    steps = nms.suppress_syncs() - syncs
    want = sequential_greedy(iou, 0.5)
    np.testing.assert_array_equal(eager.numpy(), want)
    np.testing.assert_array_equal(loaded(torch.from_numpy(iou)).numpy(), want)
    if kind == "chain":
        assert want[0, ::2].all() and not want[0, 1::2].any()
        assert steps > 12
    else:
        other = random_iou(4)
        np.testing.assert_array_equal(loaded(torch.from_numpy(other)).numpy(),
                                      sequential_greedy(other, 0.5))


# ---------------------------------------------------------------- refusals


def test_fast_rcnn_serving_export_raises_by_name():
    model = build_detector(dict(type="FastRCNN", backbone=R18_P2, neck=FPN_P2, bbox_head=BBOX),
                           "float32", device="cpu")
    with pytest.raises(ValueError, match="FastRCNNConfig"):
        make_serving_fn(model, FastRCNNConfig(num_classes=4))
    with pytest.raises(ValueError, match="proposals"):
        export_serving(model, FastRCNNConfig(num_classes=4), 1, (64, 64))
