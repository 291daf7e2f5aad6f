"""The port's Sparse R-CNN against the JAX package's: ``iou_loss``, the flax
blocks (LayerNorm, attention, ``_DynamicConv``, ``_DIIHead``), the weights'
conversion, the forward of every stage, the decode, the set losses with
every gradient, the matching cost and the R7 pin, the config, a full-width
build, a step through ``Trainer``, and AdamW against optax.

The detector is ``tests/test_sparse_rcnn.py``'s: ResNet-18 with
``frozen_stages=1``, FPN 32 channels on P2-P5, d_model 32, 4 heads, FFN 64,
dynamic dim 16, 8 proposals, 2 stages, 3 classes, on 64 x 64 images, batch
2, randomised FrozenBN, LayerNorms, proposal boxes and class biases. Both
sides run in float32 on the CPU, the port on the JAX variables converted by
``from_jax_variables`` and loaded with ``strict=True``; the reference's
RoIAlign takes its CPU path (``impl="pallas"`` runs the fused version off
the TPU).

The losses and gradients are compared under the reference's matching:
the reference's cost (its scalar GIoU term included, R7) and matcher give
``col4row``, which the port's ``set_losses`` takes. Tolerances: blocks and
logits atol 1e-4 (float32 sums in another order), boxes atol 1e-3 px,
losses rtol 1e-5, gradients atol = rtol = 1e-4 (``test_torch_train.py``'s),
the decode's indices and labels exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from scipy.optimize import linear_sum_assignment as scipy_lsa

from test_torch_mask_rcnn import _Loader
from test_torch_model import _randomise_frozen_bn
from test_torch_train import GRAD_TOL, _is_frozen, jax_lr_schedule
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import SparseRCNN as JaxSparseRCNN
from torch_detection_tpu.models.detectors import SparseRCNNConfig as JaxSparseRCNNConfig
from torch_detection_tpu.models.detectors import decode_sparse_rcnn as jax_decode
from torch_detection_tpu.models.detectors import sparse_rcnn_loss as jax_sparse_rcnn_loss
from torch_detection_tpu.models.detectors.sparse_rcnn import _DIIHead, _DynamicConv
from torch_detection_tpu.ops.hungarian import linear_sum_assignment as jax_lsa
from torch_detection_tpu.ops.losses import iou_loss as jax_iou_loss
from torch_detection_tpu.parallel import make_optimizer as jax_make_optimizer
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule, make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    SparseRCNN,
    SparseRCNNConfig,
    decode_sparse_rcnn,
)
from torch_detection_tpu_torch.models.detectors.sparse_rcnn import (
    DIIHead,
    DynamicConv,
    match,
    matching_cost,
    set_losses,
    set_targets,
)
from torch_detection_tpu_torch.models.layers import LayerNorm, MultiHeadDotProductAttention
from torch_detection_tpu_torch.ops.losses import iou_loss, iou_loss_elementwise
from torch_detection_tpu_torch.parallel import make_optimizer, make_train_step
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "sparse_rcnn_r50_fpn_coco.py"
MODEL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3),
                  frozen_stages=1, norm_cfg=dict(type="FrozenBN")),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=4),
    num_proposals=8, num_stages=2, num_classes=3, d_model=32, nhead=4, dim_feedforward=64,
    dynamic_dim=16,
)
DET = dict(num_classes=3, num_proposals=8, max_detections=10)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as ``test_torch_train.py``: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _randomise(variables, rng):
    """FrozenBN statistics, every LayerNorm's scale and bias, the class
    biases and the proposal boxes drawn from ``rng``: flax's inits would
    leave the conversion of each untested, and identical proposal boxes
    would route every roi alike."""
    variables = _randomise_frozen_bn(variables, rng)
    params = variables["params"]

    def walk(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                if set(value) == {"scale", "bias"} and "norm" in key:
                    n = value["scale"].shape
                    value["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                    value["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
                elif key == "fc_cls":
                    value["bias"] = rng.normal(-2.0, 0.5, value["bias"].shape).astype(np.float32)
                else:
                    walk(value)

    walk(params)
    boxes = np.asarray(params["proposal_boxes"])
    params["proposal_boxes"] = (boxes + rng.uniform(-0.2, 0.2, boxes.shape)
                                * np.float32([1, 1, 0.6, 0.6])).astype(np.float32)
    return variables


def _batch(rng):
    """Two images with 3 and 2 gts of 4 slots; labels 1-based."""
    gt_boxes = np.array([[[4, 6, 30, 28], [20, 10, 60, 50], [40, 40, 55, 62], [0, 0, 0, 0]],
                         [[2, 2, 20, 30], [30, 8, 50, 40], [0, 0, 0, 0], [0, 0, 0, 0]]], np.float32)
    return dict(
        image=rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
        gt_boxes=gt_boxes,
        gt_labels=np.array([[1, 3, 2, 0], [2, 2, 0, 0]], np.int32),
        gt_valid=np.array([[True, True, True, False], [True, True, False, False]]),
        img_shape=np.array([[64, 64], [60, 56]], np.float32),
    )


def _reference_matching(cfg, cls, box, batch):
    """The reference's ``col4row`` (S, B, G): ``_stage_loss``'s cost as its
    code computes it, its GIoU term the scalar ``iou_loss`` returns (R7),
    and its matcher."""
    c = cls.shape[-1]

    def one(logits, boxes, gt_boxes, labels, valid, hw):
        whwh = jnp.stack([hw[1], hw[0], hw[1], hw[0]])
        gt = jnp.concatenate([gt_boxes[:, :2], gt_boxes[:, 2:] + 1.0], axis=-1)
        gt = jnp.where(valid[:, None], gt, 0.0)
        p = jax.nn.sigmoid(logits)
        lab0 = jnp.clip(labels - 1, 0, c - 1)
        pos = -jnp.log(p + 1e-8) * cfg.focal_alpha * (1 - p) ** cfg.focal_gamma
        neg = -jnp.log(1 - p + 1e-8) * (1 - cfg.focal_alpha) * p ** cfg.focal_gamma
        cost_cls = (pos - neg)[:, lab0].T
        cost_l1 = jnp.sum(jnp.abs(gt[:, None] / whwh - boxes[None] / whwh), axis=-1)
        cost_giou = jax_iou_loss(boxes[None], gt[:, None], mode="giou", offset=0.0) - 1.0
        cost = cfg.cls_weight * cost_cls + cfg.l1_weight * cost_l1 + cfg.giou_weight * cost_giou
        return jax_lsa(cost, row_valid=valid)

    per_image = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))
    per_stage = jax.vmap(per_image, in_axes=(0, 0, None, None, None, None))
    return np.array(jax.jit(per_stage)(cls, box, batch["gt_boxes"], batch["gt_labels"],
                                       batch["gt_valid"], batch["img_shape"]))


@pytest.fixture(scope="module")
def sparse():
    """The reference's forward, losses, gradients and matching on randomised
    weights, and a maker of the port's detector on the same weights."""
    rng = np.random.default_rng(0)
    jax_model = JaxSparseRCNN(**MODEL)
    variables = _randomise(jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                                   jnp.zeros((2, 64, 64, 3))), rng)
    batch = _batch(rng)
    jax_cfg = JaxSparseRCNNConfig(**DET)
    rest = {k: v for k, v in variables.items() if k != "params"}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params):
        cls, box = jax_model.apply({"params": params, **rest}, jb["image"],
                                   img_shapes=jb["img_shape"], train=True)
        losses = jax_sparse_rcnn_loss(jax_cfg, cls, box, jb["gt_boxes"], jb["gt_labels"],
                                      jb["gt_valid"], jb["img_shape"])
        return losses["loss"], (losses, cls, box)

    (_, (losses, cls, box)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    cls, box = np.array(cls), np.array(box)

    def make_model():
        model = SparseRCNN(**MODEL, device="cpu")
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        return model.to(memory_format=torch.channels_last).train()

    return dict(
        make_model=make_model, variables=variables, jax_model=jax_model, jax_cfg=jax_cfg,
        batch=batch, torch_batch={k: torch.from_numpy(v) for k, v in batch.items()},
        cls=cls, box=box, losses={k: float(v) for k, v in losses.items()}, grads=grads,
        col4row=_reference_matching(jax_cfg, cls, box, batch),
    )


@pytest.mark.parametrize("mode", ["iou", "giou", "linear_iou", "square_iou"])
def test_iou_loss_matches(mode):
    rng = np.random.default_rng(1)
    lo = rng.uniform(0, 50, (6, 7, 2))
    pred = np.concatenate([lo, lo + rng.uniform(1, 40, (6, 7, 2))], -1).astype(np.float32)
    lo = rng.uniform(0, 50, (6, 7, 2))
    target = np.concatenate([lo, lo + rng.uniform(1, 40, (6, 7, 2))], -1).astype(np.float32)
    weight = rng.uniform(0, 1, (6, 7)).astype(np.float32)
    for offset in (0.0, 1.0):
        got = iou_loss(torch.from_numpy(pred), torch.from_numpy(target), torch.from_numpy(weight),
                       mode, offset, avg_factor=torch.tensor(5.0))
        want = jax_iou_loss(pred, target, weight, mode, offset, avg_factor=5.0)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
        plain = iou_loss(torch.from_numpy(pred), torch.from_numpy(target), mode=mode, offset=offset)
        np.testing.assert_allclose(float(plain), float(jax_iou_loss(pred, target, mode=mode,
                                                                    offset=offset)), rtol=1e-5)


def test_pairwise_giou_is_each_pair_of_the_aligned_loss():
    rng = np.random.default_rng(2)
    # each row sorted: x1 <= y1 <= x2 <= y2, a well-formed box
    pb = torch.from_numpy(np.sort(rng.uniform(0, 60, (5, 4)), -1).astype(np.float32))
    gt = torch.from_numpy(np.sort(rng.uniform(0, 60, (3, 4)), -1).astype(np.float32))
    pairs = iou_loss_elementwise(pb[None], gt[:, None], "giou", offset=0.0)
    assert pairs.shape == (3, 5)
    for g in range(3):
        for q in range(5):
            want = jax_iou_loss(np.asarray(pb[q]), np.asarray(gt[g]), mode="giou", offset=0.0)
            np.testing.assert_allclose(float(pairs[g, q]), float(want), rtol=1e-6)


def _flax_block(name, rng):
    """(flax module, its inputs, the port module): LayerNorm, attention,
    ``_DynamicConv`` and ``_DIIHead`` at the test's widths."""
    obj = rng.normal(size=(2, 8, 32)).astype(np.float32)
    feats = rng.normal(size=(2, 8, 7, 7, 32)).astype(np.float32)
    f32 = dict(dtype=torch.float32, param_dtype=torch.float32, device="cpu")
    return {
        "layer_norm": (fnn.LayerNorm(dtype=jnp.float32), (obj,), LayerNorm(32)),
        "attention": (fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=32),
                      (obj, obj, obj), MultiHeadDotProductAttention(32, 4)),
        "dynamic_conv": (_DynamicConv(32, 16, 7), (feats, obj), DynamicConv(32, 16, 7, **f32)),
        "dii_head": (_DIIHead(3, 32, 4, 64, 16, 7), (feats, obj),
                     DIIHead(3, 32, 4, 64, 16, 7, 1, 3, **f32)),
    }[name]


@pytest.mark.parametrize("name", ["layer_norm", "attention", "dynamic_conv", "dii_head"])
def test_block_matches_flax(name):
    rng = np.random.default_rng(3)
    flax_mod, inputs, port = _flax_block(name, rng)
    variables = jax.tree_util.tree_map(np.asarray, flax_mod.init(jax.random.PRNGKey(1), *inputs))
    variables = jax.tree_util.tree_map(
        lambda v: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32), variables)
    port.load_state_dict(from_jax_variables(variables, port), strict=True)
    want = flax_mod.apply(variables, *inputs)
    args = inputs[:1] if name == "attention" else inputs
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_state_dict_is_the_flax_tree_and_rank3_kernels_convert_only_into_attention(sparse):
    model = sparse["make_model"]()
    variables = sparse["variables"]
    state = from_jax_variables(variables, model)
    assert set(state) == set(model.state_dict())
    assert state["stage1.self_attn.query.weight"].shape == (32, 32)
    assert state["stage0.self_attn.key.bias"].shape == (32,)
    q = np.asarray(variables["params"]["stage0"]["self_attn"]["query"]["kernel"])  # (32, 4, 8)
    np.testing.assert_array_equal(state["stage0.self_attn.query.weight"].numpy(),
                                  q.reshape(32, 32).T)
    out = np.asarray(variables["params"]["stage0"]["self_attn"]["out"]["kernel"])  # (4, 8, 32)
    np.testing.assert_array_equal(state["stage0.self_attn.out.weight"].numpy(),
                                  out.reshape(32, 32).T)
    bad = jax.tree_util.tree_map(lambda v: v, variables)
    bad["params"]["stage0"]["ffn_fc1"]["kernel"] = np.zeros((32, 4, 16), np.float32)
    with pytest.raises(ValueError, match="no layout for a rank-3 kernel at stage0.ffn_fc1"):
        from_jax_variables(bad, model)
    with pytest.raises(ValueError, match="no layout"):  # without the model, no attention
        from_jax_variables(variables)


def test_forward_matches_every_stage(sparse):
    model = sparse["make_model"]().eval()
    b = sparse["torch_batch"]
    with torch.no_grad():
        cls, box = model(b["image"], b["img_shape"])
    assert cls.shape == (2, 2, 8, 3) and box.shape == (2, 2, 8, 4)
    assert cls.dtype == box.dtype == torch.float32
    np.testing.assert_allclose(cls.numpy(), sparse["cls"], **TOL)
    np.testing.assert_allclose(box.numpy(), sparse["box"], atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("factors", [np.array([1.0, 2.0], np.float32),
                                     np.array([[1.0, 2.0, 1.0, 2.0], [0.5, 0.5, 0.25, 0.25]],
                                              np.float32)])
def test_decode_matches(sparse, factors):
    """Both decoders on the reference's outputs, with ties among the last
    stage's logits (the top-k gives them to the lower index)."""
    cls = sparse["cls"].copy()
    cls[-1, 0, 3] = cls[-1, 0, 1]  # query 3 ties query 1 on every class
    cfg = SparseRCNNConfig(**DET)
    shapes = sparse["batch"]["img_shape"]
    want = jax_decode(sparse["jax_cfg"], jnp.asarray(cls), jnp.asarray(sparse["box"]),
                      jnp.asarray(shapes), jnp.asarray(factors))
    got = decode_sparse_rcnn(cfg, torch.from_numpy(cls), torch.from_numpy(sparse["box"]),
                             torch.from_numpy(shapes), torch.from_numpy(factors))
    for field in ("labels", "valid", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4, rtol=1e-6)
    assert got.boxes.shape == (2, DET["max_detections"], 4)


def _port_losses(sparse, model):
    b = sparse["torch_batch"]
    cls, box = model(b["image"], b["img_shape"])
    gt_xyxy, whwh = set_targets(b["gt_boxes"], b["gt_valid"], b["img_shape"])
    return set_losses(SparseRCNNConfig(**DET), cls, box, gt_xyxy, b["gt_labels"], b["gt_valid"],
                      whwh, torch.from_numpy(sparse["col4row"]))


def test_losses_and_every_gradient_match_under_the_reference_matching(sparse):
    model = sparse["make_model"]()
    losses = _port_losses(sparse, model)
    for key in ("loss", "loss_cls", "loss_l1", "loss_giou", "num_pos"):
        np.testing.assert_allclose(float(losses[key].detach()), sparse["losses"][key], rtol=1e-5,
                                   err_msg=key)
    losses["loss"].backward()
    want = from_jax_variables({"params": sparse["grads"]}, model)
    for name, p in model.named_parameters():
        if _is_frozen(name):
            assert p.grad is None and not want[name].any(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_proposal_parameters_get_the_reference_gradients(sparse):
    """The learnable slate trains: the boxes through stage 0's delta decode
    alone, the features through every stage."""
    model = sparse["make_model"]()
    _port_losses(sparse, model)["loss"].backward()
    for name in ("proposal_boxes", "proposal_features"):
        want = np.asarray(sparse["grads"][name])
        assert np.abs(want).sum() > 0, name
        np.testing.assert_allclose(getattr(model, name).grad.numpy(), want, **GRAD_TOL)


def _numpy_cost(logits, boxes, gt, labels, whwh):
    """mmdetection's matching cost of one stage and image in float64:
    2 x focal, 5 x L1 of the whwh-normalised boxes, 2 x -GIoU of each pair
    (continuous xyxy)."""
    p = 1 / (1 + np.exp(-logits.astype(np.float64)))
    lab = np.clip(labels - 1, 0, logits.shape[-1] - 1)
    focal = (-np.log(p + 1e-8) * 0.25 * (1 - p) ** 2 + np.log(1 - p + 1e-8) * 0.75 * p ** 2)
    g, q = gt[:, None].astype(np.float64), boxes[None].astype(np.float64)
    l1 = np.abs(g / whwh - q / whwh).sum(-1)
    inter = np.clip(np.minimum(g[..., 2:], q[..., 2:]) - np.maximum(g[..., :2], q[..., :2]),
                    0, None).prod(-1)
    union = (g[..., 2:] - g[..., :2]).prod(-1) + (q[..., 2:] - q[..., :2]).prod(-1) - inter
    enclose = (np.maximum(g[..., 2:], q[..., 2:]) - np.minimum(g[..., :2], q[..., :2])).prod(-1)
    giou = inter / union - (enclose - union) / enclose
    return 2 * focal[:, lab].T + 5 * l1 - 2 * giou


def test_matching_cost_is_the_official_one_and_the_match_is_optimal(sparse):
    """The port's cost against an independent NumPy formula, and its
    matching against scipy's optimum of that cost, every stage and image."""
    b, cfg = sparse["torch_batch"], SparseRCNNConfig(**DET)
    cls, box = torch.from_numpy(sparse["cls"]), torch.from_numpy(sparse["box"])
    gt_xyxy, whwh = set_targets(b["gt_boxes"], b["gt_valid"], b["img_shape"])
    cost = matching_cost(cfg, cls, box, gt_xyxy, b["gt_labels"], whwh)
    col4row = match(cost, b["gt_valid"]).numpy()
    cost = cost.numpy()
    for s in range(cls.shape[0]):
        for i in range(2):
            valid = sparse["batch"]["gt_valid"][i]
            want = _numpy_cost(sparse["cls"][s, i], sparse["box"][s, i], gt_xyxy[i].numpy(),
                               sparse["batch"]["gt_labels"][i], whwh[i].numpy())
            np.testing.assert_allclose(cost[s, i][valid], want[valid], atol=1e-4, rtol=1e-5)
            sub = cost[s, i][valid]
            rows, cols = scipy_lsa(sub)
            got = col4row[s, i][valid]
            np.testing.assert_allclose(sub[np.arange(len(got)), got].sum(), sub[rows, cols].sum(),
                                       rtol=1e-6)
            assert (col4row[s, i][~valid] == -1).all()


def test_reference_giou_cost_is_a_scalar_pin_r7():
    """R7: the reference's GIoU matching cost sums the (G, Q) matrix to one
    scalar, so only L1 and the class decide its matching. One gt [0, 0, 2,
    2] (continuous) and two queries with equal logits: a 2 x 2 box moved by
    3 px (L1 0.12, GIoU -0.68) and a 9 x 9 box around the gt (L1 0.14,
    GIoU 0.049). L1 alone takes the moved box; the per-pair cost, 5 L1 - 2
    GIoU, the one around the gt, as scipy's optimum of that cost."""
    boxes = np.array([[[[3, 3, 5, 5], [0, 0, 9, 9]]]], np.float32)  # (S, B, Q, 4)
    gt = np.array([[[0, 0, 1, 1]]], np.float32)  # inclusive, so [0, 0, 2, 2] continuous
    labels, valid = np.array([[1]], np.int32), np.array([[True]])
    shapes = np.array([[100, 100]], np.float32)
    logits = np.zeros((1, 1, 2, 3), np.float32)
    pair = jax_iou_loss(boxes[0, 0][None], (gt[0] + [0, 0, 1, 1])[:, None], mode="giou", offset=0.0)
    assert pair.shape == ()  # the reference's cost_giou: one number for the whole matrix
    batch = dict(gt_boxes=gt, gt_labels=labels, gt_valid=valid, img_shape=shapes)
    reference = _reference_matching(JaxSparseRCNNConfig(**DET), logits, boxes, batch)
    cfg = SparseRCNNConfig(**DET)
    gt_xyxy, whwh = set_targets(torch.from_numpy(gt), torch.from_numpy(valid),
                                torch.from_numpy(shapes))
    cost = matching_cost(cfg, torch.from_numpy(logits), torch.from_numpy(boxes), gt_xyxy,
                         torch.from_numpy(labels), whwh)
    port = match(cost, torch.from_numpy(valid)).numpy()
    _, optimum = scipy_lsa(cost[0, 0].numpy())
    assert port[0, 0, 0] == optimum[0] == 1
    assert reference[0, 0, 0] == 0


def test_detection_cfg_matches_reference():
    cfg = builder.build_detection_cfg(Config.fromfile(CONFIG).detection)
    want = jax_builder.build_detection_cfg(JaxConfig.fromfile(CONFIG).detection)
    assert type(cfg) is SparseRCNNConfig
    for field in ("num_classes", "num_proposals", "cls_weight", "l1_weight", "giou_weight",
                  "focal_gamma", "focal_alpha", "score_thr", "max_detections"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_full_width_sparse_rcnn_answers_on_cpu():
    """The config's detector at full width (R50 with the plain stem, FPN 256
    on P2-P5, 100 proposals, 6 stages, 80 classes): the JAX model's
    parameter count, float32 where the reference computes in float32 in the
    bf16 serving build, and an answer through ``make_inference_fn``."""
    cfg = Config.fromfile(CONFIG)
    assert "stem_s2d" not in cfg.model["backbone"]
    jax_model = jax_builder.build_detector(JaxConfig.fromfile(CONFIG).model)
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3))))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    model = builder.build_detector(cfg.model, "bfloat16", device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == want == 106_287_816
    float32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert "proposal_boxes" in float32 and "stage5.fc_cls.weight" in float32
    assert "stage2.dynamic_conv.norm1.scale" in float32 and "stage0.fc_reg.bias" in float32
    assert model.proposal_features.dtype == model.stage3.ffn_fc1.weight.dtype == torch.bfloat16
    assert not torch.equal(model.stage0.ffn_fc1.weight, model.stage1.ffn_fc1.weight)
    infer = make_inference_fn(model, builder.build_detection_cfg(cfg.detection))
    image = torch.randn((1, 64, 96, 3), generator=torch.Generator().manual_seed(0))
    res = infer(image, torch.tensor([[64.0, 96.0]]), torch.tensor([2.0]))
    assert res.boxes.shape == (1, 100, 4) and bool(res.valid.all())
    assert torch.isfinite(res.boxes).all() and float(res.boxes.max()) <= 95.0 / 2.0
    assert int(res.indices.max()) < 100 and int(res.labels.max()) < 80


def test_trainer_steps_sparse_rcnn_with_adamw():
    """Two steps through ``build_train_objects`` (the config's AdamW, clip
    and schedule; float32 parameters, bf16 compute), ``build_loss_fn`` and
    ``Trainer``: finite losses, no step skipped, no frozen parameter moved,
    and every trainable one with a gradient did, the proposal boxes among
    them. On 64 x 64 images every roi routes to P2, so P3-P5's output convs
    get no gradient, and the config's weight decay at its warmup rate moves
    a weight by less than a float32 ulp."""
    cfg = Config.fromfile(CONFIG)
    small = dict(cfg, model=dict(MODEL, type="SparseRCNN"),
                 detection=dict(cfg.detection, num_classes=3, num_proposals=8))
    batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(5)).items()}
    model, det_cfg, loader, optimizer = builder.build_train_objects(
        small, "cpu", loader=_Loader([batch, batch]))
    assert isinstance(optimizer.torch_optimizer, torch.optim.AdamW)
    group = optimizer.torch_optimizer.param_groups[0]
    assert (group["weight_decay"], group["betas"], group["eps"]) == (1e-4, (0.9, 0.999), 1e-8)
    assert optimizer.grad_clip_norm == 1.0 and optimizer.schedule(0) == pytest.approx(2.5e-5 / 3)
    assert model.dtype == torch.bfloat16 and model.proposal_boxes.dtype == torch.float32
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    loss_fn = builder.build_loss_fn(model, det_cfg)
    reached = set()

    def recording_loss(batch, step):
        loss, metrics = loss_fn(batch, step)
        params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, [p for _, p in params], retain_graph=True,
                                    allow_unused=True)
        reached.update(n for (n, _), g in zip(params, grads) if g is not None and g.any())
        return loss, metrics

    history = Trainer(recording_loss, model, optimizer, loader, log_interval=1).run(1)
    assert len(history) == 2 and all(h["skipped_steps"] == 0 for h in history)
    for h in history:
        assert all(np.isfinite(h[k]) for k in ("loss", "loss_cls", "loss_l1", "loss_giou"))
        assert h["num_pos"] == 2.5
    moved = {n for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    assert moved == reached, (sorted(moved - reached), sorted(reached - moved))
    assert {"proposal_boxes", "proposal_features", "stage1.fc_reg.weight"} <= moved
    assert not any(_is_frozen(n) for n in moved)
    assert not any(n.startswith("neck.fpn3.") for n in reached)  # no roi on P5


def test_adamw_step_matches_optax_and_pins_r4(sparse):
    """Two AdamW steps through ``make_train_step`` against the reference's
    chain (``clip_by_global_norm``, then ``optax.adamw``) on the same
    gradients: a loss linear in the parameters, so both sides' gradients
    are its coefficients exactly (the frozen parameters' zero, as the
    reference's ``stop_gradient`` gives). R4: the reference builds AdamW
    without a frozen mask, so its weight decay moves the frozen stem and
    stage 1 by lr * wd * p each step; the port leaves them out."""
    lr, wd, clip = 1e-3, 1e-2, 1.0
    model = sparse["make_model"]()
    rng = np.random.default_rng(6)
    coef = {n: rng.normal(size=p.shape).astype(np.float32) for n, p in model.named_parameters()}
    before = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(lr, 100), 0.9, wd, clip,
                               kind="adamw")

    def loss_fn(batch, step):
        loss = sum((torch.from_numpy(coef[n]) * p).sum() for n, p in model.named_parameters()
                   if p.requires_grad)
        return loss, {}

    step = make_train_step(loss_fn, optimizer)
    for _ in range(2):
        assert float(step({})["skipped_nonfinite"]) == 0.0
    assert optimizer.steps == optimizer.count == 2

    tx = jax_make_optimizer(jax_lr_schedule(lr, 100, 12), weight_decay=wd, grad_clip_norm=clip,
                            kind="adamw")

    @jax.jit
    def reference(params, grads):
        state = tx.init(params)
        for _ in range(2):
            updates, state = tx.update(grads, state, params)
            params = optax.apply_updates(params, updates)
        return params, optax.global_norm(grads)

    params, norm = reference(before, {n: coef[n] * (not _is_frozen(n)) for n in before})
    assert float(norm) > clip  # the clip takes part
    lrs = [lr * (1 / 3 + 2 / 3 * s / 500) for s in (0, 1)]
    for name, p in model.named_parameters():
        want = np.asarray(params[name])
        if _is_frozen(name):
            np.testing.assert_array_equal(p.detach().numpy(), before[name], err_msg=name)
            np.testing.assert_allclose(want, before[name] * (1 - lrs[0] * wd) * (1 - lrs[1] * wd),
                                       rtol=1e-6, atol=0, err_msg=name)
        else:
            np.testing.assert_allclose(p.detach().numpy(), want, rtol=1e-6, atol=1e-7,
                                       err_msg=name)


def test_optimizer_types_beyond_sgd_and_adamw_are_refused():
    with pytest.raises(NotImplementedError, match="lamb"):
        make_optimizer(torch.nn.Linear(2, 2).parameters(), 0.1, kind="lamb")
