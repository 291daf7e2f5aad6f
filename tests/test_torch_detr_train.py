"""The port's DETR set loss against the JAX package's: the matching cost
against NumPy and scipy, the batched one-call matching against problem by
problem, the losses and every gradient under the reference's own matching,
the R7 pin, and a step through ``Trainer`` with the config's AdamW.

The detector, weights and batch are ``test_torch_detr.py``'s (the second
image padded, 3 and 2 gts of 4 slots). The losses and gradients are compared
under the reference's matching: the reference's cost (its scalar GIoU term
included, R7) and matcher give ``col4row``, which the port's ``set_losses``
takes. Tolerances: losses rtol 1e-5, gradients atol = rtol = 1e-4
(``test_torch_train.py``'s), the cost atol 1e-5 against float64.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from test_torch_detr import MODEL, batch, make_port, randomise
from test_torch_mask_rcnn import _Loader
from test_torch_train import GRAD_TOL, _is_frozen
from torch_detection_tpu.models.detectors import DETR as JaxDETR
from torch_detection_tpu.models.detectors import DETRConfig as JaxDETRConfig
from torch_detection_tpu.models.detectors import detr_loss as jax_detr_loss
from torch_detection_tpu.models.detectors.detr import _cxcywh_to_xyxy_cont, _gt_to_cxcywh
from torch_detection_tpu.ops.hungarian import linear_sum_assignment as jax_lsa
from torch_detection_tpu.ops.losses import iou_loss as jax_iou_loss
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import DETRConfig
from torch_detection_tpu_torch.models.detectors.detr import (
    cxcywh_to_xyxy,
    gt_to_cxcywh,
    loss_layers,
    match,
    matching_cost,
    set_losses,
)
from torch_detection_tpu_torch.ops.hungarian import linear_sum_assignment_plain
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "detr_r50_coco.py"
DET = dict(num_classes=3, num_queries=8, max_detections=10)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as ``test_torch_train.py``: the test workers
    share the cores, and a tiny train step takes far longer with many."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _reference_matching(cfg, cls, box, b):
    """The reference's ``col4row`` (L', B, G): ``_layer_loss``'s cost as its
    code computes it, its GIoU term the scalar ``iou_loss`` returns (R7),
    and its matcher, on the layers its loss reads."""
    n = cls.shape[0] if cfg.aux_loss else 1
    cls, box = cls[-n:], box[-n:]

    def one(logits, boxes, gt_boxes, labels, valid, hw):
        gt = _gt_to_cxcywh(gt_boxes, hw)
        gt = jnp.where(valid[:, None], gt, 0.5)
        probs = jax.nn.softmax(logits, axis=-1)
        lab0 = jnp.clip(labels - 1, 0, probs.shape[-1] - 2)
        cost_cls = -probs[:, lab0].T
        cost_l1 = jnp.sum(jnp.abs(gt[:, None, :] - boxes[None, :, :]), axis=-1)
        cost_giou = jax_iou_loss(_cxcywh_to_xyxy_cont(boxes)[None],
                                 _cxcywh_to_xyxy_cont(gt)[:, None], mode="giou", offset=0.0) - 1.0
        cost = cfg.cls_weight * cost_cls + cfg.bbox_weight * cost_l1 + cfg.giou_weight * cost_giou
        return jax_lsa(cost, row_valid=valid)

    per_image = jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0))
    per_layer = jax.vmap(per_image, in_axes=(0, 0, None, None, None, None))
    return np.array(jax.jit(per_layer)(cls, box, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                                       b["img_shape"]))


@pytest.fixture(scope="module")
def detr_train():
    """The reference's forward, losses, gradients and matching on
    ``test_torch_detr.py``'s randomised weights and batch, with and without
    the auxiliary losses."""
    rng = np.random.default_rng(0)
    jax_model = JaxDETR(**MODEL)
    b = batch(rng)
    variables = randomise(jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(b["image"])), rng)
    rest = {k: v for k, v in variables.items() if k != "params"}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    out = dict(variables=variables, batch=b,
               torch_batch={k: torch.from_numpy(v) for k, v in b.items()})
    for aux in (True, False):
        jax_cfg = JaxDETRConfig(**DET, aux_loss=aux)

        def loss_fn(params):
            cls, box = jax_model.apply({"params": params, **rest}, jb["image"],
                                       img_shapes=jb["img_shape"], train=True)
            losses = jax_detr_loss(jax_cfg, cls, box, jb["gt_boxes"], jb["gt_labels"],
                                   jb["gt_valid"], jb["img_shape"])
            return losses["loss"], (losses, cls, box)

        (_, (losses, cls, box)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            variables["params"])
        cls, box = np.array(cls), np.array(box)
        out[aux] = dict(cls=cls, box=box, losses={k: float(v) for k, v in losses.items()},
                        grads=grads, col4row=_reference_matching(jax_cfg, cls, box, b))
    return out


def _numpy_cost(logits, boxes, gt, labels):
    """The paper's matching cost of one layer and image in float64: minus
    the softmax probability of the gt's class, 5 x L1 of the normalised
    cxcywh boxes, 2 x -GIoU of each pair as xyxy."""
    z = logits.astype(np.float64)
    p = np.exp(z - z.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    lab = np.clip(labels - 1, 0, logits.shape[-1] - 2)
    g, q = gt[:, None].astype(np.float64), boxes[None].astype(np.float64)
    l1 = np.abs(g - q).sum(-1)

    def xyxy(b):
        return np.concatenate([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], -1)

    g, q = xyxy(g), xyxy(q)
    inter = np.clip(np.minimum(g[..., 2:], q[..., 2:]) - np.maximum(g[..., :2], q[..., :2]),
                    0, None).prod(-1)
    union = (g[..., 2:] - g[..., :2]).prod(-1) + (q[..., 2:] - q[..., :2]).prod(-1) - inter
    enclose = (np.maximum(g[..., 2:], q[..., 2:]) - np.minimum(g[..., :2], q[..., :2])).prod(-1)
    giou = inter / union - (enclose - union) / enclose
    return -p[:, lab].T + 5 * l1 - 2 * giou


def test_gt_conversion_matches_reference(detr_train):
    b = detr_train["batch"]
    got = gt_to_cxcywh(*(torch.from_numpy(b[k]) for k in ("gt_boxes", "gt_valid", "img_shape")))
    for i in range(2):
        want = np.asarray(_gt_to_cxcywh(jnp.asarray(b["gt_boxes"][i]),
                                        jnp.asarray(b["img_shape"][i])))
        want = np.where(b["gt_valid"][i][:, None], want, 0.5)
        np.testing.assert_allclose(got[i].numpy(), want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(cxcywh_to_xyxy(got).numpy(),
                               np.asarray(_cxcywh_to_xyxy_cont(jnp.asarray(got.numpy()))),
                               rtol=1e-6, atol=1e-7)


def test_matching_cost_is_the_official_one_and_the_match_is_optimal(detr_train):
    """The port's cost against an independent NumPy formula, and its
    matching against scipy's optimum of that cost, every layer and image."""
    b, cfg = detr_train["torch_batch"], DETRConfig(**DET)
    ref = detr_train[True]
    gt = gt_to_cxcywh(b["gt_boxes"], b["gt_valid"], b["img_shape"])
    cost = matching_cost(cfg, torch.from_numpy(ref["cls"]), torch.from_numpy(ref["box"]), gt,
                         b["gt_labels"])
    col4row = match(cost, b["gt_valid"]).numpy()
    cost = cost.numpy()
    assert cost.shape == (2, 2, 4, 8)
    for layer in range(2):
        for i in range(2):
            valid = detr_train["batch"]["gt_valid"][i]
            want = _numpy_cost(ref["cls"][layer, i], ref["box"][layer, i], gt[i].numpy(),
                               detr_train["batch"]["gt_labels"][i])
            np.testing.assert_allclose(cost[layer, i][valid], want[valid], atol=1e-5, rtol=1e-5)
            sub = cost[layer, i][valid]
            rows, cols = scipy_lsa(sub)
            got = col4row[layer, i][valid]
            np.testing.assert_allclose(sub[np.arange(len(got)), got].sum(), sub[rows, cols].sum(),
                                       rtol=1e-6)
            assert (col4row[layer, i][~valid] == -1).all()


def test_one_matcher_call_equals_each_problem_alone(detr_train):
    """``match`` solves every layer's and image's problem in one batched
    call (one kernel launch on the card); each equals the problem solved
    alone."""
    b, cfg = detr_train["torch_batch"], DETRConfig(**DET)
    ref = detr_train[True]
    gt = gt_to_cxcywh(b["gt_boxes"], b["gt_valid"], b["img_shape"])
    cost = matching_cost(cfg, torch.from_numpy(ref["cls"]), torch.from_numpy(ref["box"]), gt,
                         b["gt_labels"])
    batched = match(cost, b["gt_valid"])
    assert batched.shape == (2, 2, 4) and batched.dtype == torch.int32
    for layer in range(2):
        for i in range(2):
            alone = linear_sum_assignment_plain(cost[layer, i][None], b["gt_valid"][i][None])[0]
            assert torch.equal(batched[layer, i], alone), (layer, i)


@pytest.mark.parametrize("aux", [True, False])
def test_losses_and_every_gradient_match_under_the_reference_matching(detr_train, aux):
    """The set losses on the port's forward, under the reference's own
    matching, on every decoder layer (``aux_loss``) or the last alone: each
    loss and every parameter's gradient, ``query_embed`` and the frozen
    stem's none among them."""
    ref, b = detr_train[aux], detr_train["torch_batch"]
    cfg = DETRConfig(**DET, aux_loss=aux)
    model = make_port(detr_train["variables"]).train()
    cls, box = loss_layers(cfg, *model(b["image"], b["img_shape"]))
    gt = gt_to_cxcywh(b["gt_boxes"], b["gt_valid"], b["img_shape"])
    losses = set_losses(cfg, cls, box, gt, b["gt_labels"], b["gt_valid"],
                        torch.from_numpy(ref["col4row"]))
    for key in ("loss", "loss_cls", "loss_l1", "loss_giou", "num_pos"):
        np.testing.assert_allclose(float(losses[key].detach()), ref["losses"][key], rtol=1e-5,
                                   err_msg=key)
    losses["loss"].backward()
    want = from_jax_variables({"params": ref["grads"]}, model)
    assert np.abs(want["query_embed"].numpy()).sum() > 0
    for name, p in model.named_parameters():
        if _is_frozen(name):
            assert p.grad is None and not want[name].any(), name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_reference_giou_cost_is_a_scalar_pin_r7():
    """R7: the reference's GIoU matching cost sums the (G, Q) matrix to one
    scalar, so only L1 and the class decide its matching. One gt 0.02 wide
    centred at (0.09, 0.09), and two queries with equal logits: a box of the
    gt's size moved by 0.03 in x and y (L1 0.06, GIoU -0.68) and a box 0.09
    wide around the gt (L1 0.14, GIoU 0.049). L1 alone takes the moved box;
    the per-pair cost, 5 L1 - 2 GIoU, the one around the gt, as scipy's
    optimum of that cost."""
    gt_boxes = np.array([[[8, 8, 9, 9]]], np.float32)  # continuous [8, 10], on 100 x 100
    shapes = np.array([[100, 100]], np.float32)
    boxes = np.array([[[[0.12, 0.12, 0.02, 0.02], [0.09, 0.09, 0.09, 0.09]]]], np.float32)
    labels, valid = np.array([[1]], np.int32), np.array([[True]])
    logits = np.zeros((1, 1, 2, 4), np.float32)
    gt = _gt_to_cxcywh(jnp.asarray(gt_boxes[0]), jnp.asarray(shapes[0]))
    pair = jax_iou_loss(_cxcywh_to_xyxy_cont(jnp.asarray(boxes[0, 0]))[None],
                        _cxcywh_to_xyxy_cont(gt)[:, None], mode="giou", offset=0.0)
    assert pair.shape == ()  # the reference's cost_giou: one number for the whole matrix
    b = dict(gt_boxes=gt_boxes, gt_labels=labels, gt_valid=valid, img_shape=shapes)
    reference = _reference_matching(JaxDETRConfig(**DET), logits, boxes, b)
    cfg = DETRConfig(**DET)
    gt_t = gt_to_cxcywh(torch.from_numpy(gt_boxes), torch.from_numpy(valid),
                        torch.from_numpy(shapes))
    cost = matching_cost(cfg, torch.from_numpy(logits), torch.from_numpy(boxes), gt_t,
                         torch.from_numpy(labels))
    port = match(cost, torch.from_numpy(valid)).numpy()
    _, optimum = scipy_lsa(cost[0, 0].numpy())
    assert port[0, 0, 0] == optimum[0] == 1
    assert reference[0, 0, 0] == 0


def test_trainer_steps_detr_with_adamw(detr_train):
    """Two steps through ``build_train_objects`` (the config's AdamW, clip
    and schedule; float32 parameters, bf16 compute), ``build_loss_fn`` and
    ``Trainer``: finite losses, no step skipped, no frozen parameter moved,
    and every trainable one with a gradient did, ``query_embed`` among them."""
    cfg = Config.fromfile(CONFIG)
    small = dict(cfg, model=dict(MODEL, type="DETR"),
                 detection=dict(cfg.detection, num_classes=3, num_queries=8))
    b = detr_train["torch_batch"]
    model, det_cfg, loader, optimizer = builder.build_train_objects(small, "cpu",
                                                                    loader=_Loader([b, b]))
    assert isinstance(det_cfg, DETRConfig) and det_cfg.eos_coef == 0.1 and det_cfg.aux_loss
    assert isinstance(optimizer.torch_optimizer, torch.optim.AdamW)
    group = optimizer.torch_optimizer.param_groups[0]
    assert (group["weight_decay"], group["betas"], group["eps"]) == (1e-4, (0.9, 0.999), 1e-8)
    assert optimizer.grad_clip_norm == 0.1 and optimizer.schedule(0) == pytest.approx(1e-4 / 3)
    assert model.dtype == torch.bfloat16 and model.query_embed.dtype == torch.float32
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
    assert {"query_embed", "input_proj.weight", "decoder1.cross_attn.query.weight",
            "encoder0.self_attn.key.weight", "class_embed.bias", "bbox_out.weight"} <= moved
    assert not any(_is_frozen(n) for n in moved)
