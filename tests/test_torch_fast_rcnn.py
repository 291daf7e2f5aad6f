"""The port's Fast R-CNN against the JAX package's: inference on a proposal
slate with invalid rows, the loss with every gradient, the detection
config, and a training step through ``Trainer``.

The detector is ``test_torch_train.py``'s without the RPN: ResNet-18 with
``frozen_stages=1``, FPN 16 channels, box head fc 32, 3 classes, 64 x 64
images, batch 2, randomised FrozenBN, on the JAX variables converted by
``from_jax_variables`` and loaded with ``strict=True``. Both sides run in
float32 on the CPU. The proposals are (B, P, 5) slates (the score column is
ignored) of jittered gt copies and random boxes, their tail padded with
invalid zero rows, as the collate pads them.

The sampling draws are the reference's own: ``jax.random.split(key, B)``,
one key an image, split into ``k_pos, k_all``. Tolerances: detections as
``test_torch_model.py`` (identical ``valid`` and ``labels``, boxes 1e-3,
scores 1e-5); losses rtol 1e-5; gradients atol = rtol = 1e-4.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_mask_rcnn import _Loader
from test_torch_model import _randomise_frozen_bn
from test_torch_train import GRAD_TOL, TRAIN_MODEL, FixedNoise, _batch, _is_frozen
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import FastRCNN as JaxFastRCNN
from torch_detection_tpu.models.detectors import FastRCNNConfig as JaxFastRCNNConfig
from torch_detection_tpu.models.detectors import fast_rcnn_inference as jax_fast_rcnn_inference
from torch_detection_tpu.models.detectors import fast_rcnn_loss as jax_fast_rcnn_loss
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule, make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    FastRCNN,
    FastRCNNConfig,
    fast_rcnn_inference,
    fast_rcnn_loss,
)
from torch_detection_tpu_torch.parallel import make_optimizer
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "fast_rcnn_r50_fpn_coco.py"
FAST_MODEL = {k: v for k, v in TRAIN_MODEL.items() if k != "rpn_head"}
DET = dict(num_classes=3, rcnn_num_samples=16, max_detections=8)
SLATES = {"proposals": 24, "fewer_than_the_samples": 8}  # P; with G = 4, 8 + 4 < 16 samples


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as ``test_torch_train.py``: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _proposals(rng, gt_boxes, gt_valid, p):
    """(B, P, 5) proposals of 64 x 64 images: jittered copies of the valid
    gts and random boxes, a random score column, the last quarter of the
    rows invalid zeros; and their (B, P) validity."""
    b = gt_boxes.shape[0]
    n = p - p // 4
    props = np.zeros((b, p, 5), np.float32)
    for i in range(b):
        gts = gt_boxes[i][gt_valid[i]]
        src = gts[rng.integers(0, len(gts), n // 2)]
        wh = np.repeat(src[:, 2:] - src[:, :2], 2, axis=1)
        jittered = src + rng.uniform(-0.25, 0.25, src.shape) * wh
        xy = rng.uniform(0, 48, (n - n // 2, 2))
        rand = np.concatenate([xy, xy + rng.uniform(4, 16, xy.shape)], axis=1)
        props[i, :n, :4] = np.clip(np.concatenate([jittered, rand]), 0, 63)
        props[i, :n, 4] = rng.uniform(0, 1, n)
    return props, np.arange(p)[None, :].repeat(b, 0) < n


def _jax_fast_draws(key, b, n):
    """One key an image (``split(key, B)``), split into ``k_pos, k_all``."""
    u_pos, u_all = [], []
    for k in jax.random.split(key, b):
        k_pos, k_all = jax.random.split(k)
        u_all.append(np.asarray(jax.random.uniform(k_all, (n,), minval=0.0, maxval=0.5)))
        u_pos.append(np.asarray(jax.random.uniform(k_pos, (n,))))
    return [(np.stack(u_pos), np.stack(u_all))]


@pytest.fixture(scope="module")
def fast():
    """Both detectors on the same weights; the reference's detections, and
    its losses and gradients on each proposal slate."""
    rng = np.random.default_rng(0)
    jax_model = JaxFastRCNN(**FAST_MODEL)
    jax_cfg = JaxFastRCNNConfig(**DET)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    roi_vars = jax_model.init(jax.random.PRNGKey(1), jnp.zeros((2, 8, 7, 7, 16)),
                              method=JaxFastRCNN.roi_forward)
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **roi_vars["params"]},
         "batch_stats": variables["batch_stats"]},
        rng,
    )
    key = jax.random.PRNGKey(7)

    def loss_fn(params, batch):
        out = jax_fast_rcnn_loss(jax_cfg, jax_model,
                                 {"params": params, "batch_stats": variables["batch_stats"]},
                                 batch, key)
        return out["loss"], out

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    batches, want = {}, {}
    for name, p in SLATES.items():
        batch = _batch(rng)
        batch["proposals"], batch["proposal_valid"] = _proposals(rng, batch["gt_boxes"],
                                                                 batch["gt_valid"], p)
        (_, losses), grads = grad_fn(variables["params"], batch)
        batches[name] = {k: torch.from_numpy(v) for k, v in batch.items()}
        want[name] = dict(losses={k: float(v) for k, v in losses.items()}, grads=grads,
                          draws=_jax_fast_draws(key, 2, p + batch["gt_boxes"].shape[1]))

    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    props, valid = _proposals(rng, batch["gt_boxes"], batch["gt_valid"], 32)
    x = dict(images=images, proposals=props, proposal_valid=valid,
             img_shapes=np.array([[64, 64], [60, 56]], np.float32),
             scale_factors=np.array([1.0, 2.0], np.float32))
    infer = jax.jit(lambda v, *a: jax_fast_rcnn_inference(jax_cfg, jax_model, v, *a))
    dets = jax.tree_util.tree_map(np.asarray, infer(variables, *x.values()))

    def make_model():
        model = FastRCNN(**FAST_MODEL, device="cpu")
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        return model.to(memory_format=torch.channels_last).train()

    return dict(make_model=make_model, cfg=FastRCNNConfig(**DET), batches=batches, want=want,
                x={k: torch.from_numpy(v) for k, v in x.items()}, dets=dets, variables=variables)


def test_state_dict_keys_are_the_flax_paths(fast):
    model = fast["make_model"]()
    keys = set(model.state_dict())
    assert keys == set(from_jax_variables(fast["variables"], model))
    assert "bbox_head.fc1.weight" in keys and not any(k.startswith("rpn.") for k in keys)


def test_fast_rcnn_inference_matches(fast):
    """A (B, P, 5) slate whose last rows are invalid, (B,) scale factors;
    through ``make_inference_fn``'s five-argument ``infer``."""
    x, want = fast["x"], fast["dets"]
    infer = make_inference_fn(fast["make_model"]().eval(), fast["cfg"])
    got = infer(x["images"], x["img_shapes"], x["scale_factors"], x["proposals"],
                x["proposal_valid"])
    assert not bool(x["proposal_valid"].all()) and bool(got.valid.any())
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-5, rtol=0)
    # the invalid proposals score 0 and never become detections
    invalid = ~x["proposal_valid"].gather(1, got.indices.clamp(min=0))
    assert not bool((got.valid & invalid).any())
    with torch.no_grad():
        direct = fast_rcnn_inference(fast["cfg"], fast["make_model"]().eval(), x["images"],
                                     x["proposals"][..., :4], x["proposal_valid"],
                                     x["img_shapes"], x["scale_factors"])
    torch.testing.assert_close(direct.boxes, got.boxes, atol=0, rtol=0)


@pytest.mark.parametrize("slate", SLATES)
def test_fast_rcnn_loss_and_gradients_match(fast, slate):
    want, batch = fast["want"][slate], fast["batches"][slate]
    model = fast["make_model"]()
    got = fast_rcnn_loss(fast["cfg"], model, batch, FixedNoise(want["draws"]))
    assert set(got) == set(want["losses"]) and want["losses"]["num_pos_rois"] > 0
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-5, atol=0, err_msg=k)
    got["loss"].backward()
    grads = from_jax_variables({"params": want["grads"]}, model)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(grads)
    for name, p in model.named_parameters():
        if _is_frozen(name):
            assert not p.requires_grad and p.grad is None, name
        else:
            np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(), **GRAD_TOL,
                                       err_msg=name)


def test_detection_cfg_matches_reference():
    cfg = builder.build_detection_cfg(Config.fromfile(CONFIG).detection)
    want = jax_builder.build_detection_cfg(JaxConfig.fromfile(CONFIG).detection)
    assert type(cfg) is FastRCNNConfig and not want.approx_top_k
    for field in ("num_classes", "roi_strides", "roi_size", "finest_scale", "rcnn_num_samples",
                  "rcnn_pos_fraction", "rcnn_target_means", "rcnn_target_stds",
                  "smooth_l1_beta", "score_thr", "nms_iou_thr", "max_detections"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_assigner_key_sets_the_rcnn_assigner():
    det = dict(style="fast_rcnn", num_classes=3,
               assigner=dict(pos_iou_thr=0.6, neg_iou_thr=0.4, min_pos_iou=0.3))
    cfg = builder.build_detection_cfg(det)
    want = jax_builder.build_detection_cfg(det)
    for field in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
        assert getattr(cfg.rcnn_assigner, field) == getattr(want.rcnn_assigner, field), field
    assert cfg.rcnn_assigner.pos_iou_thr == 0.6


def test_full_width_fast_rcnn_answers_on_cpu():
    """The config's detector at full width (R50, FPN 256, 80 classes, no
    RPN) through ``make_inference_fn``, on 64 proposals and 8 detections."""
    cfg = Config.fromfile(CONFIG)
    model = builder.build_detector(cfg.model, "float32", device="cpu", seed=0)
    # Faster R-CNN's 41 429 156 less the RPN's conv (590 080), cls (771) and reg (3 084)
    assert sum(p.numel() for p in model.parameters()) == 41_429_156 - 593_935
    det_cfg = builder.build_detection_cfg(dict(cfg.detection, max_detections=8))
    g = torch.Generator().manual_seed(0)
    xy = torch.rand((1, 64, 2), generator=g) * 60
    props = torch.cat([xy, xy + 4 + torch.rand((1, 64, 2), generator=g) * 30], dim=-1)
    res = make_inference_fn(model, det_cfg)(
        torch.randn((1, 64, 96, 3), generator=g), torch.tensor([[64.0, 96.0]]),
        torch.tensor([2.0]), props, torch.ones((1, 64), dtype=torch.bool))
    assert res.boxes.shape == (1, 8, 4) and bool(res.valid.any())
    assert float(res.boxes[res.valid].max()) <= 95.0 / 2.0


def test_trainer_steps_the_fast_rcnn(fast):
    """Two steps through ``build_loss_fn`` and ``Trainer``, the proposals
    carried on the batch."""
    model = fast["make_model"]()
    loss_fn = builder.build_loss_fn(model, fast["cfg"], rng_seed=3)
    before = model.bbox_head.fc1.weight.detach().clone()
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(0.01, 2), 0.9, 1e-4, 1.0)
    batch = fast["batches"]["proposals"]
    history = Trainer(loss_fn, model, optimizer, _Loader([batch, batch]), log_interval=1).run(1)
    assert len(history) == 2 and all(h["skipped_steps"] == 0 for h in history)
    assert all(np.isfinite(h["loss_rcnn_cls"]) and h["num_pos_rois"] > 0 for h in history)
    assert not torch.equal(model.bbox_head.fc1.weight.detach(), before)
