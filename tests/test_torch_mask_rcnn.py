"""The port's Mask R-CNN against the JAX package's: inference, the loss with
its gradients, the detection config, and a training run through
``Trainer``.

The detector is ``test_mask_rcnn.py``'s: ResNet-18, FPN 16 channels, box
head fc 32, 3 classes, a mask head of one conv, RoI 7 and mask 14, on 64 x 64
images, batch 2; ``frozen_stages=1`` and randomised FrozenBN as in
``test_torch_train.py``. Both sides run in float32 on the CPU, the port on
the JAX variables converted by ``from_jax_variables`` and loaded with
``strict=True``.

The sampling draws are the reference's own: the RPN's and the box head's
from ``jax.random.split(key, 2B)``, the mask slate's from
``jax.random.split(key, B)``, each image's key split into ``k_pos, k_all``.
Tolerances: detections as ``test_torch_model.py`` (identical ``valid`` and
``labels``, boxes 1e-3, scores 1e-5), ``mask_probs`` atol 1e-5; losses rtol
1e-5; gradients atol = rtol = 1e-4 (the convolutions sum in another order).
"""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_model import ANCHORS, _randomise_frozen_bn
from test_torch_train import GRAD_TOL, TRAIN_MODEL, FixedNoise, _is_frozen, _jax_draws
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import MaskRCNN as JaxMaskRCNN
from torch_detection_tpu.models.detectors import MaskRCNNConfig as JaxMaskRCNNConfig
from torch_detection_tpu.models.detectors import mask_rcnn_inference as jax_mask_rcnn_inference
from torch_detection_tpu.models.detectors import mask_rcnn_loss as jax_mask_rcnn_loss
from torch_detection_tpu.models.heads import ProposalConfig as JaxProposalConfig
from torch_detection_tpu.ops.anchors import AnchorGenerator as JaxAnchorGenerator
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer, detection_lr_schedule, make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    FasterRCNNConfig,
    MaskDetections,
    MaskRCNN,
    MaskRCNNConfig,
    mask_rcnn_inference,
    mask_rcnn_loss,
)
from torch_detection_tpu_torch.models.heads import ProposalConfig
from torch_detection_tpu_torch.ops.anchors import AnchorGenerator
from torch_detection_tpu_torch.parallel import make_optimizer
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "mask_rcnn_r50_fpn_coco.py"
MASK_MODEL = dict(TRAIN_MODEL, mask_head=dict(type="FCNMaskHead", num_classes=3, in_channels=16,
                                              conv_channels=16, num_convs=1))
PROPOSALS = dict(pre_nms_per_level=64, post_nms_top_k=32)
DET = dict(num_classes=3, rpn_num_samples=32, rcnn_num_samples=32, max_detections=8,
           mask_roi_size=7, mask_size=14)  # a mask slate of 32 * 0.25 = 8 rois an image


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as ``test_torch_train.py``: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(rng):
    """Two images, 2 and 3 valid gts of the 4 gt rows, and a filled ellipse
    inside each valid gt box in 3 mask channels (fewer than the gt rows, as
    the collate's bucket may give)."""
    gt_boxes = np.array(
        [[[4, 4, 30, 30], [20, 8, 60, 40], [0, 0, 0, 0], [0, 0, 0, 0]],
         [[10, 10, 50, 59], [2, 2, 20, 18], [30, 30, 55, 50], [0, 0, 0, 0]]], np.float32)
    valid = np.array([[True, True, False, False], [True, True, True, False]])
    yy, xx = np.mgrid[:64, :64] + 0.5
    masks = np.zeros((2, 3, 64, 64), np.uint8)
    for i, k in zip(*np.nonzero(valid)):
        x1, y1, x2, y2 = gt_boxes[i, k]
        cx, cy, rx, ry = (x1 + x2) / 2, (y1 + y2) / 2, (x2 - x1) / 2, (y2 - y1) / 2
        masks[i, k] = ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1
    return dict(
        image=rng.normal(size=(2, 64, 64, 3)).astype(np.float32),
        gt_boxes=gt_boxes,
        gt_labels=np.array([[1, 3, 0, 0], [2, 3, 1, 0]], np.int32),
        gt_valid=valid,
        gt_masks=masks,
        img_shape=np.array([[64, 64], [60, 56]], np.float32),
    )


def _jax_mask_draws(key, b, n):
    """The mask slate's draws: ``mask_rcnn_loss`` splits its key into one
    key an image and ``_sample_fixed`` splits that into ``k_pos, k_all``."""
    u_pos, u_all = [], []
    for k in jax.random.split(key, b):
        k_pos, k_all = jax.random.split(k)
        u_all.append(np.asarray(jax.random.uniform(k_all, (n,), minval=0.0, maxval=0.5)))
        u_pos.append(np.asarray(jax.random.uniform(k_pos, (n,))))
    return np.stack(u_pos), np.stack(u_all)


@pytest.fixture(scope="module")
def mrcnn():
    """Both detectors on the same weights; the reference's detections, and
    its losses and gradients on one seeded batch."""
    rng = np.random.default_rng(0)
    jax_model = JaxMaskRCNN(**MASK_MODEL)
    proposals = JaxProposalConfig(**PROPOSALS)
    jax_cfg = JaxMaskRCNNConfig(anchor_generator=JaxAnchorGenerator(**ANCHORS),
                                proposal_train=proposals, proposal_test=proposals, **DET)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), jnp.zeros((2, 64, 64, 3)))
    extra = [jax_model.init(jax.random.PRNGKey(k), jnp.zeros((2, 8, 7, 7, 16)), method=m)["params"]
             for k, m in ((1, JaxMaskRCNN.roi_forward), (2, JaxMaskRCNN.mask_forward))]
    variables = _randomise_frozen_bn(
        {"params": {**variables["params"], **extra[0], **extra[1]},
         "batch_stats": variables["batch_stats"]},
        rng,
    )
    batch = _batch(rng)
    images = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    img_shapes = np.array([[64, 64], [60, 56]], np.float32)
    scale_factors = np.array([1.0, 2.0], np.float32)
    key = jax.random.PRNGKey(7)

    def loss_fn(params, batch):
        out = jax_mask_rcnn_loss(jax_cfg, jax_model,
                                 {"params": params, "batch_stats": variables["batch_stats"]},
                                 batch, key)
        return out["loss"], out

    (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], batch)
    infer = jax.jit(lambda v, x, s, f: jax_mask_rcnn_inference(jax_cfg, jax_model, v, x, s, f))
    n = PROPOSALS["post_nms_top_k"] + 4
    want = dict(
        losses={k: float(v) for k, v in losses.items()},
        grads=from_jax_variables({"params": grads}, MaskRCNN(**MASK_MODEL, device="cpu")),
        dets=jax.tree_util.tree_map(np.asarray, infer(variables, images, img_shapes, scale_factors)),
        draws=[*_jax_draws(key, 2, (sum(3 * (64 // s) ** 2 for s in ANCHORS["strides"]), n)),
               _jax_mask_draws(key, 2, n)],
    )

    cfg = MaskRCNNConfig(anchor_generator=AnchorGenerator(**ANCHORS),
                         proposal_train=ProposalConfig(**PROPOSALS),
                         proposal_test=ProposalConfig(**PROPOSALS), **DET)

    def make_model():
        model = MaskRCNN(**MASK_MODEL, device="cpu")
        model.load_state_dict(from_jax_variables(variables, model), strict=True)
        return model.to(memory_format=torch.channels_last).train()

    inputs = dict(images=images, img_shapes=img_shapes, scale_factors=scale_factors)
    return (make_model, cfg, {k: torch.from_numpy(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in inputs.items()}, want, variables)


def test_state_dict_keys_are_the_flax_paths(mrcnn):
    make_model, *_, variables = mrcnn
    model = make_model()
    keys = set(model.state_dict())
    assert keys == set(from_jax_variables(variables, model))
    assert {"mask_head.conv0.weight", "mask_head.upsample.weight", "mask_head.upsample.bias",
            "mask_head.logits.weight"} <= keys


def test_mask_rcnn_inference_matches(mrcnn):
    make_model, cfg, _, x, want, _ = mrcnn
    with torch.no_grad():
        got = mask_rcnn_inference(cfg, make_model().eval(), x["images"], x["img_shapes"],
                                  x["scale_factors"])
    want = want["dets"]
    assert isinstance(got, MaskDetections) and got.mask_probs.shape == (2, 8, 14, 14)
    assert bool(got.valid.any()) and not bool(got.valid.all())
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    np.testing.assert_array_equal(got.labels.numpy(), want.labels)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.mask_probs.numpy(), want.mask_probs, atol=1e-5, rtol=0)
    probs = got.mask_probs.numpy()
    assert (probs >= 0).all() and (probs <= 1).all() and not probs[~want.valid].any()


def test_per_coordinate_scale_factors_pin_r5(mrcnn):
    """R5: the reference multiplies its boxes by ``scale_factors[:, None,
    None]``, which broadcasts (B, 4) factors to (B, B, D, 4) and breaks. The
    port undoes either form per image: (B,) and the equal (B, 4) give the
    same detections and masks."""
    make_model, cfg, _, x, _, _ = mrcnn
    model = make_model().eval()
    per_coord = x["scale_factors"][:, None].expand(-1, 4).contiguous()
    with torch.no_grad():
        a = mask_rcnn_inference(cfg, model, x["images"], x["img_shapes"], x["scale_factors"])
        b = mask_rcnn_inference(cfg, model, x["images"], x["img_shapes"], per_coord)
    for field in MaskDetections._fields:
        torch.testing.assert_close(getattr(a, field), getattr(b, field), atol=0, rtol=0)
    assert float(a.boxes[1][a.valid[1]].max()) <= 56.0 / 2.0
    rois = jnp.zeros((2, 8, 4)) * jnp.asarray(per_coord.numpy())[:, None, None]
    assert rois.shape == (2, 2, 8, 4)  # the reference's roi boxes for (B, 4)


def test_mask_rcnn_loss_and_gradients_match(mrcnn):
    make_model, cfg, batch, _, want, _ = mrcnn
    model = make_model()
    got = mask_rcnn_loss(cfg, model, batch, FixedNoise(want["draws"]))
    assert set(got) == set(want["losses"])
    assert want["losses"]["num_pos_rois"] > 0 and want["losses"]["loss_mask"] > 0
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-5, atol=0, err_msg=k)
    got["loss"].backward()
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want["grads"])
    for name, p in model.named_parameters():
        if _is_frozen(name):
            assert not p.requires_grad and p.grad is None, name
        else:
            np.testing.assert_allclose(p.grad.numpy(), want["grads"][name].numpy(), **GRAD_TOL,
                                       err_msg=name)
    assert all(model.get_parameter(f"mask_head.{n}").grad.abs().sum() > 0
               for n in ("conv0.weight", "upsample.weight", "logits.weight"))


def test_detection_cfg_matches_reference():
    cfg = builder.build_detection_cfg(Config.fromfile(CONFIG).detection)
    want = jax_builder.build_detection_cfg(JaxConfig.fromfile(CONFIG).detection)
    assert isinstance(cfg, MaskRCNNConfig)
    for field in ("num_classes", "roi_strides", "roi_size", "finest_scale", "mask_size",
                  "mask_roi_size", "mask_loss_weight", "rcnn_num_samples",
                  "rcnn_pos_fraction", "score_thr", "nms_iou_thr", "max_detections"):
        assert getattr(cfg, field) == getattr(want, field), field
    # the port's mask slate is always the box sampler's positive cap, which is
    # what the reference takes when a config leaves mask_num_rois unset
    assert want.mask_num_rois is None
    with pytest.raises(NotImplementedError, match="mask_num_rois"):
        builder.build_detection_cfg(dict(style="mask_rcnn", mask_num_rois=64))


def test_segm_needs_a_mask_detector():
    with pytest.raises(ValueError, match="MaskRCNNConfig"):
        make_inference_fn(None, FasterRCNNConfig(), segm=True)


def test_full_width_mask_rcnn_answers_on_cpu():
    """The config's detector at full width (R50, FPN 256, 80 classes, the
    mask head of 4 convs of 256) through ``make_inference_fn(segm=True)``;
    its slates cut to 64 proposals and 8 detections, for the CPU's time."""
    cfg = Config.fromfile(CONFIG)
    model = builder.build_detector(cfg.model, "float32", device="cpu", seed=0)
    # Faster R-CNN's 41 429 156 + 4 conv 3x3 + the 2x2 transposed conv + 1x1 logits
    assert sum(p.numel() for p in model.parameters()) == 41_429_156 + 4 * 590_080 + 262_400 + 20_560
    det_cfg = dataclasses.replace(builder.build_detection_cfg(cfg.detection), max_detections=8,
                                  proposal_test=ProposalConfig(post_nms_top_k=64))
    infer = make_inference_fn(model, det_cfg, segm=True)
    image = torch.randn((1, 64, 96, 3), generator=torch.Generator().manual_seed(0))
    res = infer(image, torch.tensor([[64.0, 96.0]]), torch.tensor([2.0]))
    assert res.mask_probs.shape == (1, 8, 28, 28) and bool(res.valid.any())
    assert float(res.mask_probs.min()) >= 0 and float(res.mask_probs.max()) <= 1
    assert not res.mask_probs[~res.valid].any()


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def iter_batches(self, skip_batches=0):
        return iter([dict(b) for b in self.batches[skip_batches:]])

    def __len__(self):
        return len(self.batches)


def test_trainer_carries_gt_masks_to_the_loss(mrcnn):
    """``Trainer.run`` and ``make_train_step`` hand ``gt_masks`` (B, G, H,
    W) uint8 to the loss untouched; every step trains the mask head."""
    make_model, cfg, batch, _, _, _ = mrcnn
    model = make_model()
    loss_fn = builder.build_loss_fn(model, cfg, rng_seed=3)
    seen = []

    def recording_loss(batch, step):
        seen.append(batch["gt_masks"])
        return loss_fn(batch, step)

    before = model.mask_head.upsample.weight.detach().clone()
    optimizer = make_optimizer(model.parameters(), detection_lr_schedule(0.01, 2), 0.9, 1e-4, 1.0)
    history = Trainer(recording_loss, model, optimizer, _Loader([batch, batch]),
                      log_interval=1).run(1)
    assert len(history) == 2 and all(h["skipped_steps"] == 0 for h in history)
    assert all(np.isfinite(h["loss_mask"]) and h["loss_mask"] > 0 for h in history)
    assert all(m is batch["gt_masks"] and m.dtype == torch.uint8 for m in seen)
    assert not torch.equal(model.mask_head.upsample.weight.detach(), before)
