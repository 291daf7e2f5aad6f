"""The port's RetinaNet training path against the JAX package's: the sparse
focal loss with its analytic backward, ``retina_loss`` with the gradient of
every parameter, and a step through ``build_train_objects`` and
``Trainer``.

The detector is ``test_torch_retinanet.py``'s (ResNet-18 with the s2d stem,
FPN 32, a head of 2 convs of 32, 9 anchors, 3 classes, 64 x 96, batch 2)
with ``frozen_stages=1``, on the same converted weights. The batch's second
image is smaller than the canvas, so ``anchor_valid`` drops anchors, and
has no gt box. Both sides run in float32 on the CPU.

Tolerances: the focal loss's value rtol 1e-6 and its gradient atol 1e-7
(float32 logits) or one bf16 ulp (bf16 logits: both sides round the same
float32 gradient); ``retina_loss`` rtol 1e-5; each parameter's gradient
within 1e-4 * max |want| (the convolutions sum in another order).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_retinanet import IMG_SHAPES, MODEL, _randomise_head_biases
from test_torch_model import _randomise_frozen_bn
from test_torch_train import _is_frozen
from torch_detection_tpu.models.detectors import RetinaNetConfig as JaxRetinaNetConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import retina_loss as jax_retina_loss
from torch_detection_tpu.ops import losses as jax_losses
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import Trainer
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import (
    RetinaNetConfig,
    SingleStageDetector,
    retina_loss,
)
from torch_detection_tpu_torch.ops import losses
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "retinanet_r50_fpn_coco.py"
TRAIN_MODEL = dict(MODEL, backbone=dict(MODEL["backbone"], frozen_stages=1))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch in this module: the test workers share
    the cores, and at these sizes threads contend more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _focal_case(rng, dtype):
    logits = (3 * rng.normal(size=(2, 40, 5))).astype(np.float32)
    label0 = rng.integers(-1, 5, size=(2, 40)).astype(np.int32)  # about a sixth are -1 rows
    label0[0, :6] = -1
    weight = (rng.uniform(size=(2, 40, 1)) > 0.2).astype(np.float32)
    return jnp.asarray(logits, getattr(jnp, dtype)), label0, weight


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigmoid_focal_loss_sparse_matches(rng, dtype):
    logits, label0, weight = _focal_case(rng, dtype)
    avg = np.float32(7.0)

    def jax_loss(x):
        return jax_losses.sigmoid_focal_loss_sparse(x, jnp.asarray(label0), weight=weight,
                                                    gamma=2.0, alpha=0.25, avg_factor=avg)

    want, want_grad = jax.value_and_grad(jax_loss)(logits)
    x = torch.from_numpy(np.array(logits.astype(jnp.float32))).to(getattr(torch, dtype))
    x.requires_grad_()
    got = losses.sigmoid_focal_loss_sparse(x, torch.from_numpy(label0).long(),
                                           weight=torch.from_numpy(weight), gamma=2.0, alpha=0.25,
                                           avg_factor=torch.tensor(avg))
    got.backward()
    assert got.dtype == torch.float32 and x.grad.dtype == x.dtype
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6, atol=0)
    want_grad = np.asarray(want_grad.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(x.grad.numpy(), want_grad, atol=1e-7, rtol=0)
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want_grad), 1e-30))) - 7)
        assert (np.abs(x.grad.float().numpy() - want_grad) <= ulp).all()


def test_sparse_focal_loss_is_the_dense_one(rng):
    """The same value and gradient as ``sigmoid_focal_loss`` on the one-hot
    (autograd through the dense form)."""
    logits, label0, weight = _focal_case(rng, "float32")
    x = torch.from_numpy(np.array(logits))
    one_hot = torch.nn.functional.one_hot(torch.from_numpy(label0).long() + 1, 6)[..., 1:].float()
    a, b = x.clone().requires_grad_(), x.clone().requires_grad_()
    sparse = losses.sigmoid_focal_loss_sparse(a, torch.from_numpy(label0), torch.from_numpy(weight))
    dense = losses.sigmoid_focal_loss(b, one_hot, torch.from_numpy(weight))
    (sparse + dense).backward()
    torch.testing.assert_close(sparse, dense, atol=0, rtol=1e-6)
    torch.testing.assert_close(a.grad, b.grad, atol=1e-7, rtol=1e-5)
    dense_jax = jax_losses.sigmoid_focal_loss(logits, jnp.asarray(one_hot.numpy()), weight)
    np.testing.assert_allclose(float(dense.detach()), float(dense_jax), rtol=1e-6)


def _batch(rng):
    gt_boxes = np.zeros((2, 4, 4), np.float32)
    gt_boxes[0, :3] = [[4, 6, 40, 50], [30, 10, 90, 60], [50, 30, 66, 46]]
    return dict(
        image=rng.normal(size=(2, 32, 48, 12)).astype(np.float32),  # the s2d wire of 64 x 96
        gt_boxes=gt_boxes,
        gt_labels=np.array([[1, 3, 2, 0], [0, 0, 0, 0]], np.int32),
        gt_valid=np.array([[True, True, True, False], [False] * 4]),
        img_shape=IMG_SHAPES,
    )


@pytest.fixture(scope="module")
def train_setup():
    """Both detectors on the same weights; the reference's losses and
    gradients on one seeded batch."""
    rng = np.random.default_rng(1)
    jax_model = JaxSingleStageDetector(**TRAIN_MODEL)
    batch = _batch(rng)
    variables = jax.jit(jax_model.init)(jax.random.PRNGKey(0), batch["image"])
    variables = _randomise_head_biases(_randomise_frozen_bn(dict(variables), rng), rng)
    jax_cfg = JaxRetinaNetConfig(num_classes=3)

    def loss_fn(params, batch_stats, batch):
        cls, reg = jax_model.apply({"params": params, "batch_stats": batch_stats}, batch["image"],
                                   train=True)
        out = jax_retina_loss(jax_cfg, cls, reg, batch["gt_boxes"], batch["gt_labels"],
                              batch["gt_valid"], img_shapes=batch["img_shape"])
        return out["loss"], out

    (_, jax_out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], batch)
    model = SingleStageDetector(**TRAIN_MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    model = model.to(memory_format=torch.channels_last).train()
    want = dict(losses={k: float(v) for k, v in jax_out.items()},
                grads=from_jax_variables({"params": grads}, model))
    return model, {k: torch.from_numpy(v) for k, v in batch.items()}, want


def test_retina_loss_and_every_gradient_match(train_setup):
    model, batch, want = train_setup
    cls, reg = model(batch["image"])
    got = retina_loss(RetinaNetConfig(num_classes=3), cls, reg, batch["gt_boxes"],
                      batch["gt_labels"], batch["gt_valid"], batch["img_shape"])
    assert set(got) == set(want["losses"]) and want["losses"]["num_pos"] > 0
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got[k].detach()), v, rtol=1e-5, atol=0, err_msg=k)
    got["loss"].backward()
    names = [n for n, _ in model.named_parameters()]
    assert sorted(names) == sorted(want["grads"])
    for name, p in model.named_parameters():
        w = want["grads"][name].numpy()
        if _is_frozen(name):  # stop_gradient in the reference, requires_grad=False here
            assert not p.requires_grad and p.grad is None and not w.any(), name
        else:
            limit = 1e-4 * max(float(np.abs(w).max()), 1e-12)
            np.testing.assert_allclose(p.grad.numpy(), w, atol=limit, rtol=0, err_msg=name)


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def iter_batches(self, skip_batches=0):
        return iter([dict(b) for b in self.batches[skip_batches:]])

    def __len__(self):
        return len(self.batches)


def test_a_step_through_the_entry_points(train_setup):
    """``build_train_objects`` (float32 parameters, bf16 compute) ->
    ``build_loss_fn`` -> ``Trainer.run``: the trainable parameters move,
    the frozen ones do not."""
    _, batch, _ = train_setup
    cfg = Config.fromfile(CONFIG)
    cfg = dict(cfg, model=dict(TRAIN_MODEL, type="SingleStageDetector"),
               detection=dict(cfg.detection, num_classes=3))
    model, det_cfg, loader, optimizer = builder.build_train_objects(cfg, "cpu", seed=3,
                                                                    loader=_Loader([batch]))
    assert isinstance(det_cfg, RetinaNetConfig) and model.dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(builder.build_loss_fn(model, det_cfg), model, optimizer, loader,
                      log_interval=1)
    (h,) = trainer.run(1)
    assert trainer.skipped_steps == 0 and np.isfinite(h["loss"]) and h["num_pos"] > 0
    assert set(h) >= {"loss", "loss_cls", "loss_reg", "num_pos"}
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]) == _is_frozen(name), name
