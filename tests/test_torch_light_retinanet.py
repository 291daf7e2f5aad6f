"""The RetinaNet MobileNetV2-FPN and ShuffleNetV2-FPN configs against the JAX
package's, on the CPU in float32.

* Each config built whole through ``builder.build_detector`` at full width
  (the JAX builder's parameter counts, 11 488 244 and 12 788 696) on the
  reference's seeded variables (``strict=True``), on a 128 x 128 canvas: the
  head's outputs within 1e-4 of each output's largest value, the losses
  within 1e-5 relative and every parameter's gradient within 1e-4 of its
  largest value (the convolutions sum in other orders); ``check_config``
  serves ``test_torch_pafpn.py`` too.
* A step of each through ``build_train_objects``, ``build_loss_fn`` and
  ``Trainer`` (float32): every parameter moves.
* R13: the ShuffleNetV2 config names 464 channels for a 1024-channel C5;
  the reference builds its neck for 1024, and so does the port.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_backbone_zoo import CONFIGS, carried
from test_torch_retina_train import _Loader
from test_torch_vgg import rel_close
from torch_detection_tpu.models.detectors import RetinaNetConfig as JaxRetinaNetConfig
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import retina_loss as jax_retina_loss
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector, build_loss_fn
from torch_detection_tpu_torch.engine import Trainer
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.ops.preprocess import space_to_depth_2x2_np
from torch_detection_tpu_torch.utils.config import Config
from torch_detection_tpu_torch.utils.registry import NECKS

LIGHT = [("retinanet_mobilenetv2_fpn_coco", 11_488_244),
         ("retinanet_shufflenetv2_fpn_coco", 12_788_696)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def config_batch(rng, s2d: bool) -> dict:
    """Two seeded 128 x 128 images (the second 121 x 113 inside the canvas)
    with 3 and 2 gts, on the s2d wire where the backbone has ``stem_s2d``."""
    image = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    gt_boxes = np.zeros((2, 4, 4), np.float32)
    gt_boxes[0, :3] = [[4, 6, 60, 70], [40, 20, 120, 90], [70, 80, 100, 110]]
    gt_boxes[1, :2] = [[10, 12, 90, 100], [60, 8, 110, 50]]
    return dict(
        image=space_to_depth_2x2_np(image) if s2d else image,
        gt_boxes=gt_boxes,
        gt_labels=np.array([[1, 17, 80, 0], [45, 3, 0, 0]], np.int32),
        gt_valid=np.array([[True, True, True, False], [True, True, False, False]]),
        img_shape=np.array([[128, 128], [121, 113]], np.float32),
    )


def check_config(name: str, params: int, seed: int, grad_norm_limit=None):
    """``configs/<name>.py`` through ``build_detector`` at full width on the
    CPU: the reference's parameter count and seeded variables (strict, a
    ResNet's residual branches damped), the head's outputs, the losses and
    every parameter's gradient on one batch against the reference's: each
    within 1e-4 of its largest value, or with ``grad_norm_limit`` the
    relative norm of its difference under that limit. Returns the port
    model and the variables."""
    cfg = Config.fromfile(os.path.join(CONFIGS, f"{name}.py"))
    rng = np.random.default_rng(seed)
    batch = config_batch(rng, cfg.model["backbone"].get("stem_s2d", False))
    jax_model = JaxSingleStageDetector(**{k: v for k, v in cfg.model.items() if k != "type"})
    model = build_detector(cfg.model, "float32", device="cpu", seed=0).train()
    assert sum(p.numel() for p in model.parameters()) == params
    variables = carried(jax_model, model, rng, jnp.asarray(batch["image"]), damp_residuals=True)
    assert sum(int(np.prod(v.shape)) for v in jax.tree_util.tree_leaves(variables["params"])) \
        == params
    jax_cfg = JaxRetinaNetConfig(num_classes=80)

    def loss_fn(p, b):
        cls, reg = jax_model.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                   b["image"], train=True)
        out = jax_retina_loss(jax_cfg, cls, reg, b["gt_boxes"], b["gt_labels"], b["gt_valid"],
                              img_shapes=b["img_shape"])
        return out["loss"], (out, cls, reg)

    (_, (want_losses, want_cls, want_reg)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(variables["params"], batch)
    cls, reg = model(torch.from_numpy(batch["image"]))
    for g, w in zip(cls + reg, want_cls + want_reg, strict=True):
        rel_close(g.detach().numpy(), np.asarray(w), 1e-4, "head output")
    det_cfg = build_detection_cfg(cfg.detection)
    loss, losses = build_loss_fn(model, det_cfg)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(want_losses["num_pos"]) > 0
    for k in ("loss_cls", "loss_reg", "num_pos"):
        np.testing.assert_allclose(float(losses[k].detach()), float(want_losses[k]), rtol=1e-5,
                                   err_msg=k)
    loss.backward()
    want = from_jax_variables({"params": grads}, model)
    assert sorted(n for n, _ in model.named_parameters()) == sorted(want)
    for n, p in model.named_parameters():
        w = want[n].numpy()
        if not p.requires_grad:  # the reference's stop-gradient
            assert p.grad is None and not w.any(), n
        elif grad_norm_limit is None:
            np.testing.assert_allclose(p.grad.numpy(), w, atol=1e-4 * float(np.abs(w).max()),
                                       rtol=0, err_msg=n)
        else:
            err = np.linalg.norm(p.grad.numpy() - w) / np.linalg.norm(w)
            assert err <= grad_norm_limit, (n, err)
    return model, variables


@pytest.mark.parametrize("name,params", LIGHT, ids=["mobilenetv2", "shufflenetv2"])
def test_config_builds_and_trains_as_the_reference(name, params):
    check_config(name, params, seed=11)


@pytest.mark.parametrize("name", [n for n, _ in LIGHT], ids=["mobilenetv2", "shufflenetv2"])
def test_a_step_through_the_entry_points(name):
    """``build_train_objects`` (float32 here: a bf16 convolution is slow on
    the CPU) -> ``build_loss_fn`` -> ``Trainer.run``: finite losses,
    positives, every parameter moved (neither backbone config freezes a
    stage)."""
    cfg = Config.fromfile(os.path.join(CONFIGS, f"{name}.py"))
    cfg = dict(cfg, runtime=dict(cfg.runtime, compute_dtype="float32"))
    batch = {k: torch.from_numpy(v) for k, v in config_batch(np.random.default_rng(12), False).items()}
    model, det_cfg, loader, optimizer = builder.build_train_objects(cfg, "cpu", seed=3,
                                                                    loader=_Loader([batch]))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    trainer = Trainer(builder.build_loss_fn(model, det_cfg), model, optimizer, loader,
                      log_interval=1)
    (h,) = trainer.run(1)
    assert trainer.skipped_steps == 0 and np.isfinite(h["loss"]) and h["num_pos"] > 0
    still = [n for n, p in model.named_parameters() if torch.equal(p, before[n])]
    assert all(p.requires_grad for p in model.parameters()) and not still, still


def test_r13_the_shufflenetv2_neck_takes_the_backbones_1024_channels():
    """The config's neck says (116, 232, 464), but ``conv5`` gives C5 1024
    channels, and flax sizes ``lateral2`` and ``extra0`` from what comes
    in. The port's detector sizes its neck from ``backbone.out_channels``
    and loads the reference's tree; an FPN built from the config's numbers
    cannot."""
    cfg = Config.fromfile(os.path.join(CONFIGS, "retinanet_shufflenetv2_fpn_coco.py"))
    assert tuple(cfg.model["neck"]["in_channels"]) == (116, 232, 464)
    jax_model = JaxSingleStageDetector(**{k: v for k, v in cfg.model.items() if k != "type"})
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    neck = shapes["params"]["neck"]
    assert neck["lateral2"]["conv"]["kernel"].shape == (1, 1, 1024, 256)
    assert neck["extra0"]["conv"]["kernel"].shape == (3, 3, 1024, 256)
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert model.backbone.out_channels == model.neck.in_channels == (116, 232, 1024)
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model.load_state_dict(from_jax_variables(zeros, model), strict=True)
    as_configured = NECKS.build(dict(cfg.model["neck"]), device="cpu")
    state = {k[len("neck."):]: v for k, v in from_jax_variables(zeros, model).items()
             if k.startswith("neck.")}
    with pytest.raises(RuntimeError, match="size mismatch"):
        as_configured.load_state_dict(state, strict=True)


