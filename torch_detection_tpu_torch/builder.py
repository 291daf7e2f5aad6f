"""Config -> objects: the detector, its detection config, its loss, and the
optimizer with its learning-rate schedule.

Counterpart of ``torch_detection_tpu/builder.py`` for the ``faster_rcnn``
style; the other families arrive with their slices.
"""

from __future__ import annotations

import copy
import functools
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .engine.trainer import detection_lr_schedule
from .models.detectors import FasterRCNNConfig, faster_rcnn_loss, sampling_noise
from .models.inits import init_weights
from .ops.anchors import AnchorGenerator
from .parallel.train_step import Optimizer, make_optimizer
from .utils.registry import DETECTORS

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the dtypes the kernels take

# detection-config keys the Faster R-CNN inference path reads
_FASTER_RCNN_KEYS = ("num_classes", "score_thr", "nms_iou_thr", "max_detections", "roi_size",
                     "finest_scale")


def build_detector(
    model_cfg: Dict[str, Any],
    compute_dtype: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    param_dtype: Optional[str] = None,
):
    """The detector of ``model_cfg`` on ``device`` (default ``cuda``), its
    weights drawn from ``seed``, in eval mode and channels_last memory.
    ``compute_dtype`` ('float32', 'bfloat16') is the dtype of its
    activations, and of its parameters unless ``param_dtype`` names another:
    the serving build keeps bf16 parameters, the training build
    (``param_dtype='float32'``) float32 parameters that are cast to the
    compute dtype at use. FrozenBN stays float32."""
    cfg = copy.deepcopy(dict(model_cfg))
    dtype = _DTYPES[compute_dtype] if compute_dtype is not None else None
    pdtype = _DTYPES[param_dtype] if param_dtype is not None else None
    model = DETECTORS.build(cfg, dtype=dtype, param_dtype=pdtype, device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last).eval()


def _build_anchor_generator(anchor: Dict[str, Any]) -> AnchorGenerator:
    return AnchorGenerator(
        strides=tuple(anchor.get("strides", (8, 16, 32, 64, 128))),
        ratios=tuple(anchor.get("ratios", (0.5, 1.0, 2.0))),
        scales=tuple(anchor["scales"]) if "scales" in anchor else None,
        octave_base_scale=anchor.get("octave_base_scale", None if "scales" in anchor else 4.0),
        scales_per_octave=anchor.get("scales_per_octave", 3),
    )


def build_detection_cfg(det_cfg: Dict[str, Any]) -> FasterRCNNConfig:
    """The static detection config of a ``style='faster_rcnn'`` config.
    Keys the port does not read yet raise instead of being dropped."""
    cfg = dict(det_cfg)
    style = cfg.pop("style", "retina")
    if style != "faster_rcnn":
        raise NotImplementedError(f"detection style {style!r} is not ported yet")
    kwargs: Dict[str, Any] = {}
    anchor = cfg.pop("anchor", None)
    if anchor:
        kwargs["anchor_generator"] = _build_anchor_generator(dict(anchor))
    for key in _FASTER_RCNN_KEYS:
        if key in cfg:
            v = cfg.pop(key)
            kwargs[key] = tuple(v) if isinstance(v, list) else v
    if cfg:
        raise NotImplementedError(f"detection keys not ported yet: {sorted(cfg)}")
    return FasterRCNNConfig(**kwargs)


def build_loss_fn(model, det_cfg, rng_seed: int = 0) -> Callable:
    """``loss_fn(batch, step=0) -> (loss, metrics)`` for the detector family
    of ``det_cfg``. The sampling draws of a step come from a
    ``torch.Generator`` on the model's device seeded from
    ``(rng_seed, step)``, so every step draws a fresh stream and a step
    repeats exactly (the counterpart of the reference's ``_step_rng``)."""
    if not isinstance(det_cfg, FasterRCNNConfig):
        raise NotImplementedError(f"{type(det_cfg).__name__} training is not ported yet")
    device = next(model.parameters()).device

    def loss_fn(batch: Dict[str, torch.Tensor], step: int = 0):
        generator = torch.Generator(device=device).manual_seed((rng_seed << 32) + int(step))
        losses = faster_rcnn_loss(det_cfg, model, batch,
                                  functools.partial(sampling_noise, generator))
        return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}

    return loss_fn


def build_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """The config's learning-rate schedule as a plain ``step -> lr``."""
    opt_cfg = cfg.get("optimizer", {})
    sched_cfg = cfg.get("schedule", {})
    if sched_cfg.get("policy", "step") != "step":
        raise NotImplementedError(f"schedule policy {sched_cfg['policy']!r} is not ported")
    return detection_lr_schedule(
        opt_cfg.get("lr", 0.01),
        steps_per_epoch=max(int(steps_per_epoch), 1),
        decay_epochs=tuple(sched_cfg.get("decay_epochs", (8, 11))),
        warmup_steps=sched_cfg.get("warmup_steps", 500),
        warmup_ratio=sched_cfg.get("warmup_ratio", 1.0 / 3),
    )


def build_train_objects(
    cfg,
    steps_per_epoch: int,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
) -> Tuple[Any, FasterRCNNConfig, Optimizer]:
    """(model, det_cfg, optimizer) from a full config tree: the training
    build of the detector (float32 parameters, the runtime's compute dtype,
    train mode) and SGD with the config's momentum, weight decay, clip and
    schedule. The data loader is the caller's; ``steps_per_epoch`` is its
    length."""
    runtime = cfg.get("runtime", {})
    model = build_detector(cfg["model"], runtime.get("compute_dtype"), device, seed,
                           param_dtype="float32").train()
    det_cfg = build_detection_cfg(cfg["detection"])
    opt_cfg = cfg.get("optimizer", {})
    if opt_cfg.get("type", "sgd") != "sgd":
        raise NotImplementedError(f"optimizer {opt_cfg['type']!r} is not ported")
    optimizer = make_optimizer(
        model.parameters(),
        learning_rate=build_lr_schedule(cfg, steps_per_epoch),
        momentum=opt_cfg.get("momentum", 0.9),
        weight_decay=opt_cfg.get("weight_decay", 1e-4),
        grad_clip_norm=opt_cfg.get("grad_clip_norm"),
    )
    return model, det_cfg, optimizer
