"""Config -> objects: the detector and its detection config.

Counterpart of ``torch_detection_tpu/builder.py`` for the ``faster_rcnn``
style; the other families arrive with their slices.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Union

import torch

from .models.detectors import FasterRCNNConfig
from .models.inits import init_weights
from .ops.anchors import AnchorGenerator
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
):
    """The detector of ``model_cfg`` on ``device`` (default ``cuda``), its
    weights drawn from ``seed``, in eval mode and channels_last memory.
    ``compute_dtype`` ('float32', 'bfloat16') is the dtype of its
    parameters and activations; FrozenBN stays float32."""
    cfg = copy.deepcopy(dict(model_cfg))
    dtype = _DTYPES[compute_dtype] if compute_dtype is not None else None
    model = DETECTORS.build(cfg, dtype=dtype, device=device)
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
