"""Inference entry point.

Counterpart of ``torch_detection_tpu/engine/validate.py::make_inference_fn``
for the Faster R-CNN family. The port's modules hold their weights, so
``infer`` takes the batch alone.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.detectors import FasterRCNNConfig, faster_rcnn_inference


def make_inference_fn(model, det_cfg) -> Callable:
    """``infer(image, img_shape, scale_factor) -> NMSResult`` for the
    detector family implied by ``det_cfg``: images (B, H, W, 3) on the
    model's device, img_shape (B, 2) as (h, w), scale_factor (B,) or (B, 4)."""
    if not isinstance(det_cfg, FasterRCNNConfig):
        raise NotImplementedError(f"{type(det_cfg).__name__} inference is not ported yet")

    @torch.inference_mode()
    def infer(image, img_shape=None, scale_factor=None):
        return faster_rcnn_inference(det_cfg, model, image, img_shape, scale_factor)

    return infer
