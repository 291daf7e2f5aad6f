"""Inference entry point.

Counterpart of ``torch_detection_tpu/engine/validate.py::make_inference_fn``
for the Faster R-CNN, Mask R-CNN and RetinaNet families. The port's modules
hold their weights, so ``infer`` takes the batch alone.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.detectors import (
    FasterRCNNConfig,
    MaskRCNNConfig,
    RetinaNetConfig,
    faster_rcnn_inference,
    mask_rcnn_inference,
    retina_inference,
)


def make_inference_fn(model, det_cfg, segm: bool = False) -> Callable:
    """``infer(image, img_shape, scale_factor) -> NMSResult`` for the
    detector family implied by ``det_cfg``: images (B, H, W, 3), or an
    ``stem_s2d`` backbone's (B, H/2, W/2, 12) wire, on the model's device,
    img_shape (B, 2) as (h, w), scale_factor (B,) or (B, 4). ``segm=True``
    runs the mask branch of a Mask R-CNN and returns ``MaskDetections``,
    whose ``mask_probs`` are the detections' masks."""
    if not isinstance(det_cfg, (FasterRCNNConfig, RetinaNetConfig)):
        raise NotImplementedError(f"{type(det_cfg).__name__} inference is not ported yet")
    if segm and not isinstance(det_cfg, MaskRCNNConfig):
        raise ValueError(f"segm=True needs a mask-capable detector (MaskRCNNConfig); got "
                         f"{type(det_cfg).__name__}")
    if isinstance(det_cfg, RetinaNetConfig):
        inference = retina_inference
    else:
        inference = mask_rcnn_inference if segm else faster_rcnn_inference

    @torch.inference_mode()
    def infer(image, img_shape=None, scale_factor=None):
        return inference(det_cfg, model, image, img_shape, scale_factor)

    return infer
