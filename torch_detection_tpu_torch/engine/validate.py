"""Inference entry point.

Counterpart of ``torch_detection_tpu/engine/validate.py::make_inference_fn``
for the Faster R-CNN, Mask R-CNN, Cascade R-CNN, Cascade Mask R-CNN, Fast
R-CNN, RetinaNet, Sparse R-CNN and DETR families. The port's modules hold
their weights, so ``infer`` takes the batch alone.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models.detectors import (
    CascadeMaskRCNNConfig,
    CascadeRCNNConfig,
    DETRConfig,
    FasterRCNNConfig,
    FastRCNNConfig,
    MaskRCNNConfig,
    RetinaNetConfig,
    SparseRCNNConfig,
    cascade_mask_rcnn_inference,
    cascade_rcnn_inference,
    detr_inference,
    fast_rcnn_inference,
    faster_rcnn_inference,
    mask_rcnn_inference,
    retina_inference,
    sparse_rcnn_inference,
)


def _inference(det_cfg, segm: bool) -> Callable:
    """The inference of ``det_cfg``'s family, its mask branch with ``segm``.
    The cascade configs subclass ``FasterRCNNConfig``, so each subclass is
    tested before its base."""
    for config_cls, boxes, masks in ((CascadeMaskRCNNConfig, cascade_rcnn_inference,
                                      cascade_mask_rcnn_inference),
                                     (CascadeRCNNConfig, cascade_rcnn_inference, None),
                                     (MaskRCNNConfig, faster_rcnn_inference, mask_rcnn_inference),
                                     (FasterRCNNConfig, faster_rcnn_inference, None),
                                     (FastRCNNConfig, fast_rcnn_inference, None),
                                     (RetinaNetConfig, retina_inference, None),
                                     (SparseRCNNConfig, sparse_rcnn_inference, None),
                                     (DETRConfig, detr_inference, None)):
        if isinstance(det_cfg, config_cls):
            if segm and masks is None:
                raise ValueError("segm=True needs a mask-capable detector (MaskRCNNConfig or "
                                 f"CascadeMaskRCNNConfig); got {type(det_cfg).__name__}")
            return masks if segm else boxes
    raise NotImplementedError(f"{type(det_cfg).__name__} inference is not ported yet")


def make_inference_fn(model, det_cfg, segm: bool = False) -> Callable:
    """``infer(image, img_shape, scale_factor) -> NMSResult`` for the
    detector family implied by ``det_cfg``: images (B, H, W, 3), or an
    ``stem_s2d`` backbone's (B, H/2, W/2, 12) wire, on the model's device,
    img_shape (B, 2) as (h, w), scale_factor (B,) or (B, 4). ``segm=True``
    runs the mask branch of a Mask R-CNN or Cascade Mask R-CNN and returns
    ``MaskDetections``, whose ``mask_probs`` are the detections' masks. Fast
    R-CNN's ``infer(image, img_shape, scale_factor, proposals,
    proposal_valid)`` also takes its proposals, (B, P, 4|5) in the canvas
    frame, and their (B, P) validity. Sparse R-CNN's ``img_shape`` also
    sizes its initial slate (the canvas where it is None); DETR's masks the
    canvas padding out of its attention (every cell valid where it is
    None)."""
    inference = _inference(det_cfg, segm)

    if isinstance(det_cfg, FastRCNNConfig):
        @torch.inference_mode()
        def infer_proposals(image, img_shape, scale_factor, proposals, proposal_valid):
            return inference(det_cfg, model, image, proposals, proposal_valid, img_shape,
                             scale_factor)

        return infer_proposals

    @torch.inference_mode()
    def infer(image, img_shape=None, scale_factor=None):
        return inference(det_cfg, model, image, img_shape, scale_factor)

    return infer
