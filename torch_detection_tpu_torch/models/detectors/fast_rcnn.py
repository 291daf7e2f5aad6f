"""Fast R-CNN: the RoI box stage on precomputed proposals, without an RPN.

Counterpart of ``torch_detection_tpu/models/detectors/fast_rcnn.py``. The
proposals come with the batch as a fixed (B, P, 4) or (B, P, 5) slate (the
score column is ignored) and a (B, P) validity mask, in the canvas frame.
Sampling, RoIAlign (K1, and in training K2), the box head, its losses and
the per-class decode and NMS are Faster R-CNN's second stage.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor

from ...ops.assign import MaxIoUAssigner
from ...ops.nms import NMSResult
from ...utils.registry import DETECTORS
from .two_stage import (
    Noise,
    RoIDetector,
    rcnn_detections,
    rcnn_losses,
    roi_features,
    sample_rois,
    undo_scale,
)


@DETECTORS.register_module
class FastRCNN(RoIDetector):
    """backbone + neck + RoI box head (``backbone``, ``neck``,
    ``bbox_head``); ``RoIDetector``'s dtypes, device and autocast."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], bbox_head: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(backbone, neck, dtype, param_dtype, device)
        self.bbox_head = self._build_roi_head(bbox_head)

    def forward(self, images: Tensor) -> Tuple[Tensor, ...]:
        """(B, H, W, 3) -> the NHWC FPN levels."""
        x = images.to(self.dtype).contiguous()
        with self._autocast(x):
            return self.neck(self.backbone(x))


@dataclasses.dataclass(frozen=True)
class FastRCNNConfig:
    """The reference's ``FastRCNNConfig``, with its defaults, less its
    ``approx_top_k`` switch (a TPU approximation)."""

    num_classes: int = 80
    roi_strides: Tuple[int, ...] = (4, 8, 16, 32)  # P2..P5 carry rois
    roi_size: int = 7
    finest_scale: float = 56.0
    # train
    rcnn_assigner: MaxIoUAssigner = MaxIoUAssigner(
        pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5
    )
    rcnn_num_samples: int = 512
    rcnn_pos_fraction: float = 0.25
    rcnn_target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    rcnn_target_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    smooth_l1_beta: float = 1.0
    # inference
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_detections: int = 100


def fast_rcnn_loss(
    cfg: FastRCNNConfig, model: FastRCNN, batch: Dict[str, Tensor], noise: Noise
) -> Dict[str, Tensor]:
    """The RoI stage's losses on the batch's proposals: ``loss`` (their
    sum), ``loss_rcnn_cls``, ``loss_rcnn_reg`` and ``num_pos_rois``.

    ``batch`` holds Faster R-CNN's keys and ``proposals`` (B, P, 4|5) with
    ``proposal_valid`` (B, P). The slate is ``min(rcnn_num_samples, P + G)``
    rois an image; ``noise`` is called once."""
    feats = model(batch["image"])
    sampled = sample_rois(cfg, batch["proposals"][..., :4].float(), batch["proposal_valid"],
                          batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"], noise)
    cls_l, reg_l = rcnn_losses(cfg, *model.roi_forward(roi_features(cfg, feats, sampled.rois)),
                               sampled)
    return {"loss": cls_l + reg_l, "loss_rcnn_cls": cls_l, "loss_rcnn_reg": reg_l,
            "num_pos_rois": sampled.is_pos.float().sum()}


def fast_rcnn_inference(
    cfg: FastRCNNConfig,
    model: FastRCNN,
    images: Tensor,  # (B, H, W, 3)
    proposals: Tensor,  # (B, P, 4|5) in the canvas frame
    proposal_valid: Tensor,  # (B, P) bool
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Proposals -> RoIAlign -> box head -> per-class decode + NMS, padded."""
    rois = proposals[..., :4].float()
    res = rcnn_detections(cfg, model, model(images), rois, proposal_valid, img_shapes)
    return undo_scale(res, scale_factors)
