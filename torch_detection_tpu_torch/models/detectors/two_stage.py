"""Two-stage detector (Faster R-CNN) inference: RPN proposals -> RoIAlign ->
box head -> per-class decode + NMS, padded.

Counterpart of ``torch_detection_tpu/models/detectors/two_stage.py``,
inference only; the training losses come with the training slice. Every
shape is fixed: (B, P) proposals with a validity mask, (B, max_detections)
detections.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor, nn

from ...ops.anchors import AnchorGenerator
from ...ops.boxes import clip_boxes, delta2bbox
from ...ops.nms import NMSResult, multiclass_nms
from ...ops.roi_align import batched_multilevel_roi_align
from ...utils.device import resolve_device
from ...utils.registry import BACKBONES, DETECTORS, HEADS, NECKS
from ..heads.rpn_head import ProposalConfig, generate_proposals


@DETECTORS.register_module
class TwoStageDetector(nn.Module):
    """backbone + neck + RPN head + RoI box head, named as the reference's
    (``backbone``, ``neck``, ``rpn``, ``bbox_head``). ``dtype`` is the
    compute dtype; images are cast to it. ``device`` defaults to ``cuda``."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], rpn_head: Dict[str, Any],
                 bbox_head: Dict[str, Any], dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        kw = dict(dtype=dtype, device=resolve_device(device))
        self.backbone = BACKBONES.build(dict(backbone), **kw)
        self.neck = NECKS.build(dict(neck), **kw)
        self.rpn = HEADS.build(dict(rpn_head), **kw)
        # the box head reads the neck's channels (flax infers them at init)
        self.bbox_head = HEADS.build(dict(bbox_head), in_channels=neck["out_channels"], **kw)

    def forward(self, images: Tensor):
        """(B, H, W, 3) -> (NHWC feats, per-level (B, H, W, A) RPN scores,
        per-level (B, H, W, A*4) RPN deltas)."""
        x = images.to(self.dtype).contiguous()
        feats = self.neck(self.backbone(x))
        rpn_scores, rpn_deltas = self.rpn(feats)
        return feats, rpn_scores, rpn_deltas

    def roi_forward(self, roi_feats: Tensor) -> Tuple[Tensor, Tensor]:
        """Second stage on aligned (B, R, S, S, C) roi features."""
        return self.bbox_head(roi_feats)


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    """The inference fields of the reference's ``FasterRCNNConfig``, with
    its defaults."""

    num_classes: int = 80
    anchor_generator: AnchorGenerator = AnchorGenerator(
        strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0),
        scales=(8.0,), octave_base_scale=None,
    )
    roi_strides: Tuple[int, ...] = (4, 8, 16, 32)  # P2..P5 carry rois
    roi_size: int = 7
    finest_scale: float = 56.0
    proposal_test: ProposalConfig = ProposalConfig(
        pre_nms_per_level=1000, post_nms_top_k=1000, nms_iou_thr=0.7
    )
    rcnn_target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    rcnn_target_stds: Tuple[float, float, float, float] = (0.1, 0.1, 0.2, 0.2)
    score_thr: float = 0.05
    nms_iou_thr: float = 0.5
    max_detections: int = 100


def faster_rcnn_inference(
    cfg: FasterRCNNConfig,
    model: TwoStageDetector,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Proposals -> RoIAlign -> box head -> per-class decode + NMS, padded."""
    feats, rpn_scores, rpn_deltas = model(images)
    proposals = generate_proposals(
        cfg.proposal_test, cfg.anchor_generator, rpn_scores, rpn_deltas, img_shapes
    )
    roi_feats = batched_multilevel_roi_align(
        list(feats[: len(cfg.roi_strides)]),  # native dtype; the kernel accumulates f32
        proposals.boxes, cfg.roi_strides, cfg.roi_size, finest_scale=cfg.finest_scale,
    )
    cls_logits, reg_pred = model.roi_forward(roi_feats)
    probs = torch.softmax(cls_logits.float(), dim=-1)[..., 1:]  # drop background
    b, r = probs.shape[:2]

    boxes = delta2bbox(proposals.boxes, reg_pred.float(), cfg.rcnn_target_means,
                       cfg.rcnn_target_stds)
    if boxes.shape[-1] != 4:  # class-specific -> (B, R, C, 4)
        boxes = boxes.reshape(b, r, -1, 4)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    scores = torch.where(proposals.valid[..., None], probs, torch.zeros_like(probs))
    res = multiclass_nms(
        boxes, scores, iou_thr=cfg.nms_iou_thr, score_thr=cfg.score_thr,
        pre_nms_top_k=min(1000, r * probs.shape[-1]), max_out=cfg.max_detections,
    )
    if scale_factors is None:
        return res
    return res._replace(boxes=res.boxes / scale_factors.reshape(b, 1, -1).to(res.boxes.dtype))
