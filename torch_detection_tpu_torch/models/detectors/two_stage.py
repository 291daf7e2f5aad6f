"""Two-stage detector (Faster R-CNN): RPN proposals -> RoIAlign -> box head,
its training losses, and inference with per-class decode + NMS, padded.

Counterpart of ``torch_detection_tpu/models/detectors/two_stage.py``. Every
shape is fixed: (B, P) proposals with a validity mask, a constant number of
sampled anchors and rois an image (chosen by a stable top-k over sampling
priorities), mask-weighted losses, (B, max_detections) detections.

The sampling draws are tensors handed in by the caller through a ``noise``
function, ``noise(shape) -> (u_pos, u_all)``: ``sampling_noise`` makes them
from a ``torch.Generator``, and the tests hand in the reference's own
``jax.random`` draws.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...ops.anchors import AnchorGenerator
from ...ops.assign import MaxIoUAssigner
from ...ops.boxes import bbox2delta, clip_boxes, delta2bbox
from ...ops.losses import binary_cross_entropy, smooth_l1_loss, softmax_cross_entropy
from ...ops.nms import NMSResult, multiclass_nms, top_k_stable
from ...ops.roi_align import batched_multilevel_roi_align
from ...parallel.distributed import batch_normaliser
from ...utils.device import resolve_device
from ...utils.registry import BACKBONES, DETECTORS, HEADS
from ..heads.rpn_head import ProposalConfig, Proposals, generate_proposals
from ..layers import compute_autocast
from ..necks import build_neck

# noise(shape) -> (u_pos in [0, 1), u_all in [0, 0.5)), each of ``shape``
Noise = Callable[[Tuple[int, ...]], Tuple[Tensor, Tensor]]


class RoIDetector(nn.Module):
    """The backbone and neck of the RoI detectors, named as the reference's
    (``backbone``, ``neck``), and what their heads share. ``dtype`` is the
    compute dtype; images are cast to it. ``param_dtype`` (default
    ``dtype``) is the dtype the parameters are kept in, as flax's
    ``param_dtype``: where it differs from ``dtype``, the forwards run under
    ``torch.autocast``, which casts every conv and linear weight to ``dtype``
    at its use (once a forward), while the parameters and their gradients
    stay in ``param_dtype``. FrozenBN keeps float32 statistics either way.
    ``device`` defaults to ``cuda``."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any],
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.param_dtype = param_dtype or self.dtype
        self._device = resolve_device(device)
        self.backbone = self._build(BACKBONES, backbone)
        self.neck = build_neck(neck, self.backbone, dtype=self.param_dtype, device=self._device)
        self._neck_channels = neck["out_channels"]

    def _build(self, registry, cfg: Dict[str, Any], **kwargs) -> nn.Module:
        return registry.build(dict(cfg), dtype=self.param_dtype, device=self._device, **kwargs)

    def _build_roi_head(self, cfg: Dict[str, Any]) -> nn.Module:
        """A box or mask head; it reads the neck's channels, as flax infers
        them at init."""
        return self._build(HEADS, cfg, in_channels=self._neck_channels)

    def _autocast(self, x: Tensor):
        return compute_autocast(x, self.dtype, self.param_dtype)

    def roi_forward(self, roi_feats: Tensor) -> Tuple[Tensor, Tensor]:
        """The box head on aligned (B, R, S, S, C) roi features."""
        with self._autocast(roi_feats):
            return self.bbox_head(roi_feats)


@DETECTORS.register_module
class TwoStageDetector(RoIDetector):
    """backbone + neck + RPN head + RoI box head, named as the reference's
    (``backbone``, ``neck``, ``rpn``, ``bbox_head``); ``RoIDetector``'s
    dtypes and device."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], rpn_head: Dict[str, Any],
                 bbox_head: Dict[str, Any], dtype: Optional[torch.dtype] = None,
                 param_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__(backbone, neck, dtype, param_dtype, device)
        self.rpn = self._build(HEADS, rpn_head)
        self.bbox_head = self._build_roi_head(bbox_head)

    def forward(self, images: Tensor):
        """(B, H, W, 3) -> (NHWC feats, per-level (B, H, W, A) RPN scores,
        per-level (B, H, W, A*4) RPN deltas)."""
        x = images.to(self.dtype).contiguous()
        with self._autocast(x):
            feats = self.neck(self.backbone(x))
            rpn_scores, rpn_deltas = self.rpn(feats)
        return feats, rpn_scores, rpn_deltas


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    """The reference's ``FasterRCNNConfig``, with its defaults, less its
    ``approx_top_k`` switch (a TPU approximation)."""

    num_classes: int = 80
    anchor_generator: AnchorGenerator = AnchorGenerator(
        strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0),
        scales=(8.0,), octave_base_scale=None,
    )
    roi_strides: Tuple[int, ...] = (4, 8, 16, 32)  # P2..P5 carry rois
    roi_size: int = 7
    finest_scale: float = 56.0
    # rpn train
    rpn_assigner: MaxIoUAssigner = MaxIoUAssigner(
        pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3
    )
    rpn_num_samples: int = 256
    rpn_pos_fraction: float = 0.5
    rpn_target_stds: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    proposal_train: ProposalConfig = ProposalConfig(
        pre_nms_per_level=2000, post_nms_top_k=1000, nms_iou_thr=0.7
    )
    proposal_test: ProposalConfig = ProposalConfig(
        pre_nms_per_level=1000, post_nms_top_k=1000, nms_iou_thr=0.7
    )
    # rcnn train
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


def sampling_noise(generator: torch.Generator, shape: Tuple[int, ...]) -> Tuple[Tensor, Tensor]:
    """The two uniform draws of one ``_sample_fixed`` call, on the
    generator's device: ``u_pos`` in [0, 1) ranks the positives, ``u_all``
    in [0, 0.5) orders the priorities."""
    u_pos = torch.rand(shape, generator=generator, device=generator.device)
    u_all = torch.rand(shape, generator=generator, device=generator.device) * 0.5
    return u_pos, u_all


def _sample_fixed(
    pos_mask: Tensor,  # (..., N) bool
    neg_mask: Tensor,  # (..., N) bool
    num: int,
    pos_fraction: float,
    u_pos: Tensor,  # (..., N) uniform [0, 1)
    u_all: Tensor,  # (..., N) uniform [0, 0.5)
) -> Tuple[Tensor, Tensor, Tensor]:
    """Fixed-shape random sampling -> (indices (..., num), is_pos, is_valid).

    Positives get priority 2+u, negatives 1+u, the rest u < 1; a top-k
    takes ``num`` with positives first, capped at the quota: a positive is
    kept if its ``u_pos`` is at least the quota-th largest among the
    positives (all of them when there are fewer). The top-k is stable, so
    equal priorities go to the lower index, as XLA's ``top_k``."""
    num_pos_wanted = int(num * pos_fraction)
    pos_rank_scores = torch.where(pos_mask, u_pos, torch.full_like(u_pos, -1.0))
    kth = torch.topk(pos_rank_scores, num_pos_wanted, dim=-1).values[..., -1:]
    pos_sel = pos_mask & (pos_rank_scores >= torch.clamp(kth, min=0.0))
    priority = torch.where(pos_sel, 2.0 + u_all, torch.where(neg_mask, 1.0 + u_all, u_all))
    top_p, idx = top_k_stable(priority, num)
    return idx, top_p >= 2.0, top_p >= 1.0


def _take(x: Tensor, idx: Tensor) -> Tensor:
    """``x[b, idx[b]]`` for (B, N, ...) ``x`` and (B, K) ``idx``."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx]


def rpn_losses(
    cfg: FasterRCNNConfig,
    anchors: Tensor,  # (N, 4)
    flat_rpn_s: Tensor,  # (B, N) f32
    flat_rpn_d: Tensor,  # (B, N, 4) f32
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G)
    gt_valid: Tensor,  # (B, G)
    noise: Noise,
) -> Tuple[Tensor, Tensor]:
    """Per-image RPN cls/reg losses on a fixed sampled slate -> ((B,), (B,))."""
    assign = cfg.rpn_assigner(anchors, gt_boxes, gt_valid, gt_labels)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    idx, is_pos, is_valid = _sample_fixed(pos, neg, cfg.rpn_num_samples, cfg.rpn_pos_fraction,
                                          *noise(tuple(pos.shape)))
    s = _take(flat_rpn_s, idx)
    d = _take(flat_rpn_d, idx)
    safe_gt = (_take(assign.assigned_gt_inds, idx).long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    targets = bbox2delta(anchors[idx], _take(gt_boxes, safe_gt), stds=cfg.rpn_target_stds)
    w = is_valid.float()
    n_valid = torch.clamp(w.sum(dim=1), min=1.0)
    pos_w = is_pos.float()
    cls = [binary_cross_entropy(s[i], pos_w[i], weight=w[i], avg_factor=n_valid[i])
           for i in range(s.shape[0])]
    reg = [smooth_l1_loss(d[i], targets[i], weight=pos_w[i, :, None], beta=1.0 / 9.0,
                          avg_factor=n_valid[i])
           for i in range(s.shape[0])]
    return torch.stack(cls), torch.stack(reg)


def flatten_rpn_outputs(
    rpn_scores: Sequence[Tensor], rpn_deltas: Sequence[Tensor]
) -> Tuple[Tensor, Tensor]:
    """Per-level (B,H,W,A)/(B,H,W,A*4) -> flat f32 (B, N) / (B, N, 4)."""
    b = rpn_scores[0].shape[0]
    flat_s = torch.cat([s.reshape(b, -1).float() for s in rpn_scores], dim=1)
    flat_d = torch.cat([d.reshape(b, -1, 4).float() for d in rpn_deltas], dim=1)
    return flat_s, flat_d


class SampledRois(NamedTuple):
    rois: Tensor  # (B, num, 4)
    labels: Tensor  # (B, num) int32, 0 = background
    reg_targets: Tensor  # (B, num, 4)
    is_pos: Tensor  # (B, num) bool
    is_valid: Tensor  # (B, num) bool
    matched: Tensor  # (B, num) int64 index of the assigned gt, clamped into [0, G)
    from_gt: Tensor  # (B, num) bool: sampled out of the appended gt block


def sample_rois(
    cfg: FasterRCNNConfig,
    boxes: Tensor,  # (B, P, 4) candidate boxes: proposals, or a cascade stage's refined rois
    valid: Tensor,  # (B, P) bool
    gt_boxes: Tensor,  # (B, G, 4)
    gt_labels: Tensor,  # (B, G)
    gt_valid: Tensor,  # (B, G)
    noise: Noise,
    assigner: Optional[MaxIoUAssigner] = None,
    target_stds: Optional[Tuple[float, float, float, float]] = None,
) -> SampledRois:
    """The second stage's roi slate: the candidates plus the gt (which
    guarantee positives early on), assigned by ``assigner`` (default
    ``cfg.rcnn_assigner``) and sampled, ``min(rcnn_num_samples, P + G)`` an
    image; regression targets normalised by ``target_stds`` (default
    ``cfg.rcnn_target_stds``)."""
    assigner = assigner or cfg.rcnn_assigner
    target_stds = target_stds or cfg.rcnn_target_stds
    cand = torch.cat([boxes, gt_boxes.to(boxes.dtype)], dim=1)
    cand_valid = torch.cat([valid, gt_valid], dim=1)
    assign = assigner(cand, gt_boxes, gt_valid, gt_labels, anchor_valid=cand_valid)
    pos = assign.assigned_gt_inds > 0
    neg = assign.assigned_gt_inds == 0
    num = min(cfg.rcnn_num_samples, cand.shape[1])
    idx, is_pos, is_valid = _sample_fixed(pos, neg, num, cfg.rcnn_pos_fraction,
                                          *noise(tuple(pos.shape)))
    rois = _take(cand, idx)
    labels = _take(assign.labels, idx)
    labels = torch.where(is_pos, labels, torch.zeros_like(labels))
    safe_gt = (_take(assign.assigned_gt_inds, idx).long() - 1).clamp(0, gt_boxes.shape[1] - 1)
    reg_t = bbox2delta(rois, _take(gt_boxes, safe_gt), cfg.rcnn_target_means, target_stds)
    return SampledRois(rois, labels, reg_t, is_pos, is_valid, safe_gt, idx >= boxes.shape[1])


def rcnn_losses(
    cfg: FasterRCNNConfig, cls_logits: Tensor, reg_pred: Tensor, sampled: SampledRois
) -> Tuple[Tensor, Tensor]:
    """The box head's cls and reg losses over the batch's sampled rois. A
    class-specific head's (..., C * 4) deltas are read at each roi's class,
    ``clip(label - 1, 0, C - 1)`` (background rois carry no reg weight)."""
    cls_logits, reg_pred = cls_logits.float(), reg_pred.float()
    if reg_pred.shape[-1] != 4:
        per_class = reg_pred.reshape(*reg_pred.shape[:-1], cfg.num_classes, 4)
        label = (sampled.labels.long() - 1).clamp(0, cfg.num_classes - 1)
        reg_pred = torch.gather(per_class, -2, label[..., None, None].expand(
            *label.shape, 1, 4)).squeeze(-2)
    w_valid = sampled.is_valid.float()
    n_valid = batch_normaliser(w_valid.sum())
    cls_l = softmax_cross_entropy(cls_logits, sampled.labels, weight=w_valid, avg_factor=n_valid)
    pos_w = sampled.is_pos.float()
    n_pos = batch_normaliser(pos_w.sum())
    reg_l = smooth_l1_loss(reg_pred, sampled.reg_targets, weight=pos_w[..., None],
                           beta=cfg.smooth_l1_beta, avg_factor=n_pos)
    return cls_l, reg_l


def faster_rcnn_loss(
    cfg: FasterRCNNConfig, model: TwoStageDetector, batch: Dict[str, Tensor], noise: Noise
) -> Dict[str, Tensor]:
    """Both stages' losses of one batch: ``loss`` (their sum), the four
    parts, and ``num_pos_rois``."""
    losses, _, _ = _faster_rcnn_loss_core(cfg, model, batch, noise)
    return losses


def _faster_rcnn_loss_core(
    cfg: FasterRCNNConfig, model: TwoStageDetector, batch: Dict[str, Tensor], noise: Noise
) -> Tuple[Dict[str, Tensor], Tuple[Tensor, ...], Proposals]:
    """The loss body; also returns ``(feats, proposals)`` so that an
    extension (the mask branch) reuses the same forward.

    ``batch``: ``image`` (B, H, W, 3), ``gt_boxes`` (B, G, 4), ``gt_labels``
    (B, G) 1-based, ``gt_valid`` (B, G), and optionally ``img_shape`` (B, 2).
    ``noise`` is called twice: for the RPN's anchors, then for the rois."""
    gt = (batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"])
    losses, feats, proposals = _rpn_stage(cfg, model, batch, noise)
    sampled = sample_rois(cfg, proposals.boxes, proposals.valid, *gt, noise)
    roi_feats = roi_features(cfg, feats, sampled.rois)
    rcnn_cls_l, rcnn_reg_l = rcnn_losses(cfg, *model.roi_forward(roi_feats), sampled)
    losses = dict(losses, loss=losses["loss"] + rcnn_cls_l + rcnn_reg_l, loss_rcnn_cls=rcnn_cls_l,
                  loss_rcnn_reg=rcnn_reg_l, num_pos_rois=sampled.is_pos.float().sum())
    return losses, feats, proposals


def _rpn_stage(
    cfg: FasterRCNNConfig, model: TwoStageDetector, batch: Dict[str, Tensor], noise: Noise
) -> Tuple[Dict[str, Tensor], Tuple[Tensor, ...], Proposals]:
    """The forward, the RPN's losses (``loss`` their sum, ``loss_rpn_cls``,
    ``loss_rpn_reg``; ``noise`` called once, for the anchors) and the
    training proposals, which carry no gradient back into the RPN."""
    gt_boxes, gt_labels, gt_valid = batch["gt_boxes"], batch["gt_labels"], batch["gt_valid"]
    feats, rpn_scores, rpn_deltas = model(batch["image"])
    featmap_sizes = [tuple(s.shape[1:3]) for s in rpn_scores]
    anchors = cfg.anchor_generator.flat_anchors(featmap_sizes, gt_boxes.device)
    flat_rpn_s, flat_rpn_d = flatten_rpn_outputs(rpn_scores, rpn_deltas)
    rpn_cls_l, rpn_reg_l = rpn_losses(cfg, anchors, flat_rpn_s, flat_rpn_d, gt_boxes, gt_labels,
                                      gt_valid, noise)
    proposals = generate_proposals(
        cfg.proposal_train, cfg.anchor_generator, [s.detach() for s in rpn_scores],
        [d.detach() for d in rpn_deltas], batch.get("img_shape"),
    )
    loss_rpn_cls, loss_rpn_reg = rpn_cls_l.mean(), rpn_reg_l.mean()
    losses = {"loss": loss_rpn_cls + loss_rpn_reg, "loss_rpn_cls": loss_rpn_cls,
              "loss_rpn_reg": loss_rpn_reg}
    return losses, feats, proposals


def roi_features(cfg, feats: Sequence[Tensor], rois: Tensor, out_size: Optional[int] = None) -> Tensor:
    """(B, R, S, S, C) RoIAlign of ``rois`` on the levels of ``cfg.roi_strides``
    (K1, and K2 in the backward), at ``cfg.roi_size`` unless ``out_size``;
    the levels keep their dtype and the kernel accumulates in float32."""
    return batched_multilevel_roi_align(
        list(feats[: len(cfg.roi_strides)]), rois, cfg.roi_strides, out_size or cfg.roi_size,
        finest_scale=cfg.finest_scale,
    )


def faster_rcnn_inference(
    cfg: FasterRCNNConfig,
    model: TwoStageDetector,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """Proposals -> RoIAlign -> box head -> per-class decode + NMS, padded."""
    res, _ = _faster_rcnn_inference_core(cfg, model, images, img_shapes)
    return undo_scale(res, scale_factors)


def undo_scale(res: NMSResult, scale_factors: Optional[Tensor]) -> NMSResult:
    """Detections in the original frame: the boxes divided by each image's
    (B,) or (B, 4) scale factors."""
    if scale_factors is None:
        return res
    b = res.boxes.shape[0]
    return res._replace(boxes=res.boxes / scale_factors.reshape(b, 1, -1).to(res.boxes.dtype))


def _faster_rcnn_inference_core(
    cfg: FasterRCNNConfig,
    model: TwoStageDetector,
    images: Tensor,
    img_shapes: Optional[Tensor] = None,
) -> Tuple[NMSResult, Tuple[Tensor, ...]]:
    """The detections in the network's frame, and the FPN levels they came
    from, so that an extension (the mask branch) reuses the same forward."""
    feats, rpn_scores, rpn_deltas = model(images)
    proposals = generate_proposals(
        cfg.proposal_test, cfg.anchor_generator, rpn_scores, rpn_deltas, img_shapes
    )
    return rcnn_detections(cfg, model, feats, proposals.boxes, proposals.valid, img_shapes), feats


def rcnn_detections(
    cfg: FasterRCNNConfig,
    model: nn.Module,
    feats: Sequence[Tensor],
    rois: Tensor,  # (B, R, 4)
    valid: Tensor,  # (B, R) bool
    img_shapes: Optional[Tensor] = None,
) -> NMSResult:
    """RoIAlign -> box head -> per-class decode + NMS on ``rois``, in the
    network's frame; rois outside ``valid`` score 0."""
    cls_logits, reg_pred = model.roi_forward(roi_features(cfg, feats, rois))
    probs = torch.softmax(cls_logits.float(), dim=-1)[..., 1:]  # drop background
    b, r = probs.shape[:2]
    boxes = delta2bbox(rois, reg_pred.float(), cfg.rcnn_target_means, cfg.rcnn_target_stds)
    if boxes.shape[-1] != 4:  # class-specific -> (B, R, C, 4)
        boxes = boxes.reshape(b, r, -1, 4)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    return class_nms(cfg, boxes, probs, valid)


def class_nms(cfg, boxes: Tensor, probs: Tensor, valid: Tensor) -> NMSResult:
    """Per-class NMS of (B, R, C) foreground ``probs`` on (B, R, 4) or
    (B, R, C, 4) boxes, rois outside ``valid`` scoring 0."""
    scores = torch.where(valid[..., None], probs, torch.zeros_like(probs))
    return multiclass_nms(
        boxes, scores, iou_thr=cfg.nms_iou_thr, score_thr=cfg.score_thr,
        pre_nms_top_k=min(1000, probs.shape[1] * probs.shape[2]), max_out=cfg.max_detections,
    )
