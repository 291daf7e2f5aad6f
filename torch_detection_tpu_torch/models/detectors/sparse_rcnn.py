"""Sparse R-CNN: learnable proposals refined by six dynamic-interaction
stages, per-stage Hungarian set losses, and a decode without NMS.

Counterpart of ``torch_detection_tpu/models/detectors/sparse_rcnn.py``
(Sun et al. 2021; mmdetection's ``SparseRCNN``, ``DIIHead`` and
``DynamicConv``). A fixed slate of ``num_proposals`` learnable boxes and
features goes through ``num_stages`` stages, each RoIAlign of its boxes
(K1, and K2 in the backward) on P2-P5, then the proposals' self-attention,
the dynamic convolution whose two 1x1 kernels each proposal's feature
generates, an FFN, and the class and box heads; the box deltas refine the
stage's boxes for the next. RoIAlign gives the boxes no gradient, and every
stage after the first takes the previous boxes detached, so the proposal
boxes learn through stage 0's delta decode alone.

Flax's ``LayerNorm``s, ``fc_cls``, ``fc_reg`` and ``proposal_boxes``
compute in float32 from float32 parameters in every build; the rest runs in
the compute dtype.

The set loss is three steps, each its own function: the (G, Q) matching
cost of every stage and image, the matching (``ops/hungarian.py``: on the
card one kernel launch a step, no host sync), and the losses given a
matching. The matching cost adds mmdetection's ``IoUCost(giou)`` per pair,
where the reference adds one scalar (its ``iou_loss`` sums the matrix).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...ops.boxes import delta2bbox
from ...ops.hungarian import batched_linear_sum_assignment
from ...ops.losses import iou_loss, iou_loss_elementwise, sigmoid_focal_loss_sparse
from ...ops.nms import NMSResult, top_k_stable
from ...ops.roi_align import batched_multilevel_roi_align
from ...parallel.distributed import batch_normaliser
from ...utils.registry import DETECTORS
from ..inits import bias_init_with_prob, normal_
from ..layers import Float32Linear, LayerNorm, MultiHeadDotProductAttention
from .two_stage import RoIDetector


class DynamicConv(nn.Module):
    """Each proposal's feature generates the weights of two 1x1 convs
    applied to its own roi features (flax's ``_DynamicConv``:
    ``param_gen``, ``norm1``, ``norm2``, ``fc_out``). Parameters in
    ``param_dtype``, compute in ``dtype``."""

    def __init__(self, d_model: int, dynamic_dim: int, roi_size: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        self.d_model, self.dynamic_dim, self.dtype = d_model, dynamic_dim, dtype
        kw = dict(dtype=param_dtype, device=device)
        self.param_gen = nn.Linear(d_model, 2 * d_model * dynamic_dim, **kw)
        self.norm1 = LayerNorm(dynamic_dim, device=device)
        self.norm2 = LayerNorm(d_model, device=device)
        self.fc_out = nn.Linear(roi_size * roi_size * d_model, d_model, **kw)

    def forward(self, roi_feats: Tensor, obj: Tensor) -> Tensor:
        """roi_feats (B, N, S, S, C), obj (B, N, C) -> (B, N, C)."""
        b, n, s, _, c = roi_feats.shape
        d, k = self.d_model, self.dynamic_dim
        if c != d:
            raise ValueError(f"roi feature channels ({c}) must equal d_model ({d}): set the "
                             "neck's out_channels to d_model")
        params = self.param_gen(obj.to(self.dtype))
        p1 = params[..., : d * k].reshape(b, n, d, k)
        p2 = params[..., d * k:].reshape(b, n, k, d)
        f = roi_feats.reshape(b, n, s * s, d).to(params.dtype)
        f = F.relu(self.norm1(torch.matmul(f, p1))).to(params.dtype)
        f = F.relu(self.norm2(torch.matmul(f, p2))).to(params.dtype)
        return self.fc_out(f.reshape(b, n, s * s * d))


class DIIHead(nn.Module):
    """One stage: proposal self-attention, the dynamic interaction, an FFN,
    then the class and box branches (flax's ``_DIIHead``, its submodule
    names). Returns (obj, logits float32, deltas float32)."""

    def __init__(self, num_classes: int, d_model: int, nhead: int, dim_feedforward: int,
                 dynamic_dim: int, roi_size: int, num_cls_fcs: int, num_reg_fcs: int,
                 dtype: torch.dtype, param_dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype, self.num_cls_fcs, self.num_reg_fcs = dtype, num_cls_fcs, num_reg_fcs
        kw = dict(dtype=param_dtype, device=device)
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, **kw)
        self.norm_attn = LayerNorm(d_model, device=device)
        self.dynamic_conv = DynamicConv(d_model, dynamic_dim, roi_size, dtype, param_dtype, device)
        self.norm_inter = LayerNorm(d_model, device=device)
        self.ffn_fc1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.ffn_fc2 = nn.Linear(dim_feedforward, d_model, **kw)
        self.norm_ffn = LayerNorm(d_model, device=device)
        for i in range(num_cls_fcs):
            setattr(self, f"cls_fc{i}", nn.Linear(d_model, d_model, bias=False, **kw))
            setattr(self, f"cls_norm{i}", LayerNorm(d_model, device=device))
        self.fc_cls = Float32Linear(d_model, num_classes, device=device)
        self.fc_cls.init_bias = bias_init_with_prob(0.01)
        for i in range(num_reg_fcs):
            setattr(self, f"reg_fc{i}", nn.Linear(d_model, d_model, bias=False, **kw))
            setattr(self, f"reg_norm{i}", LayerNorm(d_model, device=device))
        self.fc_reg = Float32Linear(d_model, 4, device=device)

    def forward(self, roi_feats: Tensor, obj: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """roi_feats (B, N, S, S, C), obj (B, N, C) in the compute dtype."""
        return self.ffn_and_heads(self.interaction(roi_feats, self.attention(obj)))

    def attention(self, obj: Tensor) -> Tensor:
        """The proposals' self-attention and its LayerNorm."""
        sa = self.self_attn(obj.to(self.dtype))
        return self.norm_attn(obj + sa).to(sa.dtype)

    def interaction(self, roi_feats: Tensor, obj: Tensor) -> Tensor:
        """The dynamic convolution on the roi features and its LayerNorm."""
        return self.norm_inter(obj + self.dynamic_conv(roi_feats, obj)).to(obj.dtype)

    def ffn_and_heads(self, obj: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
        """The FFN and its LayerNorm, then the class and box branches."""
        h = self.ffn_fc2(F.relu(self.ffn_fc1(obj)))
        obj = self.norm_ffn(obj + h).to(obj.dtype)
        c = obj
        for i in range(self.num_cls_fcs):
            c = F.relu(getattr(self, f"cls_norm{i}")(getattr(self, f"cls_fc{i}")(c.to(self.dtype))))
        r = obj
        for i in range(self.num_reg_fcs):
            r = F.relu(getattr(self, f"reg_norm{i}")(getattr(self, f"reg_fc{i}")(r.to(self.dtype))))
        return obj, self.fc_cls(c), self.fc_reg(r)


def canvas_shapes(images: Tensor) -> Tensor:
    """(B, 2) float32 (h, w) of the canvas of (B, H, W, 3) ``images``."""
    h, w = images.shape[1:3]
    return torch.tensor([[h, w]], dtype=torch.float32, device=images.device).expand(
        images.shape[0], 2)


def _whwh(img_shapes: Tensor) -> Tensor:
    """(B, 4) float32 (w, h, w, h) of (B, 2) (h, w) ``img_shapes``."""
    hw = img_shapes.float()
    return torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)


def cxcywh_to_xyxy(boxes: Tensor) -> Tensor:
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], dim=-1)


@DETECTORS.register_module
class SparseRCNN(RoIDetector):
    """backbone + FPN -> ``num_stages`` (RoIAlign -> ``DIIHead``) stages on
    a learnable slate (``backbone``, ``neck``, ``proposal_boxes``,
    ``proposal_features``, ``stage0`` to ``stage{S-1}``, as flax names
    them); ``RoIDetector``'s dtypes, device and autocast.
    ``proposal_boxes`` stays float32 in every build."""

    def __init__(self, backbone: Dict[str, Any], neck: Dict[str, Any], num_proposals: int = 100,
                 num_stages: int = 6, num_classes: int = 80, d_model: int = 256, nhead: int = 8,
                 dim_feedforward: int = 2048, dynamic_dim: int = 64, roi_size: int = 7,
                 roi_strides: Sequence[int] = (4, 8, 16, 32), finest_scale: float = 56.0,
                 num_cls_fcs: int = 1, num_reg_fcs: int = 3,
                 target_stds: Tuple[float, float, float, float] = (0.5, 0.5, 1.0, 1.0),
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__(backbone, neck, dtype, param_dtype, device)
        self.num_stages, self.roi_size = num_stages, roi_size
        self.roi_strides, self.finest_scale = tuple(roi_strides), finest_scale
        self.target_stds = tuple(target_stds)
        self.proposal_boxes = nn.Parameter(
            torch.tensor([[0.5, 0.5, 1.0, 1.0]] * num_proposals, device=self._device))
        self.proposal_features = nn.Parameter(
            torch.zeros((num_proposals, d_model), dtype=self.param_dtype, device=self._device))
        for i in range(num_stages):
            setattr(self, f"stage{i}", DIIHead(
                num_classes, d_model, nhead, dim_feedforward, dynamic_dim, roi_size, num_cls_fcs,
                num_reg_fcs, self.dtype, self.param_dtype, self._device))

    def init_own(self, generator: torch.Generator) -> None:
        """The reference's initialiser of the proposal features, normal(1.0);
        the boxes are built at theirs, every box the whole image."""
        normal_(self.proposal_features, 1.0, generator)

    def features(self, images: Tensor) -> Tuple[Tensor, ...]:
        """(B, H, W, 3) -> the NHWC FPN levels in the compute dtype."""
        x = images.to(self.dtype).contiguous()
        with self._autocast(x):
            return self.neck(self.backbone(x))

    def initial_slate(self, feats: Sequence[Tensor], img_shapes: Tensor) -> Tuple[Tensor, Tensor]:
        """Stage 0's boxes (B, N, 4) on each image's (h, w) ``img_shapes``,
        absolute continuous xyxy in float32 with their gradient into
        ``proposal_boxes``, and its proposal features (B, N, C) in the
        levels' dtype."""
        b = feats[0].shape[0]
        pb = self.proposal_boxes
        # keep the learnable slate well-formed whatever the optimizer does
        pb = torch.cat([pb[:, :2], torch.clamp(pb[:, 2:], min=1e-2)], dim=-1)
        boxes = cxcywh_to_xyxy(pb)[None] * _whwh(img_shapes)[:, None, :]
        obj = self.proposal_features[None].expand(b, -1, -1).to(feats[0].dtype)
        return boxes, obj

    def roi_features(self, feats: Sequence[Tensor], boxes: Tensor) -> Tensor:
        """RoIAlign (K1; K2 in the backward) of continuous xyxy ``boxes`` on
        P2-P5, as inclusive rois that carry no gradient."""
        rois = torch.cat([boxes[..., :2], boxes[..., 2:] - 1.0], dim=-1).detach()
        return batched_multilevel_roi_align(list(feats[: len(self.roi_strides)]), rois,
                                            self.roi_strides, self.roi_size,
                                            finest_scale=self.finest_scale)

    def stage_forward(self, t: int, roi_feats: Tensor, obj: Tensor
                      ) -> Tuple[Tensor, Tensor, Tensor]:
        """Stage ``t``'s head: (obj, logits, deltas)."""
        with self._autocast(roi_feats):
            return self.get_submodule(f"stage{t}")(roi_feats, obj)

    def refine(self, boxes: Tensor, deltas: Tensor) -> Tensor:
        """The stage's boxes decoded by its float32 deltas, continuous xyxy."""
        rois = torch.cat([boxes[..., :2], boxes[..., 2:] - 1.0], dim=-1)
        out = delta2bbox(rois, deltas, stds=self.target_stds)
        return torch.cat([out[..., :2], out[..., 2:] + 1.0], dim=-1)

    def forward(self, images: Tensor, img_shapes: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
        """(B, H, W, 3) and (B, 2) un-padded (h, w) -> (S, B, N, C) float32
        logits and (S, B, N, 4) float32 boxes, absolute continuous xyxy. The
        slate spans the canvas where ``img_shapes`` is None."""
        if img_shapes is None:
            img_shapes = canvas_shapes(images)
        feats = self.features(images)
        boxes, obj = self.initial_slate(feats, img_shapes)
        all_logits, all_boxes = [], []
        for t in range(self.num_stages):
            if t > 0:
                boxes = boxes.detach()
            obj, logits, deltas = self.stage_forward(t, self.roi_features(feats, boxes), obj)
            boxes = self.refine(boxes, deltas)
            all_logits.append(logits)
            all_boxes.append(boxes)
        return torch.stack(all_logits), torch.stack(all_boxes)


@dataclasses.dataclass(frozen=True)
class SparseRCNNConfig:
    """The reference's ``SparseRCNNConfig``, with its defaults."""

    num_classes: int = 80
    num_proposals: int = 100
    # matching-cost and loss weights (paper / mmdetection defaults)
    cls_weight: float = 2.0
    l1_weight: float = 5.0
    giou_weight: float = 2.0
    focal_gamma: float = 2.0
    focal_alpha: float = 0.25
    # inference
    score_thr: float = 0.0
    max_detections: int = 100


def set_targets(gt_boxes: Tensor, gt_valid: Tensor, img_shapes: Tensor) -> Tuple[Tensor, Tensor]:
    """The gts as continuous xyxy (B, G, 4), zero where invalid, and each
    image's (w, h, w, h) (B, 4)."""
    gt_xyxy = torch.cat([gt_boxes[..., :2], gt_boxes[..., 2:] + 1.0], dim=-1)
    return torch.where(gt_valid.bool()[..., None], gt_xyxy, 0.0), _whwh(img_shapes)


def matching_cost(cfg: SparseRCNNConfig, cls_logits: Tensor, pred_boxes: Tensor, gt_xyxy: Tensor,
                  gt_labels: Tensor, whwh: Tensor) -> Tensor:
    """(S, B, G, Q) cost of matching each gt to each query, on detached
    predictions: ``cls_weight`` x the focal classification cost, plus
    ``l1_weight`` x the L1 distance of the whwh-normalised boxes, plus
    ``giou_weight`` x -GIoU of the pair (mmdetection's ``FocalLossCost``,
    ``BBoxL1Cost`` and ``IoUCost(giou)``)."""
    with torch.no_grad():
        num_stages, _, q, c = cls_logits.shape
        p = torch.sigmoid(cls_logits.float())
        eps = 1e-8
        pos = -torch.log(p + eps) * cfg.focal_alpha * (1 - p) ** cfg.focal_gamma
        neg = -torch.log(1 - p + eps) * (1 - cfg.focal_alpha) * p ** cfg.focal_gamma
        label0 = (gt_labels.long() - 1).clamp(0, c - 1)  # (B, G)
        index = label0[None, :, None, :].expand(num_stages, -1, q, -1)
        cost_cls = torch.gather(pos - neg, -1, index).transpose(-1, -2)
        pb = pred_boxes.float()
        pb_n = pb / whwh[None, :, None, :]
        gt_n = gt_xyxy / whwh[:, None, :]
        cost_l1 = (gt_n[None, :, :, None, :] - pb_n[:, :, None, :, :]).abs().sum(-1)
        cost_giou = iou_loss_elementwise(pb[:, :, None], gt_xyxy[None, :, :, None], "giou",
                                         offset=0.0) - 1.0
        return cfg.cls_weight * cost_cls + cfg.l1_weight * cost_l1 + cfg.giou_weight * cost_giou


def match(cost: Tensor, gt_valid: Tensor) -> Tensor:
    """``col4row`` (S, B, G) int32 of every stage's (DETR: decoder layer's)
    and image's problem in one call of ``batched_linear_sum_assignment`` (on
    the card one kernel launch); invalid gts get -1."""
    s, b, g, q = cost.shape
    valid = gt_valid.bool()[None].expand(s, b, g).reshape(s * b, g)
    return batched_linear_sum_assignment(cost.reshape(s * b, g, q), valid).reshape(s, b, g)


def set_losses(cfg: SparseRCNNConfig, cls_logits: Tensor, pred_boxes: Tensor, gt_xyxy: Tensor,
               gt_labels: Tensor, gt_valid: Tensor, whwh: Tensor, col4row: Tensor
               ) -> Dict[str, Tensor]:
    """Every stage's set losses given the matching ``col4row`` (S, B, G):
    the focal loss over all (Q, C) logits, each matched query carrying its
    gt's class and the others none; L1 on the whwh-normalised matched boxes;
    GIoU on the matched boxes. Normalised by ``num_boxes = max(sum valid,
    1) / B`` (GIoU by ``max(num_boxes, 1)``, as the reference's
    ``avg_factor``), summed over stages, averaged over images, weighted."""
    s, b, q, c = cls_logits.shape
    valid = gt_valid.bool()
    num_boxes = batch_normaliser(valid.float().sum()) / b
    label0 = (gt_labels.long() - 1).clamp(0, c - 1)
    cols = torch.where(valid[None], col4row.long(), q)  # unmatched rows write slot q
    target = torch.full((s, b, q + 1), -1, dtype=torch.long, device=cls_logits.device)
    target.scatter_(-1, cols, torch.where(valid, label0, -1)[None].expand(s, -1, -1))
    loss_cls = sigmoid_focal_loss_sparse(cls_logits, target[..., :q], gamma=cfg.focal_gamma,
                                         alpha=cfg.focal_alpha) / num_boxes / b
    index = col4row.long().clamp(0, q - 1)
    matched = torch.gather(pred_boxes, 2, index[..., None].expand(-1, -1, -1, 4))  # (S, B, G, 4)
    w = valid.float()
    l1 = (matched / whwh[None, :, None, :] - (gt_xyxy / whwh[:, None, :])[None]).abs()
    loss_l1 = (w[None, ..., None] * l1).sum() / num_boxes / b
    loss_giou = iou_loss(matched, gt_xyxy[None], w[None], "giou", offset=0.0,
                         avg_factor=num_boxes) / b
    loss_cls, loss_l1 = loss_cls * cfg.cls_weight, loss_l1 * cfg.l1_weight
    loss_giou = loss_giou * cfg.giou_weight
    return {"loss_cls": loss_cls, "loss_l1": loss_l1, "loss_giou": loss_giou,
            "loss": loss_cls + loss_l1 + loss_giou, "num_pos": w.sum(-1).mean()}


def sparse_rcnn_loss(
    cfg: SparseRCNNConfig,
    cls_logits: Tensor,  # (S, B, N, C)
    pred_boxes: Tensor,  # (S, B, N, 4) absolute continuous xyxy
    gt_boxes: Tensor,  # (B, G, 4) inclusive xyxy
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G)
    img_shapes: Tensor,  # (B, 2) un-padded (h, w)
) -> Dict[str, Tensor]:
    """Per-stage Hungarian set losses, summed over stages (paper eq. 1-2):
    ``matching_cost``, ``match``, ``set_losses``. No host sync: on the
    card the matching is one kernel launch whose result stays there."""
    gt_xyxy, whwh = set_targets(gt_boxes, gt_valid, img_shapes)
    cost = matching_cost(cfg, cls_logits, pred_boxes, gt_xyxy, gt_labels, whwh)
    col4row = match(cost, gt_valid)
    return set_losses(cfg, cls_logits, pred_boxes, gt_xyxy, gt_labels, gt_valid, whwh, col4row)


def sparse_rcnn_train_loss(cfg: SparseRCNNConfig, model: SparseRCNN,
                           batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The forward on the batch's images and ``sparse_rcnn_loss``, both given
    the batch's ``img_shape``, as the reference's loss function."""
    shapes = batch.get("img_shape")
    shapes = canvas_shapes(batch["image"]) if shapes is None else shapes.float()
    cls_logits, pred_boxes = model(batch["image"], shapes)
    return sparse_rcnn_loss(cfg, cls_logits, pred_boxes, batch["gt_boxes"], batch["gt_labels"],
                            batch["gt_valid"], shapes)


def top_k_detections(probs: Tensor, boxes: Tensor, img_shapes: Optional[Tensor],
                     scale_factors: Optional[Tensor], max_detections: int,
                     score_thr: float) -> NMSResult:
    """The set-prediction decode, with no NMS (set prediction is
    one-to-one): the top ``max_detections`` (query, class) pairs of
    ``probs`` (B, Q, C), their ``boxes`` (B, Q, 4) continuous xyxy made
    inclusive, clipped to ``img_shapes``, scale factors (B,) or (B, 4)
    undone per image; ``indices`` are the query ids. The top-k is stable, so
    equal scores go to the lower index, as XLA's ``top_k``."""
    b, q, c = probs.shape
    k = min(max_detections, q * c)
    scores, flat = top_k_stable(probs.reshape(b, q * c), k)
    query, label = flat // c, flat % c
    bx = torch.gather(boxes, 1, query[..., None].expand(-1, -1, 4))
    bx = torch.cat([bx[..., :2], bx[..., 2:] - 1.0], dim=-1)
    if img_shapes is not None:
        hw = img_shapes.float()
        x = torch.minimum(bx[..., 0::2].clamp(min=0), hw[:, 1, None, None] - 1.0)
        y = torch.minimum(bx[..., 1::2].clamp(min=0), hw[:, 0, None, None] - 1.0)
        bx = torch.stack([x[..., 0], y[..., 0], x[..., 1], y[..., 1]], dim=-1)
    if scale_factors is not None:
        bx = bx / scale_factors.reshape(b, 1, -1).to(bx.dtype)
    valid = scores > score_thr
    pad = max_detections - k
    if pad:  # fewer (query, class) pairs than detections: padded rows are invalid
        bx = torch.cat([bx, bx.new_zeros((b, pad, 4))], dim=1)
        scores, label, query, valid = (torch.cat([t, t.new_zeros((b, pad))], dim=1)
                                       for t in (scores, label, query, valid))
    return NMSResult(bx, torch.where(valid, scores, 0.0), torch.where(valid, label, -1), valid,
                     torch.where(valid, query, -1))


def decode_sparse_rcnn(
    cfg: SparseRCNNConfig,
    cls_logits: Tensor,  # (S, B, N, C)
    pred_boxes: Tensor,  # (S, B, N, 4) absolute continuous xyxy
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """``top_k_detections`` of the last stage's sigmoid scores and boxes
    (paper §3.4)."""
    return top_k_detections(torch.sigmoid(cls_logits[-1].float()), pred_boxes[-1].float(),
                            img_shapes, scale_factors, cfg.max_detections, cfg.score_thr)


def sparse_rcnn_inference(
    cfg: SparseRCNNConfig,
    model: SparseRCNN,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """The stages on ``img_shapes``' slates, then ``decode_sparse_rcnn``."""
    cls_logits, pred_boxes = model(images, img_shapes)
    return decode_sparse_rcnn(cfg, cls_logits, pred_boxes, img_shapes, scale_factors)
