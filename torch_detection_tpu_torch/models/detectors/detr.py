"""DETR: a transformer over the C5 features, a fixed set of learned queries,
Hungarian-matched set losses on every decoder layer, and a decode without
NMS.

Counterpart of ``torch_detection_tpu/models/detectors/detr.py`` (Carion et
al., ECCV 2020). The backbone's C5, projected to ``d_model`` channels, goes
through ``num_encoder_layers`` post-norm encoder layers and
``num_decoder_layers`` decoder layers of ``num_queries`` queries; each
decoder layer's output, normed by ``decoder_norm``, feeds the class and box
heads, so the outputs carry a leading decoder-layer axis. Canvas padding is
masked out of every attention over the image (a key mask) and out of the
sine positional encoding's normalisation.

As in the reference, every LayerNorm computes and returns float32, so the
tokens between layers are float32 in every build; each attention, FFN and
``bbox_fc1``/``bbox_fc2`` casts its inputs to the compute dtype, while
``class_embed``, ``bbox_out``, the box sigmoid and ``query_embed`` stay
float32.

The set loss is three steps, as Sparse R-CNN's: the (G, Q) matching cost of
every decoder layer and image, the matching (``ops/hungarian.py``: on the
card one kernel launch a step for all layers and images, no host sync), and
the losses given a matching. The matching cost adds the per-pair GIoU,
where the reference adds one scalar (its ``iou_loss`` sums the matrix).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...ops.losses import iou_loss, iou_loss_elementwise
from ...ops.nms import NMSResult
from ...parallel.distributed import batch_normaliser
from ...utils.device import resolve_device
from ...utils.registry import BACKBONES, DETECTORS
from ..inits import normal_
from ..layers import Float32Linear, LayerNorm, MultiHeadDotProductAttention, compute_autocast
from .sparse_rcnn import canvas_shapes, cxcywh_to_xyxy, match, top_k_detections


def sine_position_encoding(valid: Tensor, d_model: int, temperature: float = 10000.0) -> Tensor:
    """DETR's 2-D sine encoding (B, H, W, d_model) float32 of the (B, H, W)
    ``valid`` mask (1 inside the image, 0 on canvas padding): the cumulative
    sums over the valid cells, normalised by their last entry to [~0, 2 pi],
    divided by ``temperature ** (2 (i // 2) / half)``; the sine of the even
    and the cosine of the odd channels interleaved, y's channels then x's."""
    half = d_model // 2
    valid = valid.float()
    y = torch.cumsum(valid, dim=1)
    x = torch.cumsum(valid, dim=2)
    y = y / (y[:, -1:, :] + 1e-6) * (2.0 * math.pi)
    x = x / (x[:, :, -1:] + 1e-6) * (2.0 * math.pi)
    # a 0-d divisor: CUDA divides by a Python scalar's reciprocal
    exponent = 2.0 * torch.div(torch.arange(half, device=valid.device), 2,
                               rounding_mode="floor").float() / torch.full(
        (), half, dtype=torch.float32, device=valid.device)
    dim_t = torch.pow(torch.tensor(temperature, dtype=torch.float32, device=valid.device),
                      exponent)

    def embed(coord: Tensor) -> Tensor:
        pe = coord[..., None] / dim_t  # (B, H, W, half)
        return torch.stack([torch.sin(pe[..., 0::2]), torch.cos(pe[..., 1::2])],
                           dim=-1).reshape(*coord.shape, half)

    return torch.cat([embed(y), embed(x)], dim=-1)


def valid_cells(img_shapes: Optional[Tensor], batch: int, canvas_hw: Tuple[int, int],
                feat_hw: Tuple[int, int], device) -> Tensor:
    """(B, fh, fw) float32 1 where a C5 cell's centre ``(i + 0.5) * stride``
    lies at or inside its image's (h, w), 0 on the canvas padding; every
    cell where ``img_shapes`` is None. The stride is the canvas over the
    feature size, as a Python float."""
    fh, fw = feat_hw
    if img_shapes is None:
        return torch.ones((batch, fh, fw), dtype=torch.float32, device=device)
    hw = img_shapes.float()
    ys = (torch.arange(fh, dtype=torch.float32, device=device) + 0.5) * (canvas_hw[0] / fh)
    xs = (torch.arange(fw, dtype=torch.float32, device=device) + 0.5) * (canvas_hw[1] / fw)
    return ((ys[None, :, None] <= hw[:, 0, None, None])
            & (xs[None, None, :] <= hw[:, 1, None, None])).float()


class FFN(nn.Module):
    """fc1 -> ReLU -> fc2 in the compute ``dtype`` (flax's ``_FFN``)."""

    def __init__(self, d_model: int, dim_feedforward: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        self.fc1 = nn.Linear(d_model, dim_feedforward, **kw)
        self.fc2 = nn.Linear(dim_feedforward, d_model, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return self.fc2(F.relu(self.fc1(x.to(self.dtype))))


class EncoderLayer(nn.Module):
    """Post-norm encoder layer (flax's ``_EncoderLayer``): masked
    self-attention of ``src + pos`` onto ``src``, then the FFN, each added
    to its input and normed in float32."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, dtype=param_dtype,
                                                      device=device)
        self.norm1 = LayerNorm(d_model, device=device)
        self.ffn = FFN(d_model, dim_feedforward, dtype, param_dtype, device)
        self.norm2 = LayerNorm(d_model, device=device)

    def forward(self, src: Tensor, pos: Tensor, key_mask: Tensor) -> Tensor:
        qk = (src + pos).to(self.dtype)
        src = self.norm1(src + self.self_attn(qk, qk, src.to(self.dtype), mask=key_mask))
        return self.norm2(src + self.ffn(src))


class DecoderLayer(nn.Module):
    """Post-norm decoder layer (flax's ``_DecoderLayer``): the queries'
    self-attention, their masked cross-attention onto the memory, then the
    FFN, each added to its input and normed in float32."""

    def __init__(self, d_model: int, nhead: int, dim_feedforward: int, dtype: torch.dtype,
                 param_dtype: torch.dtype, device=None):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=param_dtype, device=device)
        self.self_attn = MultiHeadDotProductAttention(d_model, nhead, **kw)
        self.norm1 = LayerNorm(d_model, device=device)
        self.cross_attn = MultiHeadDotProductAttention(d_model, nhead, **kw)
        self.norm2 = LayerNorm(d_model, device=device)
        self.ffn = FFN(d_model, dim_feedforward, dtype, param_dtype, device)
        self.norm3 = LayerNorm(d_model, device=device)

    def forward(self, tgt: Tensor, query_pos: Tensor, memory: Tensor, pos: Tensor,
                key_mask: Tensor) -> Tensor:
        dt = self.dtype
        q = (tgt + query_pos).to(dt)
        tgt = self.norm1(tgt + self.self_attn(q, q, tgt.to(dt)))
        ca = self.cross_attn((tgt + query_pos).to(dt), (memory + pos).to(dt), memory.to(dt),
                             mask=key_mask)
        tgt = self.norm2(tgt + ca)
        return self.norm3(tgt + self.ffn(tgt))


@DETECTORS.register_module
class DETR(nn.Module):
    """backbone C5 -> ``input_proj`` -> encoder -> decoder -> class and box
    heads, named as flax names them (``backbone``, ``input_proj``,
    ``query_embed``, ``encoder{i}``, ``decoder{i}``, ``decoder_norm``,
    ``class_embed``, ``bbox_fc1``, ``bbox_fc2``, ``bbox_out``). ``dtype``
    is the compute dtype; ``param_dtype`` (default ``dtype``) the
    parameters', as ``RoIDetector``'s: where they differ the forward runs
    under ``torch.autocast``. ``device`` defaults to ``cuda``."""

    def __init__(self, backbone: Dict[str, Any], num_classes: int = 80, d_model: int = 256,
                 nhead: int = 8, num_encoder_layers: int = 6, num_decoder_layers: int = 6,
                 dim_feedforward: int = 2048, num_queries: int = 100,
                 dtype: Optional[torch.dtype] = None, param_dtype: Optional[torch.dtype] = None,
                 device=None):
        super().__init__()
        self.dtype = dtype or torch.float32
        self.param_dtype = param_dtype or self.dtype
        self._device = resolve_device(device)
        self.d_model, self.num_queries = d_model, num_queries
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        kw = dict(dtype=self.param_dtype, device=self._device)
        self.backbone = BACKBONES.build(dict(backbone), **kw)
        self.input_proj = nn.Linear(self.backbone.out_channels[-1], d_model, **kw)
        # float32 in every build, as the reference's parameter used at the memory's dtype
        self.query_embed = nn.Parameter(
            torch.zeros((num_queries, d_model), dtype=torch.float32, device=self._device))
        layer = (d_model, nhead, dim_feedforward, self.dtype, self.param_dtype, self._device)
        for i in range(num_encoder_layers):
            setattr(self, f"encoder{i}", EncoderLayer(*layer))
        for i in range(num_decoder_layers):
            setattr(self, f"decoder{i}", DecoderLayer(*layer))
        self.decoder_norm = LayerNorm(d_model, device=self._device)
        self.class_embed = Float32Linear(d_model, num_classes + 1, device=self._device)
        self.bbox_fc1 = nn.Linear(d_model, d_model, **kw)
        self.bbox_fc2 = nn.Linear(d_model, d_model, **kw)
        self.bbox_out = Float32Linear(d_model, 4, device=self._device)

    def init_own(self, generator: torch.Generator) -> None:
        """The reference's initialiser of the queries, normal(1.0)."""
        normal_(self.query_embed, 1.0, generator)

    def _autocast(self, x: Tensor):
        return compute_autocast(x, self.dtype, self.param_dtype)

    def features(self, images: Tensor) -> Tensor:
        """(B, H, W, 3) -> C5 (B, fh, fw, C) NHWC in the compute dtype."""
        x = images.to(self.dtype).contiguous()
        with self._autocast(x):
            return self.backbone(x)[-1]

    def embed(self, c5: Tensor, canvas_hw: Tuple[int, int], img_shapes: Optional[Tensor]
              ) -> Tuple[Tensor, Tensor, Tensor]:
        """The encoder's inputs: ``src`` (B, L, d) projected from C5 in the
        compute dtype, ``pos`` (B, L, d) the sine encoding in ``src``'s dtype,
        and the (B, 1, 1, L) key mask, True on the cells inside the image."""
        b, fh, fw, _ = c5.shape
        valid = valid_cells(img_shapes, b, canvas_hw, (fh, fw), c5.device)
        with self._autocast(c5):
            src = self.input_proj(c5).reshape(b, fh * fw, self.d_model)
        pos = sine_position_encoding(valid, self.d_model).reshape(b, fh * fw, self.d_model)
        return src, pos.to(src.dtype), valid.reshape(b, 1, 1, fh * fw) > 0.5

    def encoder_layer(self, i: int, src: Tensor, pos: Tensor, key_mask: Tensor) -> Tensor:
        with self._autocast(src):
            return self.get_submodule(f"encoder{i}")(src, pos, key_mask)

    def queries(self, memory: Tensor) -> Tuple[Tensor, Tensor]:
        """The queries' positions (B, Q, d) in the memory's dtype, and the
        decoder's first input, zeros like them."""
        qpos = self.query_embed[None].expand(memory.shape[0], -1, -1).to(memory.dtype)
        return torch.zeros_like(qpos), qpos

    def decoder_layer(self, i: int, tgt: Tensor, qpos: Tensor, memory: Tensor, pos: Tensor,
                      key_mask: Tensor) -> Tensor:
        with self._autocast(tgt):
            return self.get_submodule(f"decoder{i}")(tgt, qpos, memory, pos, key_mask)

    def heads(self, hs: Tensor) -> Tuple[Tensor, Tensor]:
        """The normed decoder outputs (L, B, Q, d) -> float32 class logits
        (L, B, Q, C + 1) and sigmoid boxes (L, B, Q, 4), normalised cxcywh."""
        with self._autocast(hs):
            cls_logits = self.class_embed(hs)
            h = F.relu(self.bbox_fc1(hs.to(self.dtype)))
            h = F.relu(self.bbox_fc2(h))
            return cls_logits, torch.sigmoid(self.bbox_out(h))

    def predict(self, c5: Tensor, canvas_hw: Tuple[int, int], img_shapes: Optional[Tensor]
                ) -> Tuple[Tensor, Tensor]:
        """Everything after the backbone: C5 of a ``canvas_hw`` canvas ->
        the encoder, every decoder layer normed, and the heads."""
        src, pos, key_mask = self.embed(c5, canvas_hw, img_shapes)
        memory = src
        for i in range(self.num_encoder_layers):
            memory = self.encoder_layer(i, memory, pos, key_mask)
        tgt, qpos = self.queries(memory)
        outs = []
        for i in range(self.num_decoder_layers):
            tgt = self.decoder_layer(i, tgt, qpos, memory, pos, key_mask)
            outs.append(self.decoder_norm(tgt))
        return self.heads(torch.stack(outs))

    def forward(self, images: Tensor, img_shapes: Optional[Tensor] = None
                ) -> Tuple[Tensor, Tensor]:
        """(B, H, W, 3) and (B, 2) un-padded (h, w) -> (L, B, Q, C + 1)
        float32 logits and (L, B, Q, 4) float32 boxes, normalised cxcywh
        relative to each image. Every cell is valid where ``img_shapes`` is
        None."""
        return self.predict(self.features(images), tuple(images.shape[1:3]), img_shapes)


@dataclasses.dataclass(frozen=True)
class DETRConfig:
    """The reference's ``DETRConfig``, with its defaults."""

    num_classes: int = 80
    num_queries: int = 100
    # matching-cost and loss weights (paper defaults)
    cls_weight: float = 1.0
    bbox_weight: float = 5.0
    giou_weight: float = 2.0
    eos_coef: float = 0.1  # the no-object class's weight in the CE
    aux_loss: bool = True
    # inference
    score_thr: float = 0.0
    max_detections: int = 100


def gt_to_cxcywh(gt_boxes: Tensor, gt_valid: Tensor, img_shapes: Tensor) -> Tensor:
    """Inclusive xyxy (B, G, 4) -> (cx, cy, w, h) normalised by each
    image's (h, w), with continuous edges (x2 + 1); 0.5 where invalid."""
    x1, y1, x2, y2 = gt_boxes.float().unbind(-1)
    x2, y2 = x2 + 1.0, y2 + 1.0
    hw = img_shapes.float()
    h, w = hw[:, 0, None], hw[:, 1, None]
    out = torch.stack([(x1 + x2) / (2 * w), (y1 + y2) / (2 * h), (x2 - x1) / w, (y2 - y1) / h],
                      dim=-1)
    return torch.where(gt_valid.bool()[..., None], out, 0.5)


def loss_layers(cfg: DETRConfig, cls_logits: Tensor, pred_boxes: Tensor) -> Tuple[Tensor, Tensor]:
    """The decoder layers the loss reads: all of them with ``aux_loss``,
    else the last."""
    n = cls_logits.shape[0] if cfg.aux_loss else 1
    return cls_logits[-n:], pred_boxes[-n:]


def matching_cost(cfg: DETRConfig, cls_logits: Tensor, pred_boxes: Tensor, gt_cxcywh: Tensor,
                  gt_labels: Tensor) -> Tensor:
    """(L, B, G, Q) cost of matching each gt to each query of each decoder
    layer, on detached predictions: ``cls_weight`` x minus the softmax
    probability of the gt's class, plus ``bbox_weight`` x the L1 distance of
    the normalised cxcywh boxes, plus ``giou_weight`` x -GIoU of the pair
    (the paper's eq. 2)."""
    with torch.no_grad():
        layers, _, q, c1 = cls_logits.shape
        probs = torch.softmax(cls_logits.float(), dim=-1)
        label0 = (gt_labels.long() - 1).clamp(0, c1 - 2)  # (B, G)
        index = label0[None, :, None, :].expand(layers, -1, q, -1)
        cost_cls = -torch.gather(probs, -1, index).transpose(-1, -2)
        pb = pred_boxes.float()
        cost_l1 = (gt_cxcywh[None, :, :, None, :] - pb[:, :, None, :, :]).abs().sum(-1)
        cost_giou = iou_loss_elementwise(cxcywh_to_xyxy(pb)[:, :, None],
                                         cxcywh_to_xyxy(gt_cxcywh)[None, :, :, None], "giou",
                                         offset=0.0) - 1.0
        return cfg.cls_weight * cost_cls + cfg.bbox_weight * cost_l1 + cfg.giou_weight * cost_giou


def set_losses(cfg: DETRConfig, cls_logits: Tensor, pred_boxes: Tensor, gt_cxcywh: Tensor,
               gt_labels: Tensor, gt_valid: Tensor, col4row: Tensor) -> Dict[str, Tensor]:
    """Every decoder layer's set losses given the matching ``col4row``
    (L, B, G): the cross entropy over the Q queries, each matched query
    carrying its gt's class and the others no-object (weighted
    ``eos_coef``), normalised by the sum of the weights of its layer and
    image; L1 on the matched normalised cxcywh boxes; GIoU on them as xyxy.
    L1 and GIoU are normalised by ``num_boxes = max(sum valid, 1) / B``
    (GIoU by ``max(num_boxes, 1)``, the reference's ``avg_factor``). Summed
    over layers, averaged over images, weighted."""
    layers, b, q, c1 = cls_logits.shape
    no_obj = c1 - 1
    valid = gt_valid.bool()
    num_boxes = batch_normaliser(valid.float().sum()) / b
    label0 = (gt_labels.long() - 1).clamp(0, c1 - 2)
    cols = torch.where(valid[None], col4row.long(), q)  # unmatched rows write slot q
    target = torch.full((layers, b, q + 1), no_obj, dtype=torch.long, device=cls_logits.device)
    target.scatter_(-1, cols, torch.where(valid, label0, no_obj)[None].expand(layers, -1, -1))
    target = target[..., :q]
    logp = torch.log_softmax(cls_logits.float(), dim=-1)
    w_cls = torch.where(target == no_obj, cfg.eos_coef, 1.0)
    nll = -torch.gather(logp, -1, target[..., None])[..., 0]
    loss_cls = (w_cls * nll).sum(-1) / torch.clamp(w_cls.sum(-1), min=1e-6)  # (L, B)
    index = col4row.long().clamp(0, q - 1)
    matched = torch.gather(pred_boxes, 2, index[..., None].expand(-1, -1, -1, 4))  # (L, B, G, 4)
    w = valid.float()
    loss_l1 = (w[None, ..., None] * (matched - gt_cxcywh[None]).abs()).sum((-1, -2)) / num_boxes
    loss_giou = iou_loss(cxcywh_to_xyxy(matched), cxcywh_to_xyxy(gt_cxcywh)[None],
                         w[None], "giou", offset=0.0, avg_factor=num_boxes) / b
    loss_cls = loss_cls.sum(0).mean() * cfg.cls_weight
    loss_l1 = loss_l1.sum(0).mean() * cfg.bbox_weight
    loss_giou = loss_giou * cfg.giou_weight
    return {"loss_cls": loss_cls, "loss_l1": loss_l1, "loss_giou": loss_giou,
            "loss": loss_cls + loss_l1 + loss_giou, "num_pos": w.sum(-1).mean()}


def detr_loss(
    cfg: DETRConfig,
    cls_logits: Tensor,  # (L, B, Q, C + 1)
    pred_boxes: Tensor,  # (L, B, Q, 4) normalised cxcywh
    gt_boxes: Tensor,  # (B, G, 4) inclusive xyxy
    gt_labels: Tensor,  # (B, G) 1-based
    gt_valid: Tensor,  # (B, G)
    img_shapes: Tensor,  # (B, 2) un-padded (h, w)
) -> Dict[str, Tensor]:
    """Hungarian-matched set losses on every decoder layer (``aux_loss``) or
    the last: ``matching_cost``, ``match``, ``set_losses``. No host sync: on
    the card the matching is one kernel launch whose result stays there."""
    cls_logits, pred_boxes = loss_layers(cfg, cls_logits, pred_boxes)
    gt = gt_to_cxcywh(gt_boxes, gt_valid, img_shapes)
    col4row = match(matching_cost(cfg, cls_logits, pred_boxes, gt, gt_labels), gt_valid)
    return set_losses(cfg, cls_logits, pred_boxes, gt, gt_labels, gt_valid, col4row)


def detr_train_loss(cfg: DETRConfig, model: DETR, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """The forward on the batch's images and ``detr_loss``, both given the
    batch's ``img_shape`` (the canvas where it has none), as the
    reference's loss function."""
    shapes = batch.get("img_shape")
    shapes = canvas_shapes(batch["image"]) if shapes is None else shapes.float()
    cls_logits, pred_boxes = model(batch["image"], shapes)
    return detr_loss(cfg, cls_logits, pred_boxes, batch["gt_boxes"], batch["gt_labels"],
                     batch["gt_valid"], shapes)


def decode_detr(
    cfg: DETRConfig,
    cls_logits: Tensor,  # (L, B, Q, C + 1)
    pred_boxes: Tensor,  # (L, B, Q, 4) normalised cxcywh
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """``top_k_detections`` of the last decoder layer's softmax
    probabilities, no-object left out, and its boxes scaled by each image's
    (w, h) (by 1 where ``img_shapes`` is None)."""
    c = cls_logits.shape[-1] - 1
    probs = torch.softmax(cls_logits[-1].float(), dim=-1)[..., :c]
    boxes = cxcywh_to_xyxy(pred_boxes[-1].float())
    if img_shapes is not None:
        hw = img_shapes.float()
        boxes = boxes * torch.stack([hw[:, 1], hw[:, 0], hw[:, 1], hw[:, 0]], dim=-1)[:, None]
    return top_k_detections(probs, boxes, img_shapes, scale_factors, cfg.max_detections,
                            cfg.score_thr)


def detr_inference(
    cfg: DETRConfig,
    model: DETR,
    images: Tensor,  # (B, H, W, 3)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
    scale_factors: Optional[Tensor] = None,  # (B,) or (B, 4)
) -> NMSResult:
    """The forward with ``img_shapes``' key mask, then ``decode_detr``."""
    cls_logits, pred_boxes = model(images, img_shapes)
    return decode_detr(cfg, cls_logits, pred_boxes, img_shapes, scale_factors)
