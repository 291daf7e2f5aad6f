"""Region Proposal Network head and fixed-shape proposal generation.

Counterpart of ``torch_detection_tpu/models/heads/rpn_head.py``: a shared
3x3 conv, then 1x1 objectness (A) and deltas (A*4) per level; proposals by
per-level top-k, decode, clip and one class-agnostic NMS for the batch,
padded to ``post_nms_top_k`` with a validity mask.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...ops.boxes import clip_boxes, delta2bbox
from ...ops.nms import nms, top_k_stable
from ...utils.registry import HEADS


@HEADS.register_module
class RPNHead(nn.Module):
    """3x3 conv -> 1x1 objectness (A) + 1x1 deltas (A*4), shared across levels."""

    def __init__(self, in_channels: int = 256, feat_channels: int = 256,
                 num_base_anchors: int = 3, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.rpn_conv = nn.Conv2d(in_channels, feat_channels, 3, padding=1, **kw)
        self.rpn_cls = nn.Conv2d(feat_channels, num_base_anchors, 1, **kw)
        self.rpn_reg = nn.Conv2d(feat_channels, num_base_anchors * 4, 1, **kw)

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tuple[Tensor, ...], Tuple[Tensor, ...]]:
        """NHWC levels -> per level (B, H, W, A) scores and (B, H, W, A*4) deltas."""
        scores, deltas = [], []
        for f in feats:
            h = F.relu(self.rpn_conv(f.permute(0, 3, 1, 2)))
            scores.append(self.rpn_cls(h).permute(0, 2, 3, 1))
            deltas.append(self.rpn_reg(h).permute(0, 2, 3, 1))
        return tuple(scores), tuple(deltas)


class Proposals(NamedTuple):
    boxes: Tensor  # (B, P, 4)
    scores: Tensor  # (B, P)
    valid: Tensor  # (B, P) bool


@dataclasses.dataclass(frozen=True)
class ProposalConfig:
    pre_nms_per_level: int = 1000
    post_nms_top_k: int = 1000
    nms_iou_thr: float = 0.7
    target_means: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    target_stds: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)


def generate_proposals(
    cfg: ProposalConfig,
    anchor_generator,
    rpn_scores: Sequence[Tensor],  # per level (B, H, W, A)
    rpn_deltas: Sequence[Tensor],  # per level (B, H, W, A*4)
    img_shapes: Optional[Tensor] = None,  # (B, 2) (h, w)
) -> Proposals:
    """Decode + per-level top-k + class-agnostic NMS -> fixed (B, P) slate."""
    featmap_sizes = [tuple(s.shape[1:3]) for s in rpn_scores]
    level_anchors = anchor_generator.grid_anchors(featmap_sizes, rpn_scores[0].device)
    b = rpn_scores[0].shape[0]

    cand_scores, cand_boxes = [], []
    for anchors, s_l, d_l in zip(level_anchors, rpn_scores, rpn_deltas):
        s = s_l.reshape(b, -1).float()  # (B, N_l)
        d = d_l.reshape(b, -1, 4).float()
        top_s, idx = top_k_stable(s, min(cfg.pre_nms_per_level, s.shape[1]))
        top_d = torch.gather(d, 1, idx[..., None].expand(-1, -1, 4))
        boxes = delta2bbox(anchors[idx], top_d, cfg.target_means, cfg.target_stds)
        cand_scores.append(top_s)
        cand_boxes.append(boxes)

    scores = torch.sigmoid(torch.cat(cand_scores, dim=1))  # (B, M)
    boxes = torch.cat(cand_boxes, dim=1)  # (B, M, 4)
    if img_shapes is not None:
        boxes = clip_boxes(boxes, img_shapes)
    # the cross-level NMS draws from the best 2 * post_nms_top_k candidates
    res = nms(boxes, scores, iou_thr=cfg.nms_iou_thr, max_out=cfg.post_nms_top_k,
              pre_top_k=2 * cfg.post_nms_top_k)
    return Proposals(res.boxes, res.scores, res.valid)
