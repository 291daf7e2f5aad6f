"""FCN mask head (Mask R-CNN), its fixed-shape mask targets and loss, and
the paste of roi masks onto the image, on the device (``paste_masks``) and
on the host at any size (``paste_masks_np``, the evaluator's).

Counterpart of ``torch_detection_tpu/models/heads/mask_head.py``. RoI
features arrive as (B, R, S, S, C), NHWC as the box head takes them; the
convolutions run on an NCHW view in channels_last memory. Submodules are
named as the reference's flax modules: ``conv0..conv{n-1}``, ``upsample``
(a flax ``ConvTranspose``, converted with its kernel flipped, see
``models/convert.py``) and ``logits``.

The mask targets are the reference's, batched over images and rois: the
matched gt mask is cropped from a 6-level mean pyramid of the (B, G, H, W)
uint8 masks and resampled at each roi with two products of bilinear weights,
with the reference's bf16 roundings (see ``mask_target_means``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...ops.losses import binary_cross_entropy
from ...ops.roi_align import window_geometry
from ...parallel.distributed import batch_normaliser
from ...utils.registry import HEADS


@HEADS.register_module
class FCNMaskHead(nn.Module):
    """4x conv3x3 -> 2x transposed-conv upsample -> 1x1 per-class logits.

    Input (B, R, S, S, C) roi features; output (B, R, 2S, 2S, num_classes)."""

    def __init__(self, num_classes: int, in_channels: int = 256, conv_channels: int = 256,
                 num_convs: int = 4, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_convs = num_convs
        for i in range(num_convs):
            cin = in_channels if i == 0 else conv_channels
            setattr(self, f"conv{i}", nn.Conv2d(cin, conv_channels, 3, padding=1, **kw))
        self.upsample = nn.ConvTranspose2d(conv_channels, conv_channels, 2, stride=2, **kw)
        self.logits = nn.Conv2d(conv_channels, num_classes, 1, **kw)

    def forward(self, roi_feats: Tensor) -> Tensor:
        b, r, s, _, c = roi_feats.shape
        x = roi_feats.reshape(b * r, s, s, c).permute(0, 3, 1, 2)
        for i in range(self.num_convs):
            x = F.relu(getattr(self, f"conv{i}")(x))
        x = self.logits(F.relu(self.upsample(x)))
        return x.permute(0, 2, 3, 1).reshape(b, r, 2 * s, 2 * s, -1)


_MASK_LEVELS = 6
_MASK_RATIO = 2


def _mean_pyramid(gt_masks: Tensor):
    """Levels 1..5 of the masks' 2x2 mean pyramid, (B, G, H_l, W_l) bf16,
    each level padded to even sizes with zeros before it is halved. Level 1
    sums the uint8 masks exactly and scales by 0.25; the others add in bf16,
    rows then columns, then scale, as the reference does."""
    def halve(f: Tensor) -> Tensor:
        f = F.pad(f, (0, (-f.shape[-1]) % 2, 0, (-f.shape[-2]) % 2))
        f = f[..., 0::2, :] + f[..., 1::2, :]
        return f[..., 0::2] + f[..., 1::2]

    levels = [halve(gt_masks).to(torch.bfloat16) * 0.25]
    for _ in range(_MASK_LEVELS - 2):
        levels.append(halve(levels[-1]) * 0.25)
    return levels


def _windows(raw: Tensor, flat: Tensor, rows0: int, starts: Tensor, gt: Tensor,
             crop: int) -> Tensor:
    """Each roi's (crop, crop) window of its matched gt channel, bf16:
    from the raw uint8 masks where the roi routes to level 0 (its row start
    lies in level 0's ``rows0`` rows), else from the stacked levels 1..5.
    The other tensor's window is taken at a start clamped into it and
    dropped, as the reference's ``dynamic_slice`` pair does."""
    b, r = gt.shape
    img = torch.arange(b, device=gt.device)[:, None, None, None]
    chan = gt[..., None, None]
    span = torch.arange(crop, device=gt.device)
    r0, c0 = starts[..., 0], starts[..., 1]

    def take(src: Tensor, row: Tensor) -> Tensor:
        row = row.clamp(0, src.shape[-2] - crop)[..., None, None] + span[:, None]
        col = c0.clamp(0, src.shape[-1] - crop)[..., None, None] + span
        return src[img, chan, row, col]

    is_l0 = (r0 < rows0)[..., None, None]
    return torch.where(is_l0, take(raw, r0).to(torch.bfloat16), take(flat, r0 - rows0))


def mask_target_means(
    gt_masks: Tensor,  # (B, G, H, W) uint8
    rois: Tensor,  # (B, R, 4) image coordinates, float32
    matched_gt: Tensor,  # (B, R) index into G
    mask_size: int = 28,
) -> Tensor:
    """The value each target pixel is thresholded at: (B, R, M, M) float32.

    The reference's formulation, batched: rois route to the pyramid level
    where they span ``mask_size`` to ``2 * mask_size`` cells
    (``finest_scale = mask_size``), read a (4M, 4M) window of their matched
    gt channel there, and are sampled on a (2M, 2M) grid by ``wy @ window @
    wx^T``, then averaged 2x2. Both products take bf16 operands (the weights
    rounded to bf16, the intermediate rounded to bf16) and accumulate in
    float32; a row of weights has at most two nonzeros, so each sum is two
    exact products and one rounding, the same bits in any summation order and
    on any device. ``matched_gt`` is clamped into G, as the reference's
    ``dynamic_slice`` clamps it. Autocast is off here: it would recast the
    products."""
    b, g, h, w = gt_masks.shape
    crop = 4 * mask_size
    with torch.autocast(gt_masks.device.type, enabled=False):
        levels = _mean_pyramid(gt_masks)
        shapes = [(h, w)] + [tuple(f.shape[-2:]) for f in levels]
        h_pads, w_max, starts, wy, wx = window_geometry(
            shapes, rois, [2 ** i for i in range(_MASK_LEVELS)], mask_size, _MASK_RATIO,
            float(max(mask_size, 2)), crop,
        )
        flat = torch.cat([F.pad(f, (0, w_max - f.shape[-1], 0, hp - f.shape[-2]))
                          for f, hp in zip(levels, h_pads[1:])], dim=-2)
        raw = F.pad(gt_masks, (0, max(crop - w, 0), 0, max(crop - h, 0)))
        window = _windows(raw, flat, h_pads[0], starts, matched_gt.long().clamp(0, g - 1), crop)
        tmp = torch.matmul(wy.to(torch.bfloat16).float(), window.float())
        samples = torch.matmul(tmp.to(torch.bfloat16).float(),
                               wx.to(torch.bfloat16).float().transpose(-1, -2))
        s = samples.reshape(b, -1, mask_size, _MASK_RATIO, mask_size, _MASK_RATIO)
        total = s[..., 0, :, 0] + s[..., 0, :, 1] + s[..., 1, :, 0] + s[..., 1, :, 1]
        return total / 4.0


def mask_targets_for_rois(
    gt_masks: Tensor,  # (B, G, H, W) uint8
    rois: Tensor,  # (B, R, 4)
    matched_gt: Tensor,  # (B, R)
    mask_size: int = 28,
) -> Tensor:
    """Each roi's matched gt mask cropped and resized to (B, R, M, M)
    binary float32 targets: ``mask_target_means >= 0.5``."""
    return (mask_target_means(gt_masks, rois, matched_gt, mask_size) >= 0.5).float()


def select_class(mask_logits: Tensor, classes: Tensor) -> Tensor:
    """(B, R, M, M, C) logits at each roi's 0-based class (B, R), clamped
    into [0, C - 1] -> (B, R, M, M)."""
    cls = classes.long().clamp(0, mask_logits.shape[-1] - 1)
    index = cls[..., None, None, None].expand(*mask_logits.shape[:-1], 1)
    return torch.gather(mask_logits, -1, index)[..., 0]


def mask_loss(
    mask_logits: Tensor,  # (B, R, M, M, C)
    mask_targets: Tensor,  # (B, R, M, M) binary
    roi_labels: Tensor,  # (B, R) 1-based class, 0 = background
    roi_pos: Tensor,  # (B, R) bool
) -> Tensor:
    """BCE on the matched class's mask channel, averaged over the positive
    rois' pixels of the whole batch."""
    logits = select_class(mask_logits, roi_labels.long() - 1).float()
    m = mask_targets.shape[-1] * mask_targets.shape[-2]
    n = batch_normaliser(roi_pos.float().sum()) * m
    return binary_cross_entropy(logits, mask_targets, weight=roi_pos.float()[..., None, None],
                                avg_factor=n)


def paste_masks(
    mask_probs: Tensor,  # (R, M, M) probabilities for the detected class
    boxes: Tensor,  # (R, 4) xyxy in image coordinates
    img_shape: Tuple[int, int],
    threshold: float = 0.5,
) -> Tensor:
    """Roi masks pasted onto the (H, W) image -> (R, H, W) bool: each pixel
    samples its roi's mask bilinearly at the pixel's place in the box, and
    pixels outside the box (inclusive edges) are False."""
    h, w = img_shape
    m = mask_probs.shape[-1]
    ys = torch.arange(h, dtype=torch.float32, device=boxes.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=boxes.device)[None, None, :]
    x1, y1, x2, y2 = (boxes[:, i][:, None, None] for i in range(4))
    my = (ys - y1) / torch.clamp(y2 - y1, min=1.0) * m - 0.5
    mx = (xs - x1) / torch.clamp(x2 - x1, min=1.0) * m - 0.5
    y0, x0 = torch.floor(my), torch.floor(mx)
    wy, wx = my - y0, mx - x0
    y0i, x0i = y0.long().clamp(0, m - 1), x0.long().clamp(0, m - 1)
    y1i, x1i = (y0i + 1).clamp(0, m - 1), (x0i + 1).clamp(0, m - 1)
    r = torch.arange(mask_probs.shape[0], device=boxes.device)[:, None, None]
    vals = (
        mask_probs[r, y0i, x0i] * (1 - wy) * (1 - wx)
        + mask_probs[r, y0i, x1i] * (1 - wy) * wx
        + mask_probs[r, y1i, x0i] * wy * (1 - wx)
        + mask_probs[r, y1i, x1i] * wy * wx
    )
    inside = (ys >= y1) & (ys <= y2) & (xs >= x1) & (xs <= x2)
    return (vals >= threshold) & inside


def paste_masks_np(
    mask_probs: np.ndarray,  # (R, M, M) probabilities
    boxes: np.ndarray,  # (R, 4) xyxy in image coordinates
    img_shape: Tuple[int, int],
    threshold: float = 0.5,
) -> np.ndarray:
    """``paste_masks`` on the host, in numpy float32 -> (R, H, W) bool: the
    same sampling, computed over each box's pixel window only, so that any
    original image size costs only its boxes' pixels. The evaluator calls it
    once an image at the original size."""
    h, w = int(img_shape[0]), int(img_shape[1])
    probs = np.asarray(mask_probs, np.float32)
    boxes = np.asarray(boxes, np.float32)
    r = probs.shape[0]
    m = probs.shape[-1] if r else 1
    out = np.zeros((r, h, w), bool)
    for i in range(r):
        x1, y1, x2, y2 = boxes[i]
        bw, bh = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
        xa, xb = max(int(np.floor(x1)), 0), min(int(np.ceil(x2)), w - 1)
        ya, yb = max(int(np.floor(y1)), 0), min(int(np.ceil(y2)), h - 1)
        if xb < xa or yb < ya:
            continue
        ys = np.arange(ya, yb + 1, dtype=np.float32)[:, None]
        xs = np.arange(xa, xb + 1, dtype=np.float32)[None, :]
        my = (ys - y1) / bh * m - 0.5
        mx = (xs - x1) / bw * m - 0.5
        y0, x0 = np.floor(my), np.floor(mx)
        wy, wx = my - y0, mx - x0
        y0i, x0i = np.clip(y0.astype(np.int32), 0, m - 1), np.clip(x0.astype(np.int32), 0, m - 1)
        y1i, x1i = np.clip(y0i + 1, 0, m - 1), np.clip(x0i + 1, 0, m - 1)
        p = probs[i]
        vals = (p[y0i, x0i] * (1 - wy) * (1 - wx) + p[y0i, x1i] * (1 - wy) * wx
                + p[y1i, x0i] * wy * (1 - wx) + p[y1i, x1i] * wy * wx)
        inside = (ys >= y1) & (ys <= y2) & (xs >= x1) & (xs <= x2)
        out[i, ya: yb + 1, xa: xb + 1] = (vals >= threshold) & inside
    return out
