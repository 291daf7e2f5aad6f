"""Detections of a test image's augmentations, fused in its original frame.

Counterpart of the box part of ``torch_detection_tpu/engine/tta.py``: each
augmentation's boxes are unflipped in their resized frame and unscaled
(``debox_to_original``), then all of them pass one class-wise NMS
(``merge_tta_detections``). ``evaluate_detector`` fuses a single
augmentation the same way, as the reference does. The NMS selects and does
not average, so each kept detection has exactly one source row:
``merge_tta_detections(extras=...)`` carries arrays aligned row for row with
each augmentation's boxes (the mask probabilities, unflipped) to the kept
detections, which is how segm evaluation keeps mask provenance through the
fusion. ``masks_to_original`` pastes one augmentation's mask probabilities
in the original frame.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.ops.bbox import bbox_flip
from ..models.heads.mask_head import paste_masks_np
from ..ops.nms import multiclass_nms


def debox_to_original(boxes: np.ndarray, meta: Dict) -> np.ndarray:
    """Boxes in an augmented frame -> the original image's frame: unflip in
    the resized frame, then unscale."""
    if meta.get("flipped_flag"):
        boxes = bbox_flip(
            boxes, tuple(meta["img_shape"][:2]), True, meta.get("flipped_direction", "horizontal")
        )
    return boxes / float(meta["scale_factor"])


def merge_tta_detections(
    per_aug: Sequence[Dict[str, np.ndarray]],
    metas: Sequence[Dict],
    iou_thr: float = 0.5,
    max_out: int = 100,
    extras: Optional[Sequence[np.ndarray]] = None,
) -> Dict[str, np.ndarray]:
    """Fuse the detections of several augmentations of ONE image.

    per_aug[i]: {'boxes', 'scores', 'labels' (0-based)} in the i-th
    augmented frame; returns them fused in original-image coordinates.
    ``extras[i]``, aligned row for row with ``per_aug[i]``'s boxes, comes
    back as ``extras``: the source row of each kept detection, through the
    NMS's ``indices``."""
    all_boxes, all_scores, all_labels, all_extras = [], [], [], []
    for a, (det, meta) in enumerate(zip(per_aug, metas)):
        if len(det["boxes"]) == 0:
            continue
        all_boxes.append(debox_to_original(np.asarray(det["boxes"]), meta))
        all_scores.append(np.asarray(det["scores"]))
        all_labels.append(np.asarray(det["labels"]))
        if extras is not None:
            all_extras.append(np.asarray(extras[a]))
    if not all_boxes:
        out = dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros((0,), np.float32),
                   labels=np.zeros((0,), np.int64))
        if extras is not None:
            shape = np.asarray(extras[0]).shape[1:] if len(extras) else ()
            out["extras"] = np.zeros((0, *shape), np.float32)
        return out
    boxes = np.concatenate(all_boxes).astype(np.float32)
    scores = np.concatenate(all_scores).astype(np.float32)
    labels = np.concatenate(all_labels).astype(np.int64)

    score_matrix = np.zeros((len(boxes), int(labels.max()) + 1), np.float32)
    score_matrix[np.arange(len(boxes)), labels] = scores
    res = multiclass_nms(
        torch.from_numpy(boxes),
        torch.from_numpy(score_matrix),
        iou_thr=iou_thr,
        score_thr=0.0,
        pre_nms_top_k=min(len(boxes), 1000),
        max_out=max_out,
    )
    valid = res.valid.numpy()
    out = dict(boxes=res.boxes.numpy()[valid], scores=res.scores.numpy()[valid],
               labels=res.labels.numpy()[valid])
    if extras is not None:
        out["extras"] = np.concatenate(all_extras)[res.indices.numpy()[valid]]
    return out


def masks_to_original(mask_probs: np.ndarray, boxes: np.ndarray, meta: Dict, threshold: float = 0.5):
    """One augmentation's (D, M, M) mask probabilities and (D, 4) boxes ->
    ``(masks (D, oh, ow) bool, boxes (D, 4))`` in the original frame. A
    flipped input mirrored its content, so each patch is mirrored back
    before it is pasted at the unflipped box."""
    boxes = debox_to_original(np.asarray(boxes), meta)
    oh, ow = meta["ori_shape"][:2]
    return paste_masks_np(unflip_masks(mask_probs, meta), boxes, (oh, ow),
                          threshold=threshold), boxes


def unflip_masks(mask_probs: np.ndarray, meta: Dict) -> np.ndarray:
    """(D, M, M) mask probabilities of a flipped augmentation mirrored back
    into the original orientation: horizontal on the last axis, vertical on
    the middle one; float32, unchanged where the augmentation is not
    flipped."""
    probs = np.asarray(mask_probs, np.float32)
    if meta.get("flipped_flag"):
        if meta.get("flipped_direction", "horizontal") == "horizontal":
            return probs[:, :, ::-1]
        return probs[:, ::-1, :]
    return probs
