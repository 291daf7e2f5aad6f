"""Detections of a test image's augmentations, fused in its original frame.

Counterpart of the box part of ``torch_detection_tpu/engine/tta.py``: each
augmentation's boxes are unflipped in their resized frame and unscaled
(``debox_to_original``), then all of them pass one class-wise NMS
(``merge_tta_detections``). ``evaluate_detector`` fuses a single
augmentation the same way, as the reference does. The mask part
(``masks_to_original``, mask provenance through the fusion) waits for the
mask tier of the port.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..data.ops.bbox import bbox_flip
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
) -> Dict[str, np.ndarray]:
    """Fuse the detections of several augmentations of ONE image.

    per_aug[i]: {'boxes', 'scores', 'labels' (0-based)} in the i-th
    augmented frame; returns them fused in original-image coordinates."""
    all_boxes, all_scores, all_labels = [], [], []
    for det, meta in zip(per_aug, metas):
        if len(det["boxes"]) == 0:
            continue
        all_boxes.append(debox_to_original(np.asarray(det["boxes"]), meta))
        all_scores.append(np.asarray(det["scores"]))
        all_labels.append(np.asarray(det["labels"]))
    if not all_boxes:
        return dict(boxes=np.zeros((0, 4), np.float32), scores=np.zeros((0,), np.float32),
                    labels=np.zeros((0,), np.int64))
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
    return dict(boxes=res.boxes.numpy()[valid], scores=res.scores.numpy()[valid],
                labels=res.labels.numpy()[valid])
