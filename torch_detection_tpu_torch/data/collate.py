"""Batch collation into fixed-shape numpy arrays.

Counterpart of ``torch_detection_tpu/data/collate.py``: images padded to a
canvas (an explicit (H, W), the smallest fitting bucket, or the batch's
max rounded up to ``size_divisor``), ragged gt boxes and labels padded to
``max_gts`` rows with a validity mask, crowd boxes likewise, proposals to a
fixed slate, and the ``stem_s2d`` wire. The batch stays numpy;
``data/device.py`` puts it on the device. Gt masks wait for the mask tier.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.preprocess import space_to_depth_2x2_np


def _round_up(v: int, d: int) -> int:
    return int(np.ceil(v / d) * d)


def pick_canvas(
    shapes: Sequence[Tuple[int, int]],
    canvas: Optional[Tuple[int, int]] = None,
    canvas_buckets: Optional[Sequence[Tuple[int, int]]] = None,
    size_divisor: int = 32,
) -> Tuple[int, int]:
    """The (H, W) every image of the batch is padded to."""
    max_h = max(s[0] for s in shapes)
    max_w = max(s[1] for s in shapes)
    if canvas is not None:
        if canvas[0] < max_h or canvas[1] < max_w:
            raise ValueError(f"canvas {tuple(canvas)} smaller than batch max ({max_h}, {max_w})")
        return tuple(canvas)
    if canvas_buckets:
        fitting = [b for b in canvas_buckets if b[0] >= max_h and b[1] >= max_w]
        if fitting:
            return min(fitting, key=lambda b: b[0] * b[1])
    return (_round_up(max_h, size_divisor), _round_up(max_w, size_divisor))


def _pad_stack(imgs: List[np.ndarray], hw: Tuple[int, int]) -> np.ndarray:
    out = np.zeros((len(imgs), hw[0], hw[1], imgs[0].shape[-1]), imgs[0].dtype)
    for i, im in enumerate(imgs):
        out[i, : im.shape[0], : im.shape[1]] = im
    return out


def _pad_rows(rows: List[np.ndarray], n: int, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """(B, n, width) float32 with each sample's first rows, and their validity."""
    out = np.zeros((len(rows), n, width), np.float32)
    valid = np.zeros((len(rows), n), bool)
    for i, r in enumerate(rows):
        r = r[:n]
        out[i, : len(r)] = r
        valid[i, : len(r)] = True
    return out, valid


def collate(
    samples: List[Dict],
    max_gts: int = 100,
    canvas: Optional[Tuple[int, int]] = None,
    canvas_buckets: Optional[Sequence[Tuple[int, int]]] = None,
    size_divisor: int = 32,
    s2d: bool = False,
    max_proposals: Optional[int] = None,
) -> Dict:
    """Collate training samples (dicts of DataContainers) into one batch:
    ``image`` (B, H, W, C), ``gt_boxes`` (B, max_gts, 4), ``gt_labels``
    int32, ``gt_valid``, ``img_shape`` (B, 2) and ``scale_factor`` (B,)
    float32, ``img_meta`` (the host's list of dicts); with crowds
    ``gt_boxes_ignore`` and ``gt_ignore_valid``; with proposals
    ``proposals`` and ``proposal_valid`` (``max_proposals`` rows, else the
    batch's most). ``s2d=True`` relays the images 2x2 space-to-depth."""
    assert len(samples) > 0
    imgs = [s["img"].data for s in samples]
    hw = pick_canvas([im.shape[:2] for im in imgs], canvas, canvas_buckets, size_divisor)

    b = len(samples)
    gt_boxes, gt_valid = _pad_rows([s["gt_bboxes"].data for s in samples], max_gts, 4)
    gt_labels = np.zeros((b, max_gts), np.int32)
    for i, s in enumerate(samples):
        if "gt_labels" in s:
            labels = np.asarray(s["gt_labels"].data)[:max_gts]
            gt_labels[i, : len(labels)] = labels

    img_metas = [s["img_meta"].data for s in samples]
    batch = dict(
        image=_pad_stack(imgs, hw),
        gt_boxes=gt_boxes,
        gt_labels=gt_labels,
        gt_valid=gt_valid,
        img_shape=np.asarray([m["img_shape"][:2] for m in img_metas], np.float32),
        scale_factor=np.asarray([m["scale_factor"] for m in img_metas], np.float32),
        img_meta=img_metas,
    )
    if "gt_bboxes_ignore" in samples[0]:
        batch["gt_boxes_ignore"], batch["gt_ignore_valid"] = _pad_rows(
            [s["gt_bboxes_ignore"].data.reshape(-1, 4) for s in samples], max_gts, 4)
    if "proposals" in samples[0]:
        props = [s["proposals"].data for s in samples]
        n_prop = max_proposals or max(len(p) for p in props)
        batch["proposals"], batch["proposal_valid"] = _pad_rows(props, n_prop, props[0].shape[-1])
    if s2d:
        batch["image"] = space_to_depth_2x2_np(batch["image"])
    return batch


def collate_test(samples: List[Dict]) -> Dict:
    """Collate test samples (their lists of augmentations): ``imgs``, one
    (B, H, W, C) array an augmentation, each padded on its own, and
    ``img_metas``, one list of dicts an augmentation."""
    out_imgs, out_metas = [], []
    for a in range(len(samples[0]["img"])):
        imgs = [s["img"][a] for s in samples]
        out_imgs.append(_pad_stack(imgs, pick_canvas([im.shape[:2] for im in imgs])))
        out_metas.append([s["img_meta"][a].data for s in samples])
    return dict(imgs=out_imgs, img_metas=out_metas)
