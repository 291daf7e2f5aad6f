"""Detection evaluation: COCO-style box mAP, numpy.

Counterpart of ``torch_detection_tpu/engine/eval.py``: per-class PR curves
matched greedily by descending score at IoU thresholds 0.50:0.05:0.95,
101-point interpolated AP, area ranges (all/small/medium/large), maxDets
1/10/100, crowd boxes as ignore regions (IoU = intersection / detection
area), the full 12-metric summary; the same protocol on mask IoU
(``eval_coco_segm_map``), computed on the masks' RLE runs. The matchers are
the reference's Python versions, which its C++ matcher
(``native/eval_match.cpp``, boxes only) only speeds up. VOC AP waits for a
later slice.

Box convention: xyxy with the inclusive +1 area rule.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..data.ops.mask import rle_area, rle_encode, rle_iou_matrix


def _iou_matrix(det: np.ndarray, gt: np.ndarray, offset: float = 1.0) -> np.ndarray:
    if det.size == 0 or gt.size == 0:
        return np.zeros((len(det), len(gt)))
    lt = np.maximum(det[:, None, :2], gt[None, :, :2])
    rb = np.minimum(det[:, None, 2:4], gt[None, :, 2:4])
    wh = np.clip(rb - lt + offset, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (det[:, 2] - det[:, 0] + offset) * (det[:, 3] - det[:, 1] + offset)
    a2 = (gt[:, 2] - gt[:, 0] + offset) * (gt[:, 3] - gt[:, 1] + offset)
    return inter / np.maximum(a1[:, None] + a2[None, :] - inter, 1e-9)


def _box_area(boxes: np.ndarray, offset: float = 1.0) -> np.ndarray:
    if boxes.size == 0:
        return np.zeros((0,))
    return (boxes[:, 2] - boxes[:, 0] + offset) * (boxes[:, 3] - boxes[:, 1] + offset)


COCO_AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _match_image(
    det_boxes: np.ndarray,  # (D, 4) sorted by descending score
    gt_boxes: np.ndarray,  # (G, 4)
    gt_ignore: np.ndarray,  # (G,) bool (crowd / outside area range)
    ignore_regions: np.ndarray,  # (R, 4) crowd boxes (match allowed, not scored)
    iou_thr: float,
    iou: Optional[np.ndarray] = None,  # precomputed (D, G), e.g. mask IoU
    iou_crowd: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy matching. Returns (det_matched, det_ignored) bool arrays.

    The VOC protocol's matcher; ``iou`` and ``iou_crowd`` may be given
    precomputed (mask IoU).
    """
    if iou is None:
        iou = _iou_matrix(det_boxes, gt_boxes)
        iou_crowd = _iou_matrix(det_boxes, ignore_regions) if len(ignore_regions) else None
    d = len(det_boxes)
    g = len(gt_boxes)
    matched = np.zeros(d, bool)
    det_ignored = np.zeros(d, bool)
    gt_taken = np.zeros(g, bool)

    for i in range(d):
        best_j = -1
        best_iou = iou_thr
        # prefer non-ignored gts; an ignored gt can still absorb the det
        best_ignored_j = -1
        best_ignored_iou = iou_thr
        for j in range(g):
            if gt_taken[j] or iou[i, j] < iou_thr:
                continue
            if gt_ignore[j]:
                if iou[i, j] > best_ignored_iou:
                    best_ignored_iou = iou[i, j]
                    best_ignored_j = j
            elif iou[i, j] > best_iou or best_j < 0:
                best_iou = iou[i, j]
                best_j = j
        if best_j >= 0:
            matched[i] = True
            gt_taken[best_j] = True
        elif best_ignored_j >= 0:
            det_ignored[i] = True
            gt_taken[best_ignored_j] = True
        elif iou_crowd is not None and iou_crowd[i].size and iou_crowd[i].max() >= iou_thr:
            det_ignored[i] = True
    return matched, det_ignored


_REC_THRS = np.linspace(0.0, 1.0, 101)


def _coco_match_img(
    iou: np.ndarray,  # (D, G) — gt columns sorted non-ignored first
    gt_ig: np.ndarray,  # (G,) bool, in the same sorted order
    gt_crowd: np.ndarray,  # (G,) bool
    iou_thrs: np.ndarray,  # (T,)
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact COCO per-image matching for all T thresholds at once.

    Protocol (COCO evaluateImg): detections in descending-score order each
    claim the highest-IoU still-free gt above the threshold; crowd gts may
    be matched by many detections; once a detection has a non-ignored match
    candidate, ignored gts (which sort last) cannot override it. Returns
    (matched, ignored) each (T, D): matched = det matched ANY gt (incl.
    ignored); ignored = the matched gt was ignored.
    """
    d_n, g_n = iou.shape
    t_n = len(iou_thrs)
    dt_matched = np.zeros((t_n, d_n), bool)
    dt_ig = np.zeros((t_n, d_n), bool)
    for t in range(t_n):
        thr = min(iou_thrs[t], 1.0 - 1e-10)
        gtm = np.full(g_n, -1, np.int64)
        for d in range(d_n):
            best = thr
            m = -1
            for g in range(g_n):
                if gtm[g] >= 0 and not gt_crowd[g]:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break  # gts are sorted non-ignored first; no better match
                if iou[d, g] < best:
                    continue
                best = iou[d, g]
                m = g
            if m == -1:
                continue
            dt_matched[t, d] = True
            dt_ig[t, d] = gt_ig[m]
            gtm[m] = d
    return dt_matched, dt_ig


def _coco_eval_core(
    per_class_images,  # per_class_images[k][i] = per-image eval inputs (see below)
    num_classes: int,
    iou_thrs: np.ndarray,
    area_ranges: Sequence[str],
    max_dets: Sequence[int],
):
    """COCO accumulate over (T thresholds, R=101 recalls, K classes,
    A area ranges, M maxDets). Input per (class k, image i):
    ``(dt_scores_sorted, dt_areas, iou, gt_areas, gt_crowd)`` where ``iou``
    is (D, G) with crowd columns already normalized by detection area and
    detections truncated to max(max_dets).  Returns (precision, recall)
    tensors with -1 marking absent classes (COCO convention)."""
    t_n, k_n, a_n, m_n = len(iou_thrs), num_classes, len(area_ranges), len(max_dets)
    precision = -np.ones((t_n, len(_REC_THRS), k_n, a_n, m_n))
    recall = -np.ones((t_n, k_n, a_n, m_n))

    for k in range(k_n):
        images = per_class_images[k]
        for a, a_name in enumerate(area_ranges):
            lo, hi = COCO_AREA_RANGES[a_name]
            # per-image matching at the largest maxDet; smaller maxDets
            # reuse it by truncating each image's detection list
            per_img = []
            npig = 0
            for dt_scores, dt_areas, iou, gt_areas, gt_crowd in images:
                gt_ig = gt_crowd | (gt_areas < lo) | (gt_areas > hi)
                npig += int((~gt_ig).sum())
                d_n = len(dt_scores)
                if d_n == 0:
                    per_img.append((dt_scores, np.zeros((t_n, 0), bool), np.zeros((t_n, 0), bool)))
                    continue
                if iou.shape[1]:
                    order = np.argsort(gt_ig, kind="mergesort")  # non-ignored first
                    matched, ignored = _coco_match_img(
                        iou[:, order], gt_ig[order], gt_crowd[order], iou_thrs
                    )
                else:
                    matched = np.zeros((t_n, d_n), bool)
                    ignored = np.zeros((t_n, d_n), bool)
                # unmatched detections outside the area range are ignored
                out_of_range = (dt_areas < lo) | (dt_areas > hi)
                ignored = ignored | (~matched & out_of_range[None, :])
                per_img.append((dt_scores, matched, ignored))
            if npig == 0:
                continue
            for m, mdet in enumerate(max_dets):
                scores = np.concatenate([p[0][:mdet] for p in per_img])
                if len(scores) == 0:
                    recall[:, k, a, m] = 0.0
                    precision[:, :, k, a, m] = 0.0
                    continue
                matched = np.concatenate([p[1][:, :mdet] for p in per_img], axis=1)
                ignored = np.concatenate([p[2][:, :mdet] for p in per_img], axis=1)
                order = np.argsort(-scores, kind="mergesort")
                matched = matched[:, order]
                ignored = ignored[:, order]
                tps = np.cumsum(matched & ~ignored, axis=1, dtype=np.float64)
                fps = np.cumsum(~matched & ~ignored, axis=1, dtype=np.float64)
                for t in range(t_n):
                    tp, fp = tps[t], fps[t]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / np.maximum(fp + tp, np.spacing(1))
                    recall[t, k, a, m] = rc[-1] if nd else 0.0
                    # precision envelope (monotone non-increasing)
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    inds = np.searchsorted(rc, _REC_THRS, side="left")
                    q = np.zeros(len(_REC_THRS))
                    valid = inds < nd
                    q[valid] = pr[inds[valid]]
                    precision[t, :, k, a, m] = q
    return precision, recall


def _coco_summarize(precision, recall, iou_thrs, area_ranges, max_dets, area_range):
    def _ap(t=None, a="all", m=100):
        a_i = list(area_ranges).index(a)
        m_i = list(max_dets).index(m)
        s = precision[:, :, :, a_i, m_i] if t is None else precision[[t], :, :, a_i, m_i]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    def _ar(a="all", m=100):
        a_i = list(area_ranges).index(a)
        m_i = list(max_dets).index(m)
        s = recall[:, :, a_i, m_i]
        s = s[s > -1]
        return float(np.mean(s)) if s.size else -1.0

    t50 = int(np.argmin(np.abs(iou_thrs - 0.5)))
    t75 = int(np.argmin(np.abs(iou_thrs - 0.75)))
    out = {
        "mAP": _ap(a=area_range),
        "mAP_50": _ap(t=t50, a=area_range),
        "mAP_75": _ap(t=t75, a=area_range),
    }
    if "small" in area_ranges:
        out["mAP_s"] = _ap(a="small")
        out["mAP_m"] = _ap(a="medium")
        out["mAP_l"] = _ap(a="large")
    for m in max_dets:
        out[f"AR_{m}"] = _ar(m=m)
    if "small" in area_ranges:
        out["AR_s"] = _ar(a="small")
        out["AR_m"] = _ar(a="medium")
        out["AR_l"] = _ar(a="large")
    return out


def eval_coco_map(
    detections: List[Dict[str, np.ndarray]],
    annotations: List[Dict[str, np.ndarray]],
    num_classes: int,
    iou_thrs: Optional[Sequence[float]] = None,
    max_dets: Sequence[int] = (1, 10, 100),
    area_range: str = "all",
) -> Dict[str, float]:
    """Protocol-exact COCO bbox evaluation (the full 12-metric suite).

    detections[i]: {'boxes': (D,4), 'scores': (D,), 'labels': (D,) 1-based}
    annotations[i]: {'bboxes': (G,4), 'labels': (G,) 1-based,
                     'bboxes_ignore': (R,4) crowd boxes,
                     optional 'labels_ignore': (R,) 1-based crowd classes
                       (without it crowds absorb detections of EVERY class),
                     optional 'areas': (G,) annotation areas (COCO uses the
                       segmentation area; defaults to box area)}

    Matching follows COCO evaluateImg semantics exactly: detections are
    never pre-filtered by area — out-of-range gts are ignore-matched and
    out-of-range UNMATCHED detections are dropped from scoring after
    matching; crowd gts can absorb multiple detections with IoU computed
    as intersection / detection-area.  ``area_range`` selects which bucket
    the headline mAP keys report; the s/m/l and AR metrics are always
    computed.
    """
    if iou_thrs is None:
        # exact linspace, not arange: arange's accumulation drift makes
        # the 0.75 rung 0.75+2e-16, silently rejecting IoU == 0.75
        # matches (pycocotools uses linspace for precisely this reason)
        iou_thrs = np.linspace(0.5, 0.95, 10)
    iou_thrs = np.asarray(iou_thrs, np.float64)
    max_dets = tuple(sorted(max_dets))
    area_ranges = ("all", "small", "medium", "large")
    top_k = max_dets[-1]

    per_class_images = [[] for _ in range(num_classes)]
    for det, ann in zip(detections, annotations):
        crowd_boxes = np.asarray(ann.get("bboxes_ignore", np.zeros((0, 4)))).reshape(-1, 4)
        crowd_labels = ann.get("labels_ignore")
        gt_areas_all = ann.get("areas")
        for c in range(1, num_classes + 1):
            keep = det["labels"] == c
            boxes = np.asarray(det["boxes"])[keep]
            scores = np.asarray(det["scores"])[keep]
            order = np.argsort(-scores, kind="mergesort")[:top_k]
            boxes, scores = boxes[order], scores[order]
            dt_areas = _box_area(boxes)

            gt_keep = ann["labels"] == c
            gts = np.asarray(ann["bboxes"])[gt_keep]
            if gt_areas_all is not None:
                g_areas = np.asarray(gt_areas_all, np.float64)[gt_keep]
            else:
                g_areas = _box_area(gts)
            if crowd_labels is not None and len(crowd_boxes):
                crowds = crowd_boxes[np.asarray(crowd_labels) == c]
            else:
                crowds = crowd_boxes
            iou = _iou_matrix(boxes, gts)
            if len(crowds):
                # crowd IoU = intersection / detection area (COCO iscrowd)
                lt = np.maximum(boxes[:, None, :2], crowds[None, :, :2])
                rb = np.minimum(boxes[:, None, 2:4], crowds[None, :, 2:4])
                wh = np.clip(rb - lt + 1.0, 0, None)
                inter = wh[..., 0] * wh[..., 1]
                iou_crowd = inter / np.maximum(dt_areas[:, None], 1e-9)
                iou = np.concatenate([iou, iou_crowd], axis=1) if iou.size else iou_crowd
                g_areas = np.concatenate([g_areas, _box_area(crowds)])
                gt_crowd = np.concatenate(
                    [np.zeros(int(gt_keep.sum()), bool), np.ones(len(crowds), bool)]
                )
            else:
                gt_crowd = np.zeros(int(gt_keep.sum()), bool)
            per_class_images[c - 1].append((scores, dt_areas, iou, g_areas, gt_crowd))

    precision, recall = _coco_eval_core(
        per_class_images, num_classes, iou_thrs, area_ranges, max_dets
    )
    out = _coco_summarize(precision, recall, iou_thrs, area_ranges, max_dets, area_range)
    a_i = area_ranges.index("all")
    m_i = max_dets.index(top_k)
    per_class = {}
    for c in range(num_classes):
        s = precision[:, :, c, a_i, m_i]
        s = s[s > -1]
        if s.size:
            per_class[c + 1] = float(np.mean(s))
    out["per_class"] = per_class
    # absent classes contribute -1 in COCO; report 0.0 when nothing evaluable
    for key, val in list(out.items()):
        if isinstance(val, float) and val == -1.0:
            out[key] = 0.0
    return out


def mask_iou_matrix(det_masks: np.ndarray, gt_masks: np.ndarray) -> np.ndarray:
    """IoU between (D, H, W) and (G, H, W) binary masks -> (D, G)."""
    if len(det_masks) == 0 or len(gt_masks) == 0:
        return np.zeros((len(det_masks), len(gt_masks)))
    d = np.asarray(det_masks, bool).reshape(len(det_masks), -1)
    g = np.asarray(gt_masks, bool).reshape(len(gt_masks), -1)
    inter = d.astype(np.float64) @ g.astype(np.float64).T
    area_d = d.sum(axis=1)[:, None]
    area_g = g.sum(axis=1)[None, :]
    return inter / np.maximum(area_d + area_g - inter, 1e-9)


def _as_rles(masks) -> List[Dict]:
    """A mask collection ((N, H, W) dense, a list of (H, W) dense masks, or
    a list of RLE dicts) -> a list of RLE dicts."""
    return [m if isinstance(m, dict) else rle_encode(np.asarray(m, np.uint8), compress=False)
            for m in masks]


def eval_coco_segm_map(
    detections: List[Dict[str, np.ndarray]],
    annotations: List[Dict[str, np.ndarray]],
    num_classes: int,
    iou_thrs: Optional[Sequence[float]] = None,
    max_dets: Sequence[int] = (1, 10, 100),
    area_range: str = "all",
) -> Dict[str, float]:
    """Protocol-exact COCO segmentation evaluation (mask-IoU matching).

    detections[i] also carries ``masks``, (D, H, W) dense or a list of D RLE
    dicts; annotations[i] ``masks`` (aligned with ``labels``) and optionally
    ``masks_ignore`` with ``labels_ignore`` for crowds (crowd IoU =
    intersection / detection-mask area). Areas (for the size buckets) and
    IoUs are computed on the RLE runs, never on dense masks. The same
    accumulation and summary as ``eval_coco_map``."""
    if iou_thrs is None:
        iou_thrs = np.linspace(0.5, 0.95, 10)
    iou_thrs = np.asarray(iou_thrs, np.float64)
    max_dets = tuple(sorted(max_dets))
    area_ranges = ("all", "small", "medium", "large")
    top_k = max_dets[-1]

    per_class_images = [[] for _ in range(num_classes)]
    for det, ann in zip(detections, annotations):
        ann_labels = np.asarray(ann["labels"])
        det_labels = np.asarray(det["labels"])
        det_rles = _as_rles(det["masks"])
        gt_rles = _as_rles(ann["masks"])
        crowd_rles = _as_rles(ann.get("masks_ignore", []))
        crowd_labels = ann.get("labels_ignore")
        for c in range(1, num_classes + 1):
            keep = np.nonzero(det_labels == c)[0]
            scores = np.asarray(det["scores"])[keep]
            order = np.argsort(-scores, kind="mergesort")[:top_k]
            scores = scores[order]
            masks = [det_rles[keep[j]] for j in order]
            dt_areas = np.array([float(rle_area(m)) for m in masks])

            gt_masks = [m for m, k in zip(gt_rles, ann_labels == c) if k]
            if crowd_labels is not None and len(crowd_rles):
                crowds = [m for m, lab in zip(crowd_rles, crowd_labels) if lab == c]
            else:
                crowds = list(crowd_rles)
            g_areas = np.array([float(rle_area(m)) for m in gt_masks])
            iou = rle_iou_matrix(masks, gt_masks)
            if crowds:
                iou_crowd = rle_iou_matrix(masks, crowds, crowd=True)
                iou = np.concatenate([iou, iou_crowd], axis=1) if iou.size else iou_crowd
                g_areas = np.concatenate([g_areas, [float(rle_area(m)) for m in crowds]])
                gt_crowd = np.concatenate([np.zeros(len(gt_masks), bool), np.ones(len(crowds), bool)])
            else:
                gt_crowd = np.zeros(len(gt_masks), bool)
            per_class_images[c - 1].append((scores, dt_areas, iou, g_areas, gt_crowd))

    precision, recall = _coco_eval_core(per_class_images, num_classes, iou_thrs, area_ranges,
                                        max_dets)
    out = _coco_summarize(precision, recall, iou_thrs, area_ranges, max_dets, area_range)
    for key, val in list(out.items()):
        if isinstance(val, float) and val == -1.0:
            out[key] = 0.0
    return out


def detections_from_nms(nms_result, valid_only: bool = True) -> List[Dict[str, np.ndarray]]:
    """Convert a batched NMSResult (labels 0-based) into per-image detection
    dicts with 1-based labels for the evaluators."""
    boxes, scores, labels, valid = (
        t.detach().cpu().numpy()
        for t in (nms_result.boxes, nms_result.scores, nms_result.labels, nms_result.valid))
    out = []
    for i in range(boxes.shape[0]):
        v = valid[i] if valid_only else np.ones(boxes.shape[1], bool)
        out.append(
            dict(boxes=boxes[i][v], scores=scores[i][v], labels=labels[i][v] + 1)
        )
    return out
