"""Inference entry point and detector evaluation over a dataset.

Counterpart of ``torch_detection_tpu/engine/validate.py``:
``make_inference_fn`` for the Faster R-CNN, Mask R-CNN, Cascade R-CNN,
Cascade Mask R-CNN, Fast R-CNN, RetinaNet, Sparse R-CNN and DETR families
(the port's modules hold their weights, so ``infer`` takes the batch
alone); ``evaluate_detector``, the COCO results dump and the Trainer's
validation hook, the one protocol of the test CLI and of validation in
training.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.collate import pick_canvas
from ..models.detectors import (
    CascadeMaskRCNNConfig,
    CascadeRCNNConfig,
    DETRConfig,
    FasterRCNNConfig,
    FastRCNNConfig,
    MaskRCNNConfig,
    RetinaNetConfig,
    SparseRCNNConfig,
    cascade_mask_rcnn_inference,
    cascade_rcnn_inference,
    detr_inference,
    fast_rcnn_inference,
    faster_rcnn_inference,
    mask_rcnn_inference,
    retina_inference,
    sparse_rcnn_inference,
)
from .eval import eval_coco_map
from .tta import merge_tta_detections

logger = logging.getLogger(__name__)


def _inference(det_cfg, segm: bool) -> Callable:
    """The inference of ``det_cfg``'s family, its mask branch with ``segm``.
    The cascade configs subclass ``FasterRCNNConfig``, so each subclass is
    tested before its base."""
    for config_cls, boxes, masks in ((CascadeMaskRCNNConfig, cascade_rcnn_inference,
                                      cascade_mask_rcnn_inference),
                                     (CascadeRCNNConfig, cascade_rcnn_inference, None),
                                     (MaskRCNNConfig, faster_rcnn_inference, mask_rcnn_inference),
                                     (FasterRCNNConfig, faster_rcnn_inference, None),
                                     (FastRCNNConfig, fast_rcnn_inference, None),
                                     (RetinaNetConfig, retina_inference, None),
                                     (SparseRCNNConfig, sparse_rcnn_inference, None),
                                     (DETRConfig, detr_inference, None)):
        if isinstance(det_cfg, config_cls):
            if segm and masks is None:
                raise ValueError("segm=True needs a mask-capable detector (MaskRCNNConfig or "
                                 f"CascadeMaskRCNNConfig); got {type(det_cfg).__name__}")
            return masks if segm else boxes
    raise NotImplementedError(f"{type(det_cfg).__name__} inference is not ported yet")


def make_inference_fn(model, det_cfg, segm: bool = False) -> Callable:
    """``infer(image, img_shape, scale_factor) -> NMSResult`` for the
    detector family implied by ``det_cfg``: images (B, H, W, 3), or an
    ``stem_s2d`` backbone's (B, H/2, W/2, 12) wire, on the model's device,
    img_shape (B, 2) as (h, w), scale_factor (B,) or (B, 4). ``segm=True``
    runs the mask branch of a Mask R-CNN or Cascade Mask R-CNN and returns
    ``MaskDetections``, whose ``mask_probs`` are the detections' masks. Fast
    R-CNN's ``infer(image, img_shape, scale_factor, proposals,
    proposal_valid)`` also takes its proposals, (B, P, 4|5) in the canvas
    frame, and their (B, P) validity. Sparse R-CNN's ``img_shape`` also
    sizes its initial slate (the canvas where it is None); DETR's masks the
    canvas padding out of its attention (every cell valid where it is
    None)."""
    inference = _inference(det_cfg, segm)

    if isinstance(det_cfg, FastRCNNConfig):
        @torch.inference_mode()
        def infer_proposals(image, img_shape, scale_factor, proposals, proposal_valid):
            return inference(det_cfg, model, image, proposals, proposal_valid, img_shape,
                             scale_factor)

        return infer_proposals

    @torch.inference_mode()
    def infer(image, img_shape=None, scale_factor=None):
        return inference(det_cfg, model, image, img_shape, scale_factor)

    return infer


def evaluate_detector(
    model,
    det_cfg,
    dataset,
    batch: int = 8,
    canvas=None,
    max_images: Optional[int] = None,
    infer: Optional[Callable] = None,
    return_detections: bool = False,
):
    """Run inference over ``dataset`` (a test-mode dataset) on the model's
    device and return the COCO box mAP metrics (``eval_coco_map``'s 12).

    Counterpart of the reference's ``evaluate_detector``: every (image,
    augmentation) goes to a canvas bucket (``canvas``, else its size rounded
    up to 128) and each bucket flushes in padded batches of ``batch``; the
    detections are mapped to the original frame and fused across the
    image's augmentations (``merge_tta_detections``, one augmentation
    included). ``infer`` reuses an inference function across calls. With
    ``return_detections`` also the per-image detection dicts (xyxy in the
    original frame, 1-based labels). Test-time augmentation of the CLI,
    segmentation and VOC metrics and sharded evaluation wait for later
    slices."""
    if infer is None:
        infer = make_inference_fn(model, det_cfg)
    device = next(model.parameters()).device
    needs_props = isinstance(det_cfg, FastRCNNConfig)
    prop_cap = int(getattr(dataset, "num_max_proposals", 1000)) if needs_props else 0

    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    results: Dict = {}  # (img_idx, aug_idx) -> the augmentation's detections
    pending: Dict = {}  # bucket (H, W) -> [(img_idx, aug_idx, img, (h, w), proposals)]
    metas_all = [None] * n

    def flush(bucket, items):
        padded = np.zeros((batch, bucket[0], bucket[1], 3), np.float32)
        shapes = np.ones((batch, 2), np.float32)
        for j, (_, _, img, img_shape, _) in enumerate(items):
            padded[j, : img.shape[0], : img.shape[1]] = img
            shapes[j] = img_shape
        args = [padded, shapes, np.ones((batch,), np.float32)]  # the fusion undoes the scale
        if needs_props:
            props = np.zeros((batch, prop_cap, 4), np.float32)
            pvalid = np.zeros((batch, prop_cap), bool)
            for j, (_, _, _, _, prop) in enumerate(items):
                p = np.asarray(prop, np.float32)[:prop_cap, :4]
                props[j, : len(p)] = p
                pvalid[j, : len(p)] = True
            args += [props, pvalid]
        res = infer(*(torch.from_numpy(a).to(device) for a in args))
        boxes, scores = (t.float().cpu().numpy() for t in (res.boxes, res.scores))
        labels, valid = res.labels.cpu().numpy(), res.valid.cpu().numpy()
        for j, (img_idx, aug_idx, _, _, _) in enumerate(items):
            v = valid[j]
            results[(img_idx, aug_idx)] = dict(boxes=boxes[j][v], scores=scores[j][v],
                                               labels=labels[j][v])

    for i in range(n):
        sample = dataset[i]
        metas_all[i] = [m.data for m in sample["img_meta"]]
        for aug_idx, (img, meta) in enumerate(zip(sample["img"], metas_all[i])):
            if canvas is not None:
                bucket = pick_canvas([img.shape[:2]], canvas=canvas)
            else:
                bucket = pick_canvas([img.shape[:2]], size_divisor=128)
            items = pending.setdefault(bucket, [])
            prop = sample["proposals"][aug_idx] if needs_props else None
            items.append((i, aug_idx, img, (meta["img_shape"][0], meta["img_shape"][1]), prop))
            if len(items) == batch:
                flush(bucket, items)
                pending[bucket] = []
        if (i + 1) % 100 == 0:
            logger.info("eval: loaded %d/%d images (%d buckets live)", i + 1, n, len(pending))
    for bucket, items in pending.items():
        if items:
            flush(bucket, items)

    detections, annotations = [], []
    for i in range(n):
        per_aug = [results[(i, a)] for a in range(len(metas_all[i]))]
        fused = merge_tta_detections(
            per_aug, metas_all[i], iou_thr=getattr(det_cfg, "nms_iou_thr", 0.5))
        detections.append(dict(boxes=fused["boxes"], scores=fused["scores"],
                               labels=fused["labels"] + 1))
        annotations.append(dataset.get_ann_info(i))

    out = eval_coco_map(detections, annotations, det_cfg.num_classes)
    metrics = {k: v for k, v in out.items() if not isinstance(v, dict)}
    if return_detections:
        return metrics, detections
    return metrics


def coco_detection_dump(dataset, detections) -> list:
    """Per-image detection dicts (xyxy in the original frame, inclusive +1
    pixel convention, 1-based labels) -> COCO results records: the
    dataset's image ids and category ids (the inverse of ``cat2label``),
    xywh boxes. A dataset without COCO metadata gives its index and the
    label."""
    label2cat = None
    if hasattr(dataset, "cat2label"):
        label2cat = {v: k for k, v in dataset.cat2label.items()}
    records = []
    for idx, det in enumerate(detections):
        img_id = dataset.img_infos[idx]["id"] if hasattr(dataset, "img_infos") else idx
        for box, score, label in zip(det["boxes"], det["scores"], det["labels"]):
            x1, y1, x2, y2 = (float(v) for v in box[:4])
            label = int(label)
            records.append({
                "image_id": img_id,
                "category_id": label2cat.get(label, label) if label2cat else label,
                "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                "score": float(score),
            })
    return records


def make_validation_hook(
    model,
    det_cfg,
    dataset,
    batch: int = 8,
    canvas=None,
    max_images: Optional[int] = None,
) -> Callable[[], Dict[str, float]]:
    """``hook() -> metrics`` for the Trainer's validation: the model as it
    stands, in eval mode for the call, through one inference function
    built once."""
    infer = make_inference_fn(model, det_cfg)

    def hook() -> Dict[str, float]:
        was_training = model.training
        model.eval()
        try:
            return evaluate_detector(model, det_cfg, dataset, batch=batch, canvas=canvas,
                                     max_images=max_images, infer=infer)
        finally:
            model.train(was_training)

    return hook
