"""Inference entry point and detector evaluation over a dataset.

Counterpart of ``torch_detection_tpu/engine/validate.py``:
``make_inference_fn`` for the Faster R-CNN, Mask R-CNN, Cascade R-CNN,
Cascade Mask R-CNN, Fast R-CNN, RetinaNet, Sparse R-CNN, DETR, FCOS, ATSS,
GFL, FoveaBox, FreeAnchor (RetinaNet's inference), PAA, SSD, YOLOv3, YOLOX,
CenterNet and SOLOv2 families
(the port's modules hold their weights, so ``infer`` takes the batch
alone); ``evaluate_detector`` (box mAP, and with ``segm`` mask mAP), the COCO
results dumps (boxes and RLE masks) and the Trainer's validation hook, the
one protocol of the test CLI and of validation in training; with
``voc_metric`` VOC2007's 11-point AP at IoU 0.5 instead of COCO's metrics.
In a ``torch.distributed`` group of several ranks the images are spread
over the ranks and the detections gathered.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.collate import pick_canvas
from ..data.sampler import DistributedGroupSampler
from ..models.detectors import (
    ATSSConfig,
    CascadeMaskRCNNConfig,
    CascadeRCNNConfig,
    CenterNetConfig,
    DETRConfig,
    FasterRCNNConfig,
    FastRCNNConfig,
    FCOSConfig,
    FoveaConfig,
    GFLConfig,
    MaskRCNNConfig,
    PAAConfig,
    RetinaNetConfig,
    SOLOV2Config,
    SparseRCNNConfig,
    SSDConfig,
    YOLOV3Config,
    YOLOXConfig,
    atss_inference,
    cascade_mask_rcnn_inference,
    cascade_rcnn_inference,
    centernet_inference,
    detr_inference,
    fast_rcnn_inference,
    faster_rcnn_inference,
    fcos_inference,
    fovea_inference,
    gfl_inference,
    mask_rcnn_inference,
    paa_inference,
    retina_inference,
    solov2_box_inference,
    solov2_inference,
    sparse_rcnn_inference,
    ssd_inference,
    yolo_inference,
    yolox_inference,
)
from ..data.ops.mask import _rle_compress, rle_encode
from ..models.heads.mask_head import paste_masks_np
from ..parallel.distributed import all_gather_objects, broadcast_object, is_main, rank, world_size
from .eval import eval_coco_map, eval_coco_segm_map, eval_voc_map
from .tta import masks_to_original, merge_tta_detections, unflip_masks

logger = logging.getLogger(__name__)


def _inference(det_cfg, segm: bool) -> Callable:
    """The inference of ``det_cfg``'s family, its mask branch with ``segm``
    (SOLOv2's box route: the decode's mask-extent boxes). The cascade configs subclass ``FasterRCNNConfig``, so each subclass is
    tested before its base. ``FreeAnchorConfig`` subclasses
    ``RetinaNetConfig`` and takes its inference; no other dense config
    subclasses another."""
    for config_cls, boxes, masks in ((CascadeMaskRCNNConfig, cascade_rcnn_inference,
                                      cascade_mask_rcnn_inference),
                                     (CascadeRCNNConfig, cascade_rcnn_inference, None),
                                     (MaskRCNNConfig, faster_rcnn_inference, mask_rcnn_inference),
                                     (FasterRCNNConfig, faster_rcnn_inference, None),
                                     (FastRCNNConfig, fast_rcnn_inference, None),
                                     (RetinaNetConfig, retina_inference, None),
                                     (SparseRCNNConfig, sparse_rcnn_inference, None),
                                     (DETRConfig, detr_inference, None),
                                     (GFLConfig, gfl_inference, None),
                                     (ATSSConfig, atss_inference, None),
                                     (FCOSConfig, fcos_inference, None),
                                     (FoveaConfig, fovea_inference, None),
                                     (PAAConfig, paa_inference, None),
                                     (SSDConfig, ssd_inference, None),
                                     (YOLOV3Config, yolo_inference, None),
                                     (YOLOXConfig, yolox_inference, None),
                                     (CenterNetConfig, centernet_inference, None),
                                     (SOLOV2Config, solov2_box_inference, solov2_inference)):
        if isinstance(det_cfg, config_cls):
            if segm and masks is None:
                raise ValueError("segm=True needs a mask-capable detector (MaskRCNNConfig, "
                                 "CascadeMaskRCNNConfig or SOLOV2Config); got "
                                 f"{type(det_cfg).__name__}")
            return masks if segm else boxes
    raise NotImplementedError(f"{type(det_cfg).__name__} inference is not ported yet")


def make_inference_fn(model, det_cfg, segm: bool = False) -> Callable:
    """``infer(image, img_shape, scale_factor) -> NMSResult`` for the
    detector family implied by ``det_cfg``: images (B, H, W, 3), or an
    ``stem_s2d`` backbone's (B, H/2, W/2, 12) wire, on the model's device,
    img_shape (B, 2) as (h, w), scale_factor (B,) or (B, 4). ``segm=True``
    runs the mask branch of a Mask R-CNN or Cascade Mask R-CNN, or SOLOv2's
    decode, and returns ``MaskDetections``, whose ``mask_probs`` are the
    detections' masks (SOLOv2's: each (M, M) patch in its box's frame). Fast
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
    tta: bool = False,
    infer: Optional[Callable] = None,
    return_detections: bool = False,
    segm: bool = False,
    voc_metric: bool = False,
):
    """Run inference over ``dataset`` (a test-mode dataset) on the model's
    device and return the COCO box mAP metrics (``eval_coco_map``'s 12), or
    with ``voc_metric`` VOC2007's 11-point AP at IoU 0.5 (``{"mAP"}``; the
    annotations' ``bboxes_ignore`` as ignore regions).

    Counterpart of the reference's ``evaluate_detector``: every (image,
    augmentation) goes to a canvas bucket (``canvas`` unless ``tta``, else
    its size rounded up to 128) and each bucket flushes in padded batches of
    ``batch``; the detections are mapped to the original frame and fused
    across the image's augmentations (``merge_tta_detections``, one
    augmentation included, at the config's ``nms_iou_thr``, 0.5 where it
    has none). ``infer`` reuses an inference function across calls. With
    ``return_detections`` also the per-image detection dicts (xyxy in the
    original frame, 1-based labels).

    ``segm=True`` (the mask families) also pastes each detection's mask in
    the original frame and adds the 12 mask-IoU metrics as ``segm_*``; each
    image's masks are RLE-encoded at once, so the detections carry
    ``masks`` as RLE dicts and no dense mask outlives its image. With one
    augmentation (``tta=False``; several raise ``ValueError``) the masks
    are pasted at the detections' own boxes (``masks_to_original``). With
    ``tta=True`` each flipped augmentation's (D, M, M) probabilities are
    mirrored back, the boxes are fused with the probabilities as
    ``extras``, and each kept detection's source patch is pasted at its
    fused box: the NMS selects, so each has one source.

    In a group of several ranks (every rank calls it, the reference's
    ``mesh=``) each rank infers the strided shard of the
    test-mode ``DistributedGroupSampler`` over the ``n`` images, in
    batches of ``batch``, and fuses its images' detections; the detections
    are gathered on every rank, the images that the sampler's cyclic pad
    repeated are dropped, rank 0 scores them and every rank returns rank
    0's metrics (and the detections, in image order). In float32 an
    image's detections do not depend on its place in its batch, so the
    result is the one process's; in bf16 a cuDNN convolution's rounding can
    (on an H100, C5's), so near-tied scores may rank otherwise."""
    if infer is None:
        infer = make_inference_fn(model, det_cfg, segm=segm)
    device = next(model.parameters()).device
    needs_props = isinstance(det_cfg, FastRCNNConfig)
    prop_cap = int(getattr(dataset, "num_max_proposals", 1000)) if needs_props else 0

    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    ranks = world_size()
    # this rank's images, in order; a repeated one at the end pads the shards to one size
    order = list(range(n)) if ranks == 1 else list(DistributedGroupSampler(
        _TestIndices(n), num_replicas=ranks, rank=rank()))
    results: Dict = {}  # (position, aug_idx) -> the augmentation's detections
    pending: Dict = {}  # bucket (H, W) -> [(position, aug_idx, img, (h, w), proposals)]
    metas_all = [None] * len(order)

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
        mask_probs = res.mask_probs.float().cpu().numpy() if segm else None
        for j, (img_idx, aug_idx, _, _, _) in enumerate(items):
            v = valid[j]
            results[(img_idx, aug_idx)] = dict(boxes=boxes[j][v], scores=scores[j][v],
                                               labels=labels[j][v])
            if segm:
                results[(img_idx, aug_idx)]["mask_probs"] = mask_probs[j][v]

    for pos, i in enumerate(order):
        sample = dataset[i]
        metas_all[pos] = [m.data for m in sample["img_meta"]]
        for aug_idx, (img, meta) in enumerate(zip(sample["img"], metas_all[pos])):
            if canvas is not None and not tta:
                bucket = pick_canvas([img.shape[:2]], canvas=canvas)
            else:
                bucket = pick_canvas([img.shape[:2]], size_divisor=128)
            items = pending.setdefault(bucket, [])
            prop = sample["proposals"][aug_idx] if needs_props else None
            items.append((pos, aug_idx, img, (meta["img_shape"][0], meta["img_shape"][1]), prop))
            if len(items) == batch:
                flush(bucket, items)
                pending[bucket] = []
        if (pos + 1) % 100 == 0:
            logger.info("eval: loaded %d/%d images (%d buckets live)", pos + 1, len(order),
                        len(pending))
    for bucket, items in pending.items():
        if items:
            flush(bucket, items)

    iou_thr = getattr(det_cfg, "nms_iou_thr", 0.5)  # DETR has none; the fusion needs one
    fused_all = []  # (image index, its detections) for each of this rank's positions
    for pos, i in enumerate(order):
        per_aug = [results[(pos, a)] for a in range(len(metas_all[pos]))]
        metas = metas_all[pos]
        if segm:
            if len(per_aug) > 1 and not tta:
                raise ValueError("the dataset yields several test augmentations but tta=False; "
                                 "segm evaluation would drop all but the first: pass tta=True "
                                 "(the fusion keeps each mask's source) or a single-augmentation "
                                 "val dataset")
            if tta:
                fused = merge_tta_detections(
                    per_aug, metas, iou_thr=iou_thr,
                    extras=[unflip_masks(d["mask_probs"], m) for d, m in zip(per_aug, metas)])
                boxes, scores, labels = fused["boxes"], fused["scores"], fused["labels"]
                masks = paste_masks_np(fused["extras"], boxes, tuple(metas[0]["ori_shape"][:2]))
            else:
                masks, boxes = masks_to_original(per_aug[0]["mask_probs"], per_aug[0]["boxes"],
                                                 metas[0])
                scores, labels = per_aug[0]["scores"], per_aug[0]["labels"]
            fused_all.append((i, dict(boxes=boxes.astype(np.float32), scores=scores,
                                      labels=labels + 1,
                                      masks=[rle_encode(m) for m in masks.astype(np.uint8)])))
        else:
            fused = merge_tta_detections(per_aug, metas, iou_thr=iou_thr)
            fused_all.append((i, dict(boxes=fused["boxes"], scores=fused["scores"],
                                      labels=fused["labels"] + 1)))
    if ranks > 1:
        gathered = {}
        for part in all_gather_objects(fused_all):
            for i, det in part:
                gathered.setdefault(i, det)  # the cyclic pad's repeats dropped
        fused_all = sorted(gathered.items())
    detections = [det for _, det in fused_all]
    assert len(detections) == n

    metrics = None
    if ranks == 1 or is_main():
        metrics = _score(dataset, detections, det_cfg.num_classes, segm, voc_metric)
    if ranks > 1:
        metrics = broadcast_object(metrics)
    if return_detections:
        return metrics, detections
    return metrics


class _TestIndices:
    """``n`` images as a test-mode dataset, for the sharded evaluation's
    ``DistributedGroupSampler``."""

    test_mode = True

    def __init__(self, n: int):
        self.n = n

    def __len__(self) -> int:
        return self.n


def _score(dataset, detections, num_classes: int, segm: bool, voc_metric: bool) -> Dict[str, float]:
    """The metrics of the detections of ``dataset``'s first ``len(detections)``
    images against their annotations (masks as RLE for ``segm``)."""
    annotations = []
    for i in range(len(detections)):
        ann = dataset.get_ann_info(i)
        if segm:
            ann = dict(ann, **{k: [m if isinstance(m, dict) else rle_encode(np.asarray(m, np.uint8))
                                   for m in ann.get(k, [])] for k in ("masks", "masks_ignore")})
        annotations.append(ann)
    if voc_metric:
        out = eval_voc_map(detections, annotations, num_classes, use_07_metric=True)
    else:
        out = eval_coco_map(detections, annotations, num_classes)
    metrics = {k: v for k, v in out.items() if not isinstance(v, dict)}
    if segm:
        segm_out = eval_coco_segm_map(detections, annotations, num_classes)
        metrics.update({f"segm_{k}": v for k, v in segm_out.items() if not isinstance(v, dict)})
    return metrics


def _coco_ids(dataset):
    """(dataset index -> COCO image id, 1-based label -> COCO category id):
    the inverse of ``cat2label``; a dataset without COCO metadata gives its
    index and the label."""
    label2cat = {v: k for k, v in getattr(dataset, "cat2label", {}).items()}
    infos = getattr(dataset, "img_infos", None)
    return ((lambda idx: infos[idx]["id"]) if infos is not None else (lambda idx: idx),
            lambda label: label2cat.get(int(label), int(label)))


def coco_detection_dump(dataset, detections) -> list:
    """Per-image detection dicts (xyxy in the original frame, inclusive +1
    pixel convention, 1-based labels) -> COCO results records: the
    dataset's image ids and category ids, xywh boxes."""
    img_id, cat_id = _coco_ids(dataset)
    records = []
    for idx, det in enumerate(detections):
        for box, score, label in zip(det["boxes"], det["scores"], det["labels"]):
            x1, y1, x2, y2 = (float(v) for v in box[:4])
            records.append({
                "image_id": img_id(idx),
                "category_id": cat_id(label),
                "bbox": [x1, y1, x2 - x1 + 1.0, y2 - y1 + 1.0],
                "score": float(score),
            })
    return records


def coco_segm_dump(dataset, detections) -> list:
    """Per-image detections with ``masks`` (RLE dicts, or dense masks) ->
    COCO segmentation results records: ``{"size", "counts"}`` with the
    compressed counts as a string, the ids as ``coco_detection_dump``'s."""
    img_id, cat_id = _coco_ids(dataset)
    records = []
    for idx, det in enumerate(detections):
        for mask, score, label in zip(det["masks"], det["scores"], det["labels"]):
            rle = mask if isinstance(mask, dict) else rle_encode(np.asarray(mask, np.uint8))
            counts = rle["counts"]
            if not isinstance(counts, (bytes, str)):
                counts = _rle_compress(counts)
            if isinstance(counts, bytes):
                rle = dict(rle, counts=counts.decode("ascii"))
            records.append({
                "image_id": img_id(idx),
                "category_id": cat_id(label),
                "segmentation": rle,
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
    segm: bool = False,
    voc_metric: bool = False,
) -> Callable[[], Dict[str, float]]:
    """``hook() -> metrics`` for the Trainer's validation: the model as it
    stands, in eval mode for the call, through one inference function
    built once; ``segm`` adds the mask metrics, ``voc_metric`` scores VOC
    AP instead of COCO's. In a group of several ranks every rank calls the
    hook, and the images are spread over them."""
    infer = make_inference_fn(model, det_cfg, segm=segm)

    def hook() -> Dict[str, float]:
        was_training = model.training
        model.eval()
        try:
            return evaluate_detector(model, det_cfg, dataset, batch=batch, canvas=canvas,
                                     max_images=max_images, infer=infer, segm=segm,
                                     voc_metric=voc_metric)
        finally:
            model.train(was_training)

    return hook
