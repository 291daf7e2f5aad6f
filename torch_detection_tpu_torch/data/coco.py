"""CocoDataset.

Counterpart of ``torch_detection_tpu/data/coco.py``: category id ->
contiguous 1-based label, sorted image ids, images without annotations
filtered in training, and the bbox/label/ignore ann dict (with the crowds'
classes and the annotation areas COCO evaluation reads); ``with_mask`` adds
the non-crowd annotations' masks (polygons or RLE), the crowds' as
``masks_ignore`` (their segmentation, else their box's window), and the
valid polygons.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..utils.registry import DATASETS
from .base import BaseDataset
from .coco_api import COCO
from .ops.bbox import bbox_parse
from .ops.mask import mask_parse, segm_to_mask


@DATASETS.register_module
class CocoDataset(BaseDataset):
    def load_annotations(self, ann_file) -> List[Dict]:
        self.coco = COCO(ann_file)
        cat_ids = self.coco.get_cat_ids()
        self.classes = [self.coco.load_cats([cid])[0]["name"] for cid in cat_ids]
        self.cat2label = {cid: i + 1 for i, cid in enumerate(cat_ids)}
        self.img_ids = sorted(self.coco.get_img_ids())
        img_infos = []
        for img_id in self.img_ids:
            info = dict(self.coco.load_imgs([img_id])[0])
            info["filename"] = info["file_name"]
            img_infos.append(info)
        return img_infos

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        """Drop images that are too small or carry no annotations."""
        ids_with_ann = {a["image_id"] for a in self.coco.anns.values()}
        return [
            i
            for i, info in enumerate(self.img_infos)
            if info["id"] in ids_with_ann and min(info["width"], info["height"]) >= min_size
        ]

    def get_ann_info(self, idx: int) -> Dict:
        img_info = self.img_infos[idx]
        h, w = img_info["height"], img_info["width"]
        anns = self.coco.load_anns(self.coco.get_ann_ids(img_ids=[img_info["id"]]))
        gt_bboxes: List = []
        gt_labels: List = []
        gt_bboxes_ignore: List = []
        gt_labels_ignore: List = []
        gt_areas: List = []
        gt_masks: List = []
        gt_masks_ignore: List = []
        gt_mask_polys: List = []
        gt_poly_lens: List = []
        for ann in anns:
            if not bbox_parse(ann, gt_bboxes, gt_labels, gt_bboxes_ignore, self.cat2label,
                              gt_labels_ignore=gt_labels_ignore, gt_areas=gt_areas):
                continue
            if not self.with_mask:
                continue
            if not ann.get("iscrowd", 0):
                mask_parse(ann, gt_masks, gt_mask_polys, gt_poly_lens, h, w)
            elif "segmentation" in ann:
                gt_masks_ignore.append(segm_to_mask(ann["segmentation"], h, w))
            else:
                # a crowd without a segmentation: its box's window, so that the
                # segm evaluation ignores detections there as the box one does
                m = np.zeros((h, w), np.uint8)
                x, y, bw, bh = (float(v) for v in ann["bbox"])
                x1, y1 = int(np.floor(x)), int(np.floor(y))
                x2, y2 = int(np.ceil(x + bw)), int(np.ceil(y + bh))
                m[max(y1, 0): max(y2, 0), max(x1, 0): max(x2, 0)] = 1
                gt_masks_ignore.append(m)
        out = dict(
            bboxes=np.asarray(gt_bboxes, np.float32).reshape(-1, 4),
            labels=np.asarray(gt_labels, np.int64),
            bboxes_ignore=np.asarray(gt_bboxes_ignore, np.float32).reshape(-1, 4),
            labels_ignore=np.asarray(gt_labels_ignore, np.int64),
            areas=np.asarray(gt_areas, np.float64),
        )
        if self.with_mask:
            out.update(masks=gt_masks, masks_ignore=gt_masks_ignore, mask_polys=gt_mask_polys,
                       poly_lens=gt_poly_lens)
        return out
