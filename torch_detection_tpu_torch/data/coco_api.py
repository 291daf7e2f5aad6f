"""Minimal COCO annotation index.

The port's own copy of ``torch_detection_tpu/data/coco_api.py``: the slice
of the pycocotools ``COCO`` API the data and eval tiers use (lookup by id,
per-image annotation lists, ``ann_to_mask`` through the mask tier's
``segm_to_mask``).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np

from .ops.mask import segm_to_mask


class COCO:
    def __init__(self, annotation_file: Optional[str] = None, dataset: Optional[Dict] = None):
        if dataset is None:
            assert annotation_file is not None
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.anns: Dict[int, Dict] = {}
        self.imgs: Dict[int, Dict] = {}
        self.cats: Dict[int, Dict] = {}
        self.img_to_anns: Dict[int, List[Dict]] = defaultdict(list)
        self.cat_to_imgs: Dict[int, List[int]] = defaultdict(list)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            self.anns[ann["id"]] = ann
            self.img_to_anns[ann["image_id"]].append(ann)
            self.cat_to_imgs[ann["category_id"]].append(ann["image_id"])

    def get_cat_ids(self, cat_names: Sequence[str] = ()) -> List[int]:
        if not cat_names:
            return sorted(self.cats)
        names = set(cat_names)
        return sorted(cid for cid, c in self.cats.items() if c["name"] in names)

    def get_img_ids(self, cat_ids: Sequence[int] = ()) -> List[int]:
        if not cat_ids:
            return sorted(self.imgs)
        ids = None
        for cid in cat_ids:
            s = set(self.cat_to_imgs.get(cid, []))
            ids = s if ids is None else ids & s
        return sorted(ids or [])

    def get_ann_ids(self, img_ids: Sequence[int] = (), cat_ids: Sequence[int] = ()) -> List[int]:
        if img_ids:
            anns = [a for i in img_ids for a in self.img_to_anns.get(i, [])]
        else:
            anns = list(self.anns.values())
        if cat_ids:
            cs = set(cat_ids)
            anns = [a for a in anns if a["category_id"] in cs]
        return [a["id"] for a in anns]

    def load_anns(self, ids: Sequence[int]) -> List[Dict]:
        return [self.anns[i] for i in ids]

    def load_imgs(self, ids: Sequence[int]) -> List[Dict]:
        return [self.imgs[i] for i in ids]

    def load_cats(self, ids: Sequence[int]) -> List[Dict]:
        return [self.cats[i] for i in ids]

    def ann_to_mask(self, ann: Dict) -> np.ndarray:
        """The annotation's polygon or RLE as an (H, W) uint8 mask of its image."""
        img = self.imgs[ann["image_id"]]
        return segm_to_mask(ann["segmentation"], img["height"], img["width"])

    annToMask = ann_to_mask
