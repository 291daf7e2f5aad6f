"""VOCDataset: Pascal VOC XML annotations with a pkl cache.

Counterpart of ``torch_detection_tpu/data/voc.py``: the 20-class table, the
voc07, voc12 and voc07+12 scopes, each split's infos parsed once into
``cache_dir/<scope>_<split>.pkl``, 1-based VOC pixel indices made 0-based,
and ``difficult`` objects as ``bboxes_ignore``. The 07+12 train split is
trainval07 + trainval12 and its test split VOC2007 test, as the
reference's.
"""

from __future__ import annotations

import os
import os.path as osp
import xml.etree.ElementTree as ET
from typing import Dict, List

import numpy as np

from ..utils.file_handler import dump
from ..utils.misc import file_is_exist
from ..utils.registry import DATASETS
from .base import BaseDataset

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


@DATASETS.register_module
class VOCDataset(BaseDataset):
    def __init__(
        self,
        cache_dir: str = "data/cache/",
        dataset_scope: str = "voc07",
        dataset_root: str = "data/voc/voc2007/",
        img_expected_sizes=(1000, 600),
        test_mode: bool = False,
        **kwargs,
    ):
        if dataset_scope not in ("voc07", "voc12", "voc07+12"):
            raise ValueError(f"dataset_scope must be voc07, voc12 or voc07+12, got {dataset_scope!r}")
        ann_file, img_prefix = self._parse_voc(cache_dir, dataset_scope, dataset_root, test_mode)
        super().__init__(ann_file=ann_file, img_prefix=img_prefix,
                         img_expected_sizes=img_expected_sizes, test_mode=test_mode, **kwargs)

    def _parse_voc(self, cache_dir, dataset_scope, dataset_root, test_mode):
        """(the split's cache file, written if missing; the image prefix)."""
        self.classes = VOC_CLASSES
        class_to_cat = {cls: i + 1 for i, cls in enumerate(self.classes)}
        cache_file = osp.join(cache_dir, f"{dataset_scope}_{'test' if test_mode else 'train'}.pkl")
        os.makedirs(osp.expanduser(cache_dir), exist_ok=True)
        if dataset_scope in ("voc07", "voc12"):
            if not file_is_exist(cache_file):
                dump(self._parse_voc_single(dataset_root, class_to_cat, test_mode), cache_file)
            return cache_file, osp.join(dataset_root, "JPEGImages/")
        if not file_is_exist(cache_file):
            infos = self._parse_voc_single(osp.join(dataset_root, "VOC2007/"), class_to_cat,
                                           test_mode, name_prefix="VOC2007/JPEGImages/")
            if not test_mode:
                infos += self._parse_voc_single(osp.join(dataset_root, "VOC2012/"), class_to_cat,
                                                False, name_prefix="VOC2012/JPEGImages/")
            dump(infos, cache_file)
        return cache_file, dataset_root

    def _parse_voc_single(self, dataset_root, class_to_cat, test_mode, name_prefix="") -> List[Dict]:
        listfile = osp.join(dataset_root, "ImageSets/Main", "test.txt" if test_mode else "trainval.txt")
        with open(listfile) as f:
            names = [line.strip() for line in f if line.strip()]
        return [self._parse_ann_info(osp.join(dataset_root, "Annotations", name + ".xml"),
                                     class_to_cat, name_prefix) for name in names]

    def _parse_ann_info(self, annotation_file, class_to_cat, name_prefix) -> Dict:
        tree = ET.parse(annotation_file)
        size = tree.find("size")
        bboxes, labels, bboxes_ignore = [], [], []
        for obj in tree.findall("object"):
            bnd = obj.find("bndbox")
            box = [float(bnd.find(k).text) - 1 for k in ("xmin", "ymin", "xmax", "ymax")]
            difficult = obj.find("difficult")
            if difficult is not None and int(difficult.text) == 1:
                bboxes_ignore.append(box)
            else:
                bboxes.append(box)
                labels.append(class_to_cat[obj.find("name").text.lower().strip()])
        return dict(
            filename=name_prefix + tree.find("filename").text.strip(),
            width=int(size.find("width").text),
            height=int(size.find("height").text),
            ann=dict(
                bboxes=np.asarray(bboxes, np.float32).reshape(-1, 4),
                labels=np.asarray(labels, np.int64),
                bboxes_ignore=np.asarray(bboxes_ignore, np.float32).reshape(-1, 4),
            ),
        )
