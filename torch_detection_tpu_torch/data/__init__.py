from . import ops
from .base import BaseDataset
from .coco import CocoDataset
from .coco_api import COCO
from .collate import collate, collate_test, pick_canvas
from .concat import ConcatDataset, get_datasets
from .container import DataContainer
from .device import prefetch_to_device
from .loader import DataLoader, build_dataloader
from .sampler import DistributedGroupSampler, GroupSampler
from .transforms import BackgroundErasing, BboxTransforms, ImageTransforms, MaskTransforms
from .voc import VOC_CLASSES, VOCDataset

__all__ = [
    "ops",
    "BaseDataset",
    "CocoDataset",
    "COCO",
    "collate",
    "collate_test",
    "pick_canvas",
    "ConcatDataset",
    "get_datasets",
    "DataContainer",
    "prefetch_to_device",
    "DataLoader",
    "build_dataloader",
    "DistributedGroupSampler",
    "GroupSampler",
    "BackgroundErasing",
    "BboxTransforms",
    "ImageTransforms",
    "MaskTransforms",
    "VOC_CLASSES",
    "VOCDataset",
]
