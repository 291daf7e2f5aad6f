from .checkpoint import latest_checkpoint, load_checkpoint, load_checkpoint_file, save_checkpoint
from .eval import detections_from_nms, eval_coco_map
from .trainer import Trainer, detection_lr_schedule
from .validate import (
    coco_detection_dump,
    evaluate_detector,
    make_inference_fn,
    make_validation_hook,
)

__all__ = [
    "Trainer",
    "coco_detection_dump",
    "detection_lr_schedule",
    "detections_from_nms",
    "eval_coco_map",
    "evaluate_detector",
    "latest_checkpoint",
    "load_checkpoint",
    "load_checkpoint_file",
    "make_inference_fn",
    "make_validation_hook",
    "save_checkpoint",
]
