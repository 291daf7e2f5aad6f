from .checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    load_checkpoint_file,
    resolve_checkpoint_source,
    save_checkpoint,
)
from .eval import detections_from_nms, eval_coco_map, eval_coco_segm_map
from .export import export_serving, load_serving, make_serving_fn, save_serving
from .profiling import ThroughputMeter, annotate, trace
from .trainer import Trainer, detection_lr_schedule
from .validate import (
    coco_detection_dump,
    coco_segm_dump,
    evaluate_detector,
    make_inference_fn,
    make_validation_hook,
)

__all__ = [
    "ThroughputMeter",
    "Trainer",
    "annotate",
    "coco_detection_dump",
    "coco_segm_dump",
    "detection_lr_schedule",
    "detections_from_nms",
    "eval_coco_map",
    "eval_coco_segm_map",
    "evaluate_detector",
    "export_serving",
    "latest_checkpoint",
    "load_checkpoint",
    "load_checkpoint_file",
    "load_serving",
    "make_inference_fn",
    "make_serving_fn",
    "make_validation_hook",
    "resolve_checkpoint_source",
    "save_checkpoint",
    "save_serving",
    "trace",
]
