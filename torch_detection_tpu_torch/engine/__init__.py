from .trainer import Trainer, detection_lr_schedule
from .validate import make_inference_fn

__all__ = ["Trainer", "detection_lr_schedule", "make_inference_fn"]
