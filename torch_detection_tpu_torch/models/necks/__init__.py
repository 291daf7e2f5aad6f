from .fpn import FPN
from .yolo_neck import DetectionBlock, YOLOV3Neck

__all__ = ["FPN", "DetectionBlock", "YOLOV3Neck"]
