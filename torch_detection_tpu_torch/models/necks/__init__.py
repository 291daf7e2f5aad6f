from .ct_neck import CTResNetNeck
from .fpn import FPN
from .yolo_neck import DetectionBlock, YOLOV3Neck
from .yolox_pafpn import YOLOXPAFPN

__all__ = ["CTResNetNeck", "FPN", "DetectionBlock", "YOLOV3Neck", "YOLOXPAFPN"]
