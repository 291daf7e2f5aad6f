from typing import Any, Dict

from torch import nn

from ...utils.registry import NECKS
from .ct_neck import CTResNetNeck
from .fpn import FPN, PAFPN
from .yolo_neck import DetectionBlock, YOLOV3Neck
from .yolox_pafpn import YOLOXPAFPN


def build_neck(cfg: Dict[str, Any], backbone: nn.Module, **kwargs) -> nn.Module:
    """The neck of ``cfg`` after ``backbone``. A neck whose ``in_channels``
    is a sequence, one width a level, takes the widths the backbone returns
    (``backbone.out_channels``) whatever the config says: flax infers a
    conv's input channels from its input, so the reference builds the neck
    for what the backbone gives (R13: the ShuffleNetV2 RetinaNet config
    names 464 for its 1024-channel last level)."""
    cfg = dict(cfg)
    if isinstance(cfg.get("in_channels"), (list, tuple)):
        cfg["in_channels"] = tuple(backbone.out_channels)
    return NECKS.build(cfg, **kwargs)


__all__ = ["CTResNetNeck", "FPN", "PAFPN", "DetectionBlock", "YOLOV3Neck", "YOLOXPAFPN",
           "build_neck"]
