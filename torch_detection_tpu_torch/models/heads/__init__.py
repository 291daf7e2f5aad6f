from .anchor_head import RetinaHead, flatten_head_outputs
from .atss_head import ATSSHead, PAAHead
from .bbox_head import BBoxHead
from .centernet_head import CenterNetHead
from .fcos_head import FCOSHead
from .fovea_head import FoveaHead
from .gfl_head import GFLHead
from .mask_head import FCNMaskHead, mask_loss, mask_targets_for_rois, paste_masks, paste_masks_np
from .rpn_head import ProposalConfig, Proposals, RPNHead, generate_proposals
from .solov2_head import MaskFeatHead, SOLOV2Head
from .ssd_head import SSDHead
from .yolo_head import YOLOV3Head
from .yolox_head import YOLOXHead

__all__ = ["ATSSHead", "BBoxHead", "CenterNetHead", "FCNMaskHead", "FCOSHead", "FoveaHead",
           "GFLHead", "MaskFeatHead", "PAAHead", "ProposalConfig", "Proposals", "RPNHead",
           "RetinaHead", "SOLOV2Head", "SSDHead",
           "YOLOV3Head", "YOLOXHead", "flatten_head_outputs",
           "generate_proposals", "mask_loss", "mask_targets_for_rois", "paste_masks",
           "paste_masks_np"]
