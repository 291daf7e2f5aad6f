from .anchor_head import RetinaHead, flatten_head_outputs
from .atss_head import ATSSHead, PAAHead
from .bbox_head import BBoxHead
from .fcos_head import FCOSHead
from .fovea_head import FoveaHead
from .gfl_head import GFLHead
from .mask_head import FCNMaskHead, mask_loss, mask_targets_for_rois, paste_masks, paste_masks_np
from .rpn_head import ProposalConfig, Proposals, RPNHead, generate_proposals

__all__ = ["ATSSHead", "BBoxHead", "FCNMaskHead", "FCOSHead", "FoveaHead", "GFLHead", "PAAHead",
           "ProposalConfig", "Proposals", "RPNHead", "RetinaHead", "flatten_head_outputs",
           "generate_proposals", "mask_loss", "mask_targets_for_rois", "paste_masks",
           "paste_masks_np"]
