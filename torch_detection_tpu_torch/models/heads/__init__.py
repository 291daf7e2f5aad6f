from .anchor_head import RetinaHead, flatten_head_outputs
from .bbox_head import BBoxHead
from .mask_head import FCNMaskHead, mask_loss, mask_targets_for_rois, paste_masks, paste_masks_np
from .rpn_head import ProposalConfig, Proposals, RPNHead, generate_proposals

__all__ = ["BBoxHead", "FCNMaskHead", "ProposalConfig", "Proposals", "RPNHead", "RetinaHead",
           "flatten_head_outputs", "generate_proposals", "mask_loss", "mask_targets_for_rois",
           "paste_masks", "paste_masks_np"]
