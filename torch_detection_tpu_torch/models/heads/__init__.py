from .bbox_head import BBoxHead
from .rpn_head import ProposalConfig, Proposals, RPNHead, generate_proposals

__all__ = ["BBoxHead", "ProposalConfig", "Proposals", "RPNHead", "generate_proposals"]
