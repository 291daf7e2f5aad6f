from . import backbones, detectors, heads, necks
from .convert import from_jax_variables
from .inits import init_weights
from .layers import ConvModule, FrozenBatchNorm

__all__ = [
    "backbones", "detectors", "heads", "necks", "from_jax_variables", "init_weights",
    "ConvModule", "FrozenBatchNorm",
]
