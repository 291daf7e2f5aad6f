"""Seeded weight initialisation.

The reference's heads and backbone take flax's defaults: ``lecun_normal``
kernels (truncated normal, variance 1 / fan_in) and zero biases, FrozenBN
at the identity. ``init_weights`` gives a port model the same
distributions from a ``torch.Generator``. The values are drawn on the CPU
and copied, so one seed gives the same weights on every device. ``fan_in``
is the kernel's input channels times its window, for a transposed conv too
(flax's ``ConvTranspose`` kernel is (kh, kw, in, out), torch's weight
(in, out, kh, kw)).

A conv that the reference initialises otherwise carries its rule as
attributes: ``init_std`` for a plain normal kernel of that std (flax's
``normal``, not truncated) and ``init_bias`` for a constant bias, as the
RetinaNet head's output convs (``bias_init_with_prob`` for the focal-loss
prior), or a vector of one bias a channel, as YOLOv3's ``pred{l}`` (the
prior on each objectness channel). SSD's ``L2Norm`` starts at its
``init_scale`` (``init_own``). LayerNorm and GroupNorm start at the identity. The FCOS, ATSS and
GFL heads take flax's defaults but for ``cls_out``'s prior bias, and their
``scales`` start at 1 (``init_own``). A module with parameters of its
own that none of these rules covers (Sparse R-CNN's proposal slate) draws
them in its ``init_own(generator)``.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor, nn

from .layers import FrozenBatchNorm, GroupNorm, LayerNorm

# std of a standard normal truncated to [-2, 2], as flax's truncated normal
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(param: Tensor, fan_in: int, generator: torch.Generator) -> Tensor:
    """Fill ``param`` from a normal of variance 1 / fan_in truncated at two
    standard deviations."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    values = torch.empty(param.shape, dtype=torch.float32)
    nn.init.trunc_normal_(values, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)
    with torch.no_grad():
        param.copy_(values)
    return param


def normal_(param: Tensor, std: float, generator: torch.Generator) -> Tensor:
    """Fill ``param`` from a normal of standard deviation ``std``."""
    values = torch.randn(param.shape, dtype=torch.float32, generator=generator) * std
    with torch.no_grad():
        param.copy_(values)
    return param


def bias_init_with_prob(prior_prob: float) -> float:
    """The bias whose sigmoid is ``prior_prob`` (the focal-loss prior)."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded reference-default weights for every conv, transposed conv,
    linear, FrozenBN, LayerNorm and GroupNorm, a module's own ``init_std``/``init_bias``
    and its ``init_own``."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                weight = module.weight
                if hasattr(module, "init_std"):
                    normal_(weight, module.init_std, generator)
                else:
                    # one output's inputs: weight[0], but (in, out, kh, kw) for a transposed conv
                    fan_in = weight[:, 0] if isinstance(module, nn.ConvTranspose2d) else weight[0]
                    lecun_normal_(weight, fan_in.numel(), generator)
                if module.bias is not None:
                    # a float for every channel, or a vector of each channel's
                    module.bias.copy_(torch.as_tensor(getattr(module, "init_bias", 0.0),
                                                      dtype=torch.float32))
            elif isinstance(module, FrozenBatchNorm):
                module.scale.fill_(1.0)
                module.bias.zero_()
                module.mean.zero_()
                module.var.fill_(1.0)
            elif isinstance(module, (LayerNorm, GroupNorm)):
                module.scale.fill_(1.0)
                module.bias.zero_()
            if hasattr(module, "init_own"):
                module.init_own(generator)
    return model
