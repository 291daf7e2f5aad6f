"""VGG backbone.

Counterpart of ``torch_detection_tpu/models/backbones/vgg.py``: depths
11/13/16/19, each stage a stack of 3x3 ``ConvModule``s (biased, ReLU,
optionally normed) then a 2x2 stride-2 max-pool, per-stage stride and
dilation, multi-scale ``out_indices``. Stage i is min(64 * 2^i, 512) wide
(64/128/256/512/512), the correct VGG widths the reference uses. Convs are
named ``layer{s}_{j}``, the names ``models/torch_import.py::vgg_key_rules``
maps torchvision's ``features.{k}`` onto.

``forward`` takes NHWC images and returns NHWC features, NCHW in
channels_last memory inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule, max_pool_same_torch

ARCH_SETTINGS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}


@BACKBONES.register_module
class VGG(nn.Module):
    """``frozen_stages`` freezes the first stages' parameters
    (``requires_grad=False``), which also stops the gradient there, as the
    reference's ``stop_gradient`` after them."""

    def __init__(
        self,
        depth: int = 16,
        num_stages: int = 5,
        strides: Sequence[int] = (1, 1, 1, 1, 1),
        dilations: Sequence[int] = (1, 1, 1, 1, 1),
        out_indices: Sequence[int] = (0, 1, 2, 3, 4),
        frozen_stages: int = -1,
        norm_cfg: Optional[dict] = None,
        with_final_maxpool: bool = True,
        in_channels: int = 3,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"unsupported VGG depth {depth}")
        if not 1 <= num_stages <= 5 or len(strides) < num_stages or max(out_indices) >= num_stages:
            raise ValueError(f"bad num_stages {num_stages} / strides {strides} / out_indices "
                             f"{out_indices}")
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.with_final_maxpool = with_final_maxpool
        self.stages = []
        cin = in_channels
        for i, num_blocks in enumerate(ARCH_SETTINGS[depth][:num_stages]):
            planes = min(64 * 2**i, 512)
            names = []
            for j in range(num_blocks):
                name = f"layer{i + 1}_{j}"
                self.add_module(name, ConvModule(
                    cin, planes, 3, stride=strides[i] if j == 0 else 1, padding=dilations[i],
                    dilation=dilations[i], norm_cfg=norm_cfg, use_bias=True, act="relu",
                    dtype=dtype, device=device))
                cin = planes
                names.append(name)
            self.stages.append(names)
        self.out_channels = tuple(min(64 * 2**i, 512) for i in self.out_indices)
        for names in self.stages[:max(frozen_stages, 0)]:
            for name in names:
                getattr(self, name).requires_grad_(False)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:  # (B, H, W, 3)
        x = x.permute(0, 3, 1, 2)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if self.with_final_maxpool or i < len(self.stages) - 1:
                x = max_pool_same_torch(x, window=2, stride=2, padding=0)
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
