"""Darknet-53, YOLOv3's trunk.

Counterpart of ``torch_detection_tpu/models/backbones/darknet.py``: a
3 x 3 stem (``conv1``) of ``base_channels``, then five stages, each a 3 x 3
stride-2 conv (``down{i}``) to ``base_channels * 2^(i + 1)`` and
``stages[i]`` residual ``DarkBlock``s (``stage{i}_block{j}``); every conv a
``ConvModule`` with FrozenBN (float32) and LeakyReLU of slope 0.1.
``stages`` and ``base_channels`` make the narrow builds the tests use.

``forward`` takes NHWC images and returns NHWC features at
``out_indices``, NCHW in channels_last memory inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule

# depth -> residual blocks a stage
ARCH_SETTINGS = {53: (1, 2, 8, 8, 4)}


class DarkBlock(nn.Module):
    """1 x 1 squeeze to half width (``conv1``), 3 x 3 back (``conv2``), and
    the identity added."""

    def __init__(self, channels: int, norm_cfg: Optional[dict] = None, dtype=None, device=None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg, act="leaky_relu", dtype=dtype, device=device)
        self.conv1 = ConvModule(channels, channels // 2, 1, **kw)
        self.conv2 = ConvModule(channels // 2, channels, 3, padding=1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.conv2(self.conv1(x))


@BACKBONES.register_module
class Darknet(nn.Module):
    """``out_indices`` are stage indices; YOLOv3 takes (2, 3, 4): 256 at
    stride 8, 512 at 16, 1024 at 32."""

    def __init__(
        self,
        depth: int = 53,
        out_indices: Sequence[int] = (2, 3, 4),
        stages: Optional[Sequence[int]] = None,
        base_channels: int = 32,
        norm_cfg: Optional[dict] = None,
        in_channels: int = 3,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        norm = dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}
        blocks = tuple(stages) if stages is not None else ARCH_SETTINGS[depth]
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        self.out_indices = tuple(out_indices)
        self.conv1 = ConvModule(in_channels, base_channels, 3, padding=1, act="leaky_relu", **kw)
        self.stages = []
        cin = base_channels
        for i, n_blocks in enumerate(blocks):
            width = base_channels * 2 ** (i + 1)
            self.add_module(f"down{i}", ConvModule(cin, width, 3, stride=2, padding=1,
                                                   act="leaky_relu", **kw))
            names = [f"down{i}"]
            for j in range(n_blocks):
                self.add_module(f"stage{i}_block{j}", DarkBlock(width, **kw))
                names.append(f"stage{i}_block{j}")
            self.stages.append(names)
            cin = width
        self.out_channels = tuple(base_channels * 2 ** (i + 1) for i in self.out_indices)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:  # (B, H, W, 3)
        x = self.conv1(x.permute(0, 3, 1, 2))
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
