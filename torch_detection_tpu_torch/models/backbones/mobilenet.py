"""MobileNet v1 and v2 backbones.

Counterpart of ``torch_detection_tpu/models/backbones/mobilenet.py``: v1's
depthwise-separable blocks under the width table ``MOBILENET_SETTINGS`` and
its stem of ``round(32 * width_multi)`` channels; v2's inverted residuals
(ReLU6, a linear projection) under ``MOBILENETV2_SETTINGS``, the residual
added iff the stride is 1 and the channels match (the reference's fixed
rule), and the optional 1x1 to 1280 on the last output (``with_last_conv``).
Submodules are named as the reference's flax modules (``stem``,
``layer{i}_{j}``, ``dw``, ``pw``, ``expand``, ``project``, ``last_conv``),
so its parameter tree converts by name. A depthwise conv is an
``nn.Conv2d`` with ``groups`` equal to its channels.

``forward`` takes NHWC images and returns NHWC features; inside, tensors
are NCHW in channels_last memory. ``frozen_stages`` freezes the stem and
the first stages' parameters (``requires_grad=False``), where the
reference stops the gradient.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule

MOBILENET_SETTINGS = {
    0.25: ((16, 32, 64, 128, 256), (1, 2, 2, 6, 2)),
    0.5: ((32, 64, 128, 256, 512), (1, 2, 2, 6, 2)),
    0.75: ((48, 96, 172, 384, 768), (1, 2, 2, 6, 2)),
    1.0: ((64, 128, 256, 512, 1024), (1, 2, 2, 6, 2)),
}

# (expansion, out_planes, num_blocks, stride, dilation)
MOBILENETV2_SETTINGS = (
    (1, 16, 1, 1, 1),
    (6, 24, 2, 2, 1),
    (6, 32, 3, 2, 1),
    (6, 64, 4, 2, 1),
    (6, 96, 3, 1, 1),
    (6, 160, 3, 2, 1),
    (6, 320, 1, 1, 1),
)


class DepthwiseSeparable(nn.Module):
    """3x3 depthwise (norm, act) -> 1x1 pointwise (norm, act)."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 norm_cfg: Optional[dict] = None, act: str = "relu", dtype=None, device=None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg or {"type": "FrozenBN"}, act=act, dtype=dtype, device=device)
        self.dw = ConvModule(inplanes, inplanes, 3, stride=stride, padding=dilation,
                             dilation=dilation, groups=inplanes, **kw)
        self.pw = ConvModule(inplanes, planes, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        return self.pw(self.dw(x))


class StagedBackbone(nn.Module):
    """A stem (``_trunk``), then ``stages``, lists of block names; NHWC in,
    the NHWC outputs of the stages at ``out_indices``. Stage ``i``'s output
    passes the module named ``tails[i]``, where there is one, before it is
    taken. ``_freeze(k)`` freezes the stem and the first ``k`` stages'
    blocks."""

    stages: List[List[str]]
    tails: Dict[int, str]

    def _freeze(self, frozen_stages: int) -> None:
        if frozen_stages >= 0:
            for module in [self.stem] + [getattr(self, n) for s in self.stages[:frozen_stages]
                                         for n in s]:
                module.requires_grad_(False)

    def _trunk(self, x: Tensor) -> Tensor:
        return self.stem(x)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        """(B, H, W, 3) -> NHWC features at ``out_indices``."""
        x = self._trunk(x.permute(0, 3, 1, 2))
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.tails:
                x = getattr(self, self.tails[i])(x)
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


@BACKBONES.register_module
class MobileNet(StagedBackbone):
    """MobileNet v1: a 3x3 stride-2 stem and five stages of
    depthwise-separable blocks."""

    def __init__(
        self,
        width_multi: float = 1.0,
        num_stages: int = 5,
        strides: Sequence[int] = (1, 2, 2, 2, 2),
        dilations: Sequence[int] = (1, 1, 1, 1, 1),
        out_indices: Sequence[int] = (0, 1, 2, 3, 4),
        frozen_stages: int = -1,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if width_multi not in MOBILENET_SETTINGS:
            raise KeyError(f"unsupported width_multi {width_multi}")
        planes_of, blocks_of = (t[:num_stages] for t in MOBILENET_SETTINGS[width_multi])
        if max(out_indices) >= num_stages:
            raise ValueError(f"bad num_stages {num_stages} / out_indices {out_indices}")
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(planes_of[i] for i in self.out_indices)
        norm = norm_cfg or {"type": "FrozenBN"}
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        inplanes = round(32 * width_multi)
        self.stem = ConvModule(3, inplanes, 3, stride=2, padding=1, act="relu", **kw)
        self.stages, self.tails = [], {}
        for i, (planes, blocks) in enumerate(zip(planes_of, blocks_of)):
            names = [f"layer{i + 1}_{j}" for j in range(blocks)]
            for j, name in enumerate(names):
                self.add_module(name, DepthwiseSeparable(
                    inplanes, planes, stride=strides[i] if j == 0 else 1,
                    dilation=dilations[i], **kw))
                inplanes = planes
            self.stages.append(names)
        self._freeze(frozen_stages)


class InvertedResidual(nn.Module):
    """MobileNet v2's block: 1x1 expand (ReLU6; none at expansion 1) -> 3x3
    depthwise (ReLU6) -> 1x1 linear projection, plus the input iff the
    stride is 1 and the channels match."""

    def __init__(self, inplanes: int, planes: int, expansion: int = 6, stride: int = 1,
                 dilation: int = 1, norm_cfg: Optional[dict] = None, dtype=None, device=None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg or {"type": "FrozenBN"}, dtype=dtype, device=device)
        hidden = inplanes * expansion
        self.expand = (ConvModule(inplanes, hidden, 1, act="relu6", **kw)
                       if expansion != 1 else None)
        self.dw = ConvModule(hidden, hidden, 3, stride=stride, padding=dilation,
                             dilation=dilation, groups=hidden, act="relu6", **kw)
        self.project = ConvModule(hidden, planes, 1, act=None, **kw)
        self.residual = stride == 1 and inplanes == planes

    def forward(self, x: Tensor) -> Tensor:
        out = x if self.expand is None else self.expand(x)
        out = self.project(self.dw(out))
        return out + x if self.residual else out


@BACKBONES.register_module
class MobileNetV2(StagedBackbone):
    """MobileNet v2: a 3x3 stride-2 stem (ReLU6) and seven stages of
    inverted residuals; ``with_last_conv`` appends a 1x1 to 1280 (ReLU6) to
    the last stage's output where it is taken. The stop-gradient of
    ``frozen_stages`` sits before it, so it is never frozen."""

    def __init__(
        self,
        num_stages: int = 7,
        out_indices: Sequence[int] = (0, 1, 2, 3, 4, 5, 6),
        frozen_stages: int = -1,
        with_last_conv: bool = False,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if not 1 <= num_stages <= 7 or max(out_indices) >= num_stages:
            raise ValueError(f"bad num_stages {num_stages} / out_indices {out_indices}")
        self.out_indices = tuple(out_indices)
        self.with_last_conv = with_last_conv
        norm = norm_cfg or {"type": "FrozenBN"}
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        self.stem = ConvModule(3, 32, 3, stride=2, padding=1, act="relu6", **kw)
        self.stages, self.tails = [], {}
        inplanes = 32
        settings = MOBILENETV2_SETTINGS[:num_stages]
        for i, (expansion, planes, blocks, stride, dilation) in enumerate(settings):
            names = [f"layer{i + 1}_{j}" for j in range(blocks)]
            for j, name in enumerate(names):
                self.add_module(name, InvertedResidual(
                    inplanes, planes, expansion=expansion, stride=stride if j == 0 else 1,
                    dilation=dilation, **kw))
                inplanes = planes
            self.stages.append(names)
        last = num_stages - 1
        if with_last_conv and last in self.out_indices:
            self.last_conv = ConvModule(inplanes, 1280, 1, act="relu6", **kw)
            self.tails[last] = "last_conv"
        self.out_channels = tuple(1280 if i in self.tails else settings[i][1]
                                  for i in self.out_indices)
        self._freeze(frozen_stages)
