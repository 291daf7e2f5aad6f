"""ResNet backbones (BasicBlock for depths 18/34, Bottleneck for 50/101/152),
and ResNeXt, SE-ResNet and SE-ResNeXt as the same module's options.

Counterpart of ``torch_detection_tpu/models/backbones/resnet.py``: the
'pytorch' style (stride on the 3x3 conv), FrozenBN, multi-scale
``out_indices``, per-stage ``strides`` and ``dilations``, ResNeXt's grouped
bottleneck of width ``int(planes * base_width / 64) * groups``, an
``SELayer`` after each block's last norm, and the same submodule names
(``stem``, ``layer{i}_{j}``, ``block{k}``, ``se``, ``downsample``), so the
reference's parameter tree converts by name; ``stem_s2d`` runs the stem on
the 2x2 space-to-depth wire.

``forward`` takes NHWC images and returns NHWC features, as the reference;
inside, tensors are NCHW in channels_last memory, so both permutes are
views.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule, SELayer, max_pool_same_torch


def space_to_depth_2x2(x: Tensor) -> Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, 4C), channel order (p, q, c): the wire
    of ``stem_s2d`` (``ops/preprocess.py::space_to_depth_2x2_np`` is the
    host's copy)."""
    b, h, w, c = x.shape
    if h % 2 or w % 2:
        raise ValueError(f"space-to-depth needs an even canvas, got {h} x {w}")
    x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h // 2, w // 2, 4 * c)


class FoldedStemConv(nn.Conv2d):
    """The 7x7 stride-2 stem conv evaluated on the space-to-depth wire.

    The parameter is the logical (64, cin, 7, 7) kernel, so conversion,
    initialisation (fan_in 7 * 7 * cin) and freezing treat it as the plain
    stem's. At use it is re-indexed into a 4x4 stride-1 kernel over the
    (p, q, c) channels: original tap (dy, dx) feeds folded tap (a, b) and
    channel (p, q, c) with dy = 2a + p - 1, dx = 2b + q - 1 (the a = 0,
    p = 0 row and column are zero), and padding (2, 1) on each axis gives
    the original window exactly; only the summation order differs."""

    def __init__(self, in_channels: int, out_channels: int = 64, dtype=None, device=None):
        super().__init__(in_channels, out_channels, 7, stride=2, padding=3, bias=False,
                         dtype=dtype, device=device)

    def forward(self, x: Tensor) -> Tensor:  # (B, 4 * cin, H/2, W/2)
        o, cin = self.weight.shape[:2]
        w8 = F.pad(self.weight, (1, 0, 1, 0))
        w44 = w8.reshape(o, cin, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(o, 4 * cin, 4, 4)
        # Conv2d pads symmetrically; F.pad keeps channels_last memory
        return F.conv2d(F.pad(x, (2, 1, 2, 1)), w44)


class BasicBlock(nn.Module):
    """3x3 + 3x3 residual block. expansion = 1."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 with_downsample: bool = False, with_se: bool = False, se_reduction: int = 16,
                 norm_cfg: Optional[dict] = None, dtype=None, device=None):
        super().__init__()
        norm = norm_cfg or {"type": "FrozenBN"}
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        self.block1 = ConvModule(inplanes, planes, 3, stride=stride, padding=dilation,
                                 dilation=dilation, act="relu", **kw)
        self.block2 = ConvModule(planes, planes, 3, padding=1, act=None, **kw)
        self.se = SELayer(planes, se_reduction, dtype=dtype, device=device) if with_se else None
        self.downsample = (
            ConvModule(inplanes, planes, 1, stride=stride, act=None, **kw)
            if with_downsample else None
        )

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.block2(self.block1(x))
        if self.se is not None:
            out = self.se(out)
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride, dilation, groups) -> 1x1 residual block.
    expansion = 4."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 groups: int = 1, base_width: int = 64, with_downsample: bool = False,
                 with_se: bool = False, se_reduction: int = 16, norm_cfg: Optional[dict] = None,
                 dtype=None, device=None):
        super().__init__()
        norm = norm_cfg or {"type": "FrozenBN"}
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        width = int(planes * (base_width / 64.0)) * groups
        out_channels = planes * self.expansion
        self.block1 = ConvModule(inplanes, width, 1, act="relu", **kw)
        self.block2 = ConvModule(width, width, 3, stride=stride, padding=dilation,
                                 dilation=dilation, groups=groups, act="relu", **kw)
        self.block3 = ConvModule(width, out_channels, 1, act=None, **kw)
        self.se = (SELayer(out_channels, se_reduction, dtype=dtype, device=device)
                   if with_se else None)
        self.downsample = (
            ConvModule(inplanes, out_channels, 1, stride=stride, act=None, **kw)
            if with_downsample else None
        )

    def forward(self, x: Tensor) -> Tensor:
        identity = x if self.downsample is None else self.downsample(x)
        out = self.block3(self.block2(self.block1(x)))
        if self.se is not None:
            out = self.se(out)
        return F.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module
class ResNet(nn.Module):
    """Multi-scale feature extractor: features at ``out_indices`` (C2..C5,
    strides 4/8/16/32 with the default ``strides``). ``groups`` and
    ``base_width`` widen the bottleneck's grouped 3x3 (ResNeXt), ``with_se``
    adds an ``SELayer`` to every block. ``frozen_stages`` freezes the stem
    and the first stages' parameters (``requires_grad=False``), the
    reference's cut."""

    def __init__(
        self,
        depth: int = 50,
        num_stages: int = 4,
        strides: Sequence[int] = (1, 2, 2, 2),
        dilations: Sequence[int] = (1, 1, 1, 1),
        out_indices: Sequence[int] = (0, 1, 2, 3),
        frozen_stages: int = -1,
        groups: int = 1,
        base_width: int = 64,
        with_se: bool = False,
        se_reduction: int = 16,
        norm_cfg: Optional[dict] = None,
        stem_s2d: bool = False,
        in_channels: int = 3,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f"unsupported ResNet depth {depth}")
        if not 1 <= num_stages <= 4 or max(out_indices) >= num_stages:
            raise ValueError(f"bad num_stages {num_stages} / out_indices {out_indices}")
        if len(strides) < num_stages or len(dilations) < num_stages:
            raise ValueError(f"{num_stages} stages need as many strides {strides} and dilations "
                             f"{dilations}")
        block_cls, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        # each output's channels, which flax infers at init and a consumer here needs
        self.out_channels = tuple(64 * 2**i * block_cls.expansion for i in self.out_indices)
        norm = norm_cfg or {"type": "FrozenBN"}

        self.stem = ConvModule(in_channels, 64, 7, stride=2, padding=3, norm_cfg=norm,
                               act="relu", dtype=dtype, device=device)
        self.stem_s2d = stem_s2d
        self.in_channels = in_channels
        if stem_s2d:  # the same parameters, the conv folded at use
            self.stem.conv = FoldedStemConv(in_channels, 64, dtype=dtype, device=device)
        grouped = dict(groups=groups, base_width=base_width) if block_cls is Bottleneck else {}
        self.stages = []
        inplanes = 64
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = 64 * 2**i
            names = []
            for j in range(num_blocks):
                block_stride = strides[i] if j == 0 else 1
                needs_down = j == 0 and (block_stride != 1 or inplanes != planes * block_cls.expansion)
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(
                    inplanes, planes, stride=block_stride, dilation=dilations[i],
                    with_downsample=needs_down, with_se=with_se, se_reduction=se_reduction,
                    norm_cfg=norm, dtype=dtype, device=device, **grouped,
                ))
                inplanes = planes * block_cls.expansion
                names.append(name)
            self.stages.append(names)

        frozen = [self.stem] + [getattr(self, n) for s in self.stages[:frozen_stages] for n in s]
        if frozen_stages >= 0:
            for module in frozen:
                module.requires_grad_(False)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:
        """(B, H, W, 3) -> NHWC features at ``out_indices``. With
        ``stem_s2d`` the input is the (B, H/2, W/2, 12) wire, or a plain
        image that is relaid here."""
        if self.stem_s2d and x.shape[-1] != 4 * self.in_channels:
            x = space_to_depth_2x2(x)
        x = self.stem(x.permute(0, 3, 1, 2))
        x = max_pool_same_torch(x, window=3, stride=2, padding=1)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)


@BACKBONES.register_module
class ResNeXt(ResNet):
    """ResNeXt: the grouped bottleneck, 32x4d unless told otherwise."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kwargs):
        super().__init__(groups=groups, base_width=base_width, **kwargs)


@BACKBONES.register_module
class SEResNet(ResNet):
    """SE-ResNet: squeeze-and-excitation after each block's last norm."""

    def __init__(self, with_se: bool = True, **kwargs):
        super().__init__(with_se=with_se, **kwargs)


@BACKBONES.register_module
class SEResNeXt(ResNeXt):
    """SE-ResNeXt: the grouped bottleneck with squeeze-and-excitation."""

    def __init__(self, with_se: bool = True, **kwargs):
        super().__init__(with_se=with_se, **kwargs)
