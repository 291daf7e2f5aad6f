"""ShuffleNet v1 and v2 backbones.

Counterpart of ``torch_detection_tpu/models/backbones/shufflenet.py``:

* v1: a grouped 1x1 (not grouped in stage 2's first block), the channel
  shuffle, a 3x3 depthwise conv without an activation, a grouped 1x1; a
  stride-2 block concatenates ``avg_pool_torch(x, 3, 2, 1)`` before its
  branch, a stride-1 block adds its input; ``SHUFFLENET_SETTINGS`` by group
  count;
* v2: a stride-1 block splits its channels and transforms the right half, a
  stride-2 block feeds the whole input to both branches; the halves are
  concatenated and shuffled; ``with_last_conv`` runs ``conv5`` (1x1 to
  1024, or 2048 at 2.0x) on the last stage, so the last output has its
  channels, whatever a config's neck says (R13);
  ``SHUFFLENETV2_SETTINGS`` by width.

Both stems are a 3x3 stride-2 conv to 24 and a 3x3 stride-2 max-pool.
Submodules are named as the reference's flax modules (``stem``,
``stage{i + 2}_{j}``, ``conv1``-``conv3``, ``left_dw``, ``left_pw``,
``right_pw1``, ``right_dw``, ``right_pw2``, ``conv5``). NHWC in and out;
NCHW channels_last inside.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule, avg_pool_torch, channel_shuffle, channel_split, max_pool_same_torch
from .mobilenet import StagedBackbone

SHUFFLENET_SETTINGS = {
    1: ((144, 288, 576), (4, 8, 4)),
    2: ((200, 400, 800), (4, 8, 4)),
    3: ((240, 480, 960), (4, 8, 4)),
    4: ((272, 544, 1088), (4, 8, 4)),
    8: ((384, 768, 1536), (4, 8, 4)),
}

SHUFFLENETV2_SETTINGS = {
    0.5: ((48, 96, 192, 1024), (4, 8, 4)),
    1.0: ((116, 232, 464, 1024), (4, 8, 4)),
    1.5: ((176, 352, 704, 1024), (4, 8, 4)),
    2.0: ((244, 488, 976, 2048), (4, 8, 4)),
}


class ShuffleBottleneck(nn.Module):
    """v1's block: grouped 1x1 (ReLU) -> shuffle -> 3x3 depthwise -> grouped
    1x1; a stride-2 block concatenates the average-pooled input before it
    (so its branch makes ``outplanes - inplanes`` channels), a stride-1
    block adds the input; then ReLU."""

    expansion = 4

    def __init__(self, inplanes: int, outplanes: int, groups: int, first_group: bool = True,
                 stride: int = 1, dilation: int = 1, norm_cfg: Optional[dict] = None,
                 dtype=None, device=None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg or {"type": "FrozenBN"}, dtype=dtype, device=device)
        planes = outplanes // self.expansion
        out_ch = outplanes - inplanes if stride == 2 else outplanes
        self.g1 = groups if first_group else 1
        self.stride = stride
        self.conv1 = ConvModule(inplanes, planes, 1, groups=self.g1, act="relu", **kw)
        self.conv2 = ConvModule(planes, planes, 3, stride=stride, padding=dilation,
                                dilation=dilation, groups=planes, act=None, **kw)
        self.conv3 = ConvModule(planes, out_ch, 1, groups=groups, act=None, **kw)

    def forward(self, x: Tensor) -> Tensor:
        out = self.conv1(x)
        if self.g1 > 1:
            out = channel_shuffle(out, self.g1)
        out = self.conv3(self.conv2(out))
        if self.stride == 2:
            out = torch.cat([avg_pool_torch(x, 3, 2, 1), out], dim=1)
        else:
            out = out + x
        return F.relu(out)


class _PooledStem(StagedBackbone):
    """ShuffleNet's stem: the conv, then a 3x3 stride-2 max-pool."""

    def _trunk(self, x: Tensor) -> Tensor:
        return max_pool_same_torch(self.stem(x), window=3, stride=2, padding=1)


@BACKBONES.register_module
class ShuffleNet(_PooledStem):
    """ShuffleNet v1 with ``groups`` groups: three stages of
    ``ShuffleBottleneck``."""

    def __init__(
        self,
        groups: int = 3,
        num_stages: int = 3,
        strides: Sequence[int] = (2, 2, 2),
        dilations: Sequence[int] = (1, 1, 1),
        out_indices: Sequence[int] = (0, 1, 2),
        frozen_stages: int = -1,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if groups not in SHUFFLENET_SETTINGS:
            raise KeyError(f"unsupported groups {groups}")
        planes_of, blocks_of = (t[:num_stages] for t in SHUFFLENET_SETTINGS[groups])
        if max(out_indices) >= num_stages:
            raise ValueError(f"bad num_stages {num_stages} / out_indices {out_indices}")
        self.out_indices = tuple(out_indices)
        self.out_channels = tuple(planes_of[i] for i in self.out_indices)
        kw = dict(norm_cfg=norm_cfg or {"type": "FrozenBN"}, dtype=dtype, device=device)
        self.stem = ConvModule(3, 24, 3, stride=2, padding=1, act="relu", **kw)
        self.stages, self.tails = [], {}
        inplanes = 24
        for i, (planes, blocks) in enumerate(zip(planes_of, blocks_of)):
            names = [f"stage{i + 2}_{j}" for j in range(blocks)]
            for j, name in enumerate(names):
                self.add_module(name, ShuffleBottleneck(
                    inplanes, planes, groups, first_group=not (i == 0 and j == 0),
                    stride=strides[i] if j == 0 else 1, dilation=dilations[i], **kw))
                inplanes = planes
            self.stages.append(names)
        self._freeze(frozen_stages)


class ShuffleV2Block(nn.Module):
    """v2's block. Stride 1: the channels split in two, the right half
    through 1x1 (ReLU) -> 3x3 depthwise -> 1x1 (ReLU). Stride 2: the whole
    input through both branches, the left one 3x3 depthwise -> 1x1 (ReLU).
    The halves concatenated (left first), then shuffled in two groups."""

    def __init__(self, inplanes: int, outplanes: int, stride: int = 1, dilation: int = 1,
                 norm_cfg: Optional[dict] = None, dtype=None, device=None):
        super().__init__()
        kw = dict(norm_cfg=norm_cfg or {"type": "FrozenBN"}, dtype=dtype, device=device)
        half = outplanes // 2
        self.stride = stride
        right_in = inplanes // 2 if stride == 1 else inplanes
        if stride != 1:
            self.left_dw = ConvModule(inplanes, inplanes, 3, stride=2, padding=dilation,
                                      dilation=dilation, groups=inplanes, act=None, **kw)
            self.left_pw = ConvModule(inplanes, half, 1, act="relu", **kw)
        self.right_pw1 = ConvModule(right_in, half, 1, act="relu", **kw)
        self.right_dw = ConvModule(half, half, 3, stride=stride, padding=dilation,
                                   dilation=dilation, groups=half, act=None, **kw)
        self.right_pw2 = ConvModule(half, half, 1, act="relu", **kw)

    def forward(self, x: Tensor) -> Tensor:
        if self.stride == 1:
            left, right = channel_split(x, 2)
        else:
            left, right = self.left_pw(self.left_dw(x)), x
        right = self.right_pw2(self.right_dw(self.right_pw1(right)))
        return channel_shuffle(torch.cat([left, right], dim=1), 2)


@BACKBONES.register_module
class ShuffleNetV2(_PooledStem):
    """ShuffleNet v2 at ``width_mult``: three stages of ``ShuffleV2Block``;
    ``with_last_conv`` ends the last stage with ``conv5``, inside its
    ``frozen_stages`` cut as in the reference."""

    def __init__(
        self,
        width_mult: float = 1.0,
        num_stages: int = 3,
        strides: Sequence[int] = (2, 2, 2),
        dilations: Sequence[int] = (1, 1, 1),
        out_indices: Sequence[int] = (0, 1, 2),
        frozen_stages: int = -1,
        with_last_conv: bool = True,
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        if width_mult not in SHUFFLENETV2_SETTINGS:
            raise KeyError(f"unsupported width_mult {width_mult}")
        channels, blocks_of = SHUFFLENETV2_SETTINGS[width_mult]
        planes_of, blocks_of = channels[:num_stages], blocks_of[:num_stages]
        if max(out_indices) >= num_stages:
            raise ValueError(f"bad num_stages {num_stages} / out_indices {out_indices}")
        self.out_indices = tuple(out_indices)
        kw = dict(norm_cfg=norm_cfg or {"type": "FrozenBN"}, dtype=dtype, device=device)
        self.stem = ConvModule(3, 24, 3, stride=2, padding=1, act="relu", **kw)
        self.stages, self.tails = [], {}
        inplanes = 24
        for i, (planes, blocks) in enumerate(zip(planes_of, blocks_of)):
            names = [f"stage{i + 2}_{j}" for j in range(blocks)]
            for j, name in enumerate(names):
                self.add_module(name, ShuffleV2Block(
                    inplanes, planes, stride=strides[i] if j == 0 else 1,
                    dilation=dilations[i], **kw))
                inplanes = planes
            self.stages.append(names)
        widths = list(planes_of)
        if with_last_conv:
            self.conv5 = ConvModule(inplanes, channels[-1], 1, act="relu", **kw)
            self.tails[num_stages - 1] = "conv5"
            widths[-1] = channels[-1]
        self.out_channels = tuple(widths[i] for i in self.out_indices)
        self._freeze(frozen_stages)
        if with_last_conv and frozen_stages >= num_stages:
            self.conv5.requires_grad_(False)
