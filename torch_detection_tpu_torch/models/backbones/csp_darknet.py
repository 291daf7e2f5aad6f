"""CSPDarknet, YOLOX's trunk.

Counterpart of ``torch_detection_tpu/models/backbones/csp_darknet.py``: a
Focus stem (the 2 x 2 space-to-depth of the image, channel order (p, q, c),
then a 3 x 3 ``ConvModule``), four stages of a 3 x 3 stride-2 conv
(``down{i}``) and a ``CSPLayer`` (``stage{i + 1}``), the last with the
``SPPBottleneck`` (``spp``) before its CSP layer and no shortcuts; every
conv a ``ConvModule`` with FrozenBN (float32) and SiLU. ``deepen_factor``
and ``widen_factor`` scale the base depths (3, 9, 9, 3) and widths
(64, 128, 256, 512, 1024) as the reference: ``max(round(d * f), 1)`` and
``max(round(w * f), 8)``.

``forward`` takes NHWC images and returns NHWC features at
``out_indices`` (stages 1 to 4), NCHW in channels_last memory inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule, max_pool_same
from .resnet import space_to_depth_2x2


class DarknetBottleneck(nn.Module):
    """1 x 1 to ``out_channels * expansion`` (``conv1``), 3 x 3 to
    ``out_channels`` (``conv2``), and the input added where ``shortcut``
    and the widths agree."""

    def __init__(self, in_channels: int, out_channels: int, shortcut: bool = True,
                 expansion: float = 0.5, norm_cfg: Optional[dict] = None, dtype=None,
                 device=None):
        super().__init__()
        hidden = int(out_channels * expansion)
        kw = dict(norm_cfg=norm_cfg, act="silu", dtype=dtype, device=device)
        self.conv1 = ConvModule(in_channels, hidden, 1, **kw)
        self.conv2 = ConvModule(hidden, out_channels, 3, padding=1, **kw)
        self.add = shortcut and in_channels == out_channels

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.add else y


class CSPLayer(nn.Module):
    """Cross-stage partial layer: two 1 x 1 branches (``main``, ``short``)
    to half width, ``main`` through ``num_blocks`` bottlenecks
    (``block{i}``), the concat ``[main, short]`` fused by a 1 x 1
    (``final``)."""

    def __init__(self, in_channels: int, out_channels: int, num_blocks: int = 1,
                 shortcut: bool = True, expansion: float = 0.5, norm_cfg: Optional[dict] = None,
                 dtype=None, device=None):
        super().__init__()
        hidden = int(out_channels * expansion)
        kw = dict(norm_cfg=norm_cfg, dtype=dtype, device=device)
        self.main = ConvModule(in_channels, hidden, 1, act="silu", **kw)
        self.short = ConvModule(in_channels, hidden, 1, act="silu", **kw)
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(f"block{i}", DarknetBottleneck(hidden, hidden, shortcut=shortcut,
                                                           expansion=1.0, **kw))
        self.final = ConvModule(2 * hidden, out_channels, 1, act="silu", **kw)

    def forward(self, x: Tensor) -> Tensor:
        main = self.main(x)
        for i in range(self.num_blocks):
            main = getattr(self, f"block{i}")(main)
        return self.final(torch.cat([main, self.short(x)], dim=1))


class SPPBottleneck(nn.Module):
    """1 x 1 to half width (``conv1``), its SAME max-pools of 5, 9 and 13
    at stride 1 (-inf padding of k // 2 a side) concatenated after it, a
    1 x 1 fuse (``conv2``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13), norm_cfg: Optional[dict] = None,
                 dtype=None, device=None):
        super().__init__()
        hidden = in_channels // 2
        kw = dict(norm_cfg=norm_cfg, act="silu", dtype=dtype, device=device)
        self.kernel_sizes = tuple(kernel_sizes)
        self.conv1 = ConvModule(in_channels, hidden, 1, **kw)
        self.conv2 = ConvModule(hidden * (len(self.kernel_sizes) + 1), out_channels, 1, **kw)

    def forward(self, x: Tensor) -> Tensor:
        y = self.conv1(x)
        return self.conv2(torch.cat([y] + [max_pool_same(y, k, 1) for k in self.kernel_sizes],
                                    dim=1))


@BACKBONES.register_module
class CSPDarknet(nn.Module):
    """Focus stem and four CSP stages; ``out_indices`` over stages 1 to 4,
    (2, 3, 4) giving C3, C4 and C5 at strides 8, 16 and 32."""

    def __init__(
        self,
        deepen_factor: float = 0.33,
        widen_factor: float = 0.5,
        out_indices: Sequence[int] = (2, 3, 4),
        norm_cfg: Optional[dict] = None,
        in_channels: int = 3,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        norm = dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}
        widths = [max(int(round(w * widen_factor)), 8) for w in (64, 128, 256, 512, 1024)]
        depths = [max(int(round(d * deepen_factor)), 1) for d in (3, 9, 9, 3)]
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        self.out_indices = tuple(out_indices)
        self.stem = ConvModule(4 * in_channels, widths[0], 3, padding=1, act="silu", **kw)
        for i in range(4):
            self.add_module(f"down{i}", ConvModule(widths[i], widths[i + 1], 3, stride=2,
                                                   padding=1, act="silu", **kw))
            if i == 3:
                self.spp = SPPBottleneck(widths[4], widths[4], **kw)
            self.add_module(f"stage{i + 1}", CSPLayer(widths[i + 1], widths[i + 1],
                                                      num_blocks=depths[i], shortcut=i != 3, **kw))
        self.out_channels = tuple(widths[i] for i in self.out_indices)

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:  # (B, H, W, 3), H and W even
        x = self.stem(space_to_depth_2x2(x).permute(0, 3, 1, 2))
        outs = []
        for i in range(4):
            x = getattr(self, f"down{i}")(x)
            if i == 3:
                x = self.spp(x)
            x = getattr(self, f"stage{i + 1}")(x)
            if i + 1 in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        return tuple(outs)
