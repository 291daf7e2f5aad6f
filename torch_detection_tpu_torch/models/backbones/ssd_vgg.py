"""SSD's VGG16 trunk: VGG16 with SSD's extra feature layers.

Counterpart of ``torch_detection_tpu/models/backbones/ssd_vgg.py``:

* VGG16 conv1_1 to conv5_3 (``layer{s}_{j}``), biased convs with ReLU, the
  2 x 2 stride-2 pools with flax's SAME padding (the 300 canvas takes
  300/150/75/38/19), the learnable ``L2Norm`` (init 20) on conv4_3;
* pool5 3 x 3 stride 1, ``conv6`` 3 x 3 with dilation 6 to 1024 and
  ``conv7`` 1 x 1 to 1024;
* the extra blocks ``conv{n}_1`` (1 x 1 bottleneck) and ``conv{n}_2``: for
  the 300 canvas conv8 and conv9 stride 2, conv10 and conv11 unpadded
  (six maps, 38/19/10/5/3/1); for 512 conv8 to conv11 stride 2 and the
  4 x 4 conv12 with pad 1 (seven maps, 64/32/16/8/4/2/1).

``forward`` takes NHWC images and returns NHWC maps, NCHW in channels_last
memory inside.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import BACKBONES
from ..layers import ConvModule, max_pool_same

# (bottleneck, out, kernel, stride, pad) of each extra block, by canvas
EXTRAS = {
    300: ((256, 512, 3, 2, 1), (128, 256, 3, 2, 1), (128, 256, 3, 1, 0), (128, 256, 3, 1, 0)),
    512: ((256, 512, 3, 2, 1), (128, 256, 3, 2, 1), (128, 256, 3, 2, 1), (128, 256, 3, 2, 1),
          (128, 256, 4, 1, 1)),
}
VGG16_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class L2Norm(nn.Module):
    """Channel-wise L2 normalisation with a learnable per-channel ``scale``
    (init ``init_scale``), computed in float32 with autocast off, eps added
    after the square root, the result cast back to the input's dtype. The
    scale stays float32 in every build, as the reference's parameter."""

    def __init__(self, channels: int, init_scale: float = 20.0, eps: float = 1e-10, device=None):
        super().__init__()
        self.init_scale, self.eps = init_scale, eps
        self.scale = nn.Parameter(torch.full((channels,), float(init_scale), dtype=torch.float32,
                                             device=device))

    def init_own(self, generator: torch.Generator) -> None:
        self.scale.fill_(self.init_scale)

    def forward(self, x: Tensor) -> Tensor:  # (B, C, H, W)
        with torch.autocast(x.device.type, enabled=False):
            xf = x.float()
            norm = torch.sqrt((xf * xf).sum(dim=1, keepdim=True)) + self.eps
            return (xf / norm * self.scale[:, None, None]).to(x.dtype)


@BACKBONES.register_module
class SSDVGG(nn.Module):
    def __init__(self, depth: int = 16, input_size: int = 300, l2_norm_scale: float = 20.0,
                 in_channels: int = 3, dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if depth != 16:
            raise ValueError(f"SSDVGG is the VGG16 trunk, not depth {depth}")
        if input_size not in EXTRAS:
            raise ValueError(f"SSDVGG input_size must be 300 or 512, got {input_size}")
        kw = dict(use_bias=True, act="relu", dtype=dtype, device=device)
        cin = in_channels
        for s, (blocks, width) in enumerate(VGG16_STAGES):
            for j in range(blocks):
                self.add_module(f"layer{s + 1}_{j}", ConvModule(cin, width, 3, padding=1, **kw))
                cin = width
        self.l2_norm = L2Norm(512, l2_norm_scale, device=device)
        self.conv6 = ConvModule(512, 1024, 3, padding=6, dilation=6, **kw)
        self.conv7 = ConvModule(1024, 1024, 1, **kw)
        self.extras = []
        cin = 1024
        for i, (mid, width, k, stride, pad) in enumerate(EXTRAS[input_size]):
            n = 8 + i
            self.add_module(f"conv{n}_1", ConvModule(cin, mid, 1, **kw))
            self.add_module(f"conv{n}_2", ConvModule(mid, width, k, stride=stride, padding=pad,
                                                     **kw))
            self.extras.append((f"conv{n}_1", f"conv{n}_2"))
            cin = width
        self.out_channels = (512, 1024) + tuple(e[1] for e in EXTRAS[input_size])

    def forward(self, x: Tensor) -> Tuple[Tensor, ...]:  # (B, H, W, 3)
        x = x.permute(0, 3, 1, 2)
        outs = []
        for s, (blocks, _) in enumerate(VGG16_STAGES):
            for j in range(blocks):
                x = getattr(self, f"layer{s + 1}_{j}")(x)
            if s == 3:
                outs.append(self.l2_norm(x))
            x = max_pool_same(x, 3, 1) if s == 4 else max_pool_same(x, 2, 2)
        x = self.conv7(self.conv6(x))
        outs.append(x)
        for first, second in self.extras:
            x = getattr(self, second)(getattr(self, first)(x))
            outs.append(x)
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
