"""YOLOv3's neck: top-down detection blocks fused by upsample and concat.

Counterpart of ``torch_detection_tpu/models/necks/yolo_neck.py``: a
5-conv ``DetectionBlock`` (``detect1``) on the coarsest map, then for each
finer map a 1 x 1 reduce (``reduce{i}``), a nearest 2x upsample, the
concat ``[upsampled, finer]`` on the channel axis (the order decides which
input channels each converted kernel sees) and another block
(``detect{i + 1}``). Outputs coarse to fine (strides 32, 16, 8). NHWC in
and out; NCHW channels_last inside.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import Tensor, nn

from ...utils.registry import NECKS
from ..layers import ConvModule, resize_nearest_2x


class DetectionBlock(nn.Module):
    """1x1 c, 3x3 2c, 1x1 c, 3x3 2c, 1x1 c (``conv1`` to ``conv5``), each
    with its norm and LeakyReLU."""

    def __init__(self, in_channels: int, out_channels: int, norm_cfg: Optional[dict] = None,
                 dtype=None, device=None):
        super().__init__()
        c = out_channels
        cin = in_channels
        for i, (width, k) in enumerate(((c, 1), (2 * c, 3), (c, 1), (2 * c, 3), (c, 1))):
            self.add_module(f"conv{i + 1}", ConvModule(cin, width, k, padding=k // 2,
                                                       norm_cfg=norm_cfg, act="leaky_relu",
                                                       dtype=dtype, device=device))
            cin = width

    def forward(self, x: Tensor) -> Tensor:
        for i in range(5):
            x = getattr(self, f"conv{i + 1}")(x)
        return x


@NECKS.register_module
class YOLOV3Neck(nn.Module):
    """Backbone maps fine to coarse (C3, C4, C5) in, (P5, P4, P3) out."""

    def __init__(
        self,
        in_channels: Sequence[int] = (256, 512, 1024),  # fine -> coarse
        out_channels: Sequence[int] = (512, 256, 128),  # coarse -> fine
        norm_cfg: Optional[dict] = None,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.in_channels = tuple(in_channels)
        norm = dict(norm_cfg) if norm_cfg else {"type": "FrozenBN"}
        kw = dict(norm_cfg=norm, dtype=dtype, device=device)
        coarse_first = self.in_channels[::-1]
        self.detect1 = DetectionBlock(coarse_first[0], out_channels[0], **kw)
        for i, finer in enumerate(coarse_first[1:]):
            c = out_channels[i + 1]
            self.add_module(f"reduce{i + 1}", ConvModule(out_channels[i], c, 1,
                                                         act="leaky_relu", **kw))
            self.add_module(f"detect{i + 2}", DetectionBlock(c + finer, c, **kw))

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor, ...]:
        if len(feats) != len(self.in_channels):
            raise ValueError(f"{len(feats)} inputs for {len(self.in_channels)} levels")
        inputs = [f.permute(0, 3, 1, 2) for f in feats][::-1]  # (C5, C4, C3)
        x = self.detect1(inputs[0])
        outs = [x]
        for i, finer in enumerate(inputs[1:]):
            y = resize_nearest_2x(getattr(self, f"reduce{i + 1}")(x))
            x = getattr(self, f"detect{i + 2}")(torch.cat([y, finer], dim=1))
            outs.append(x)
        return tuple(o.permute(0, 2, 3, 1) for o in outs)
