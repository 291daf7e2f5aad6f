"""CenterNet's head: the centre heatmap, the size and the sub-pixel offset.

Counterpart of ``torch_detection_tpu/models/heads/centernet_head.py``: on
the single stride-4 map, three branches, each a biased 3 x 3 conv
(``{name}_feat``), a ReLU and a biased 1 x 1 projection (``{name}_out``):
``heatmap`` to C logits, ``wh`` and ``offset`` to 2 values. The seeded init
gives ``heatmap_out`` the 0.1 prior bias (``bias_init_with_prob``, about
-2.197) and every other bias 0. NHWC in and out.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ...utils.registry import HEADS
from ..inits import bias_init_with_prob

_BRANCHES = ("heatmap", "wh", "offset")


@HEADS.register_module
class CenterNetHead(nn.Module):
    """(B, H, W, C_in) -> heat (B, H, W, C) logits, wh (B, H, W, 2) and
    offset (B, H, W, 2)."""

    def __init__(
        self,
        num_classes: int = 80,
        in_channels: int = 64,
        feat_channels: int = 64,
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        for name, width in zip(_BRANCHES, (num_classes, 2, 2)):
            self.add_module(f"{name}_feat", nn.Conv2d(in_channels, feat_channels, 3, padding=1,
                                                      **kw))
            self.add_module(f"{name}_out", nn.Conv2d(feat_channels, width, 1, **kw))
        self.heatmap_out.init_bias = bias_init_with_prob(0.1)  # read by inits.init_weights

    def forward(self, feats: Sequence[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
        x = feats[0].permute(0, 3, 1, 2)
        return tuple(getattr(self, f"{name}_out")(F.relu(getattr(self, f"{name}_feat")(x)))
                     .permute(0, 2, 3, 1) for name in _BRANCHES)
