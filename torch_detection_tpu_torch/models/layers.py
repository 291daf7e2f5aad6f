"""Shared model building blocks.

Counterpart of ``torch_detection_tpu/models/layers.py``, cut to what the
Faster R-CNN slice runs. These blocks take NCHW tensors, PyTorch's
convention; the detector keeps them in ``torch.channels_last`` memory, so a
``permute(0, 2, 3, 1)`` gives the reference's NHWC layout without a copy.

Parameters are created in ``dtype`` (the compute dtype, as the reference's
flax ``dtype`` attribute), except FrozenBN's, which stay float32: the fold
into ``x * k + b`` is computed in float32 and cast at use, as the reference
computes it from its float32 params.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn


def compute_autocast(x: Tensor, dtype: torch.dtype, param_dtype: torch.dtype):
    """``torch.autocast`` to the compute ``dtype`` where the parameters are
    kept in another ``param_dtype`` (as flax's ``param_dtype``: each conv and
    linear weight is cast at its use, the parameters and their gradients
    stay in ``param_dtype``); no context where the two are equal."""
    if param_dtype == dtype:
        return contextlib.nullcontext()
    return torch.autocast(x.device.type, dtype=dtype)


class FrozenBatchNorm(nn.Module):
    """BatchNorm on stored statistics, folded to one multiply-add
    ``x * k + b`` in one pass (``addcmul``)."""

    def __init__(self, num_features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        kw = dict(dtype=torch.float32, device=device)
        self.scale = nn.Parameter(torch.ones(num_features, **kw))
        self.bias = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("mean", torch.zeros(num_features, **kw))
        self.register_buffer("var", torch.ones(num_features, **kw))
        self._fold_key = None
        self._fold_cache = None

    def _fold(self, dtype: torch.dtype) -> Tuple[Tensor, Tensor]:
        """``k`` and ``b`` of ``x * k + b``, computed in float32 and cast."""
        k = self.scale * torch.rsqrt(self.var + self.eps)
        b = self.bias - self.mean * k
        return k.to(dtype)[:, None, None], b.to(dtype)[:, None, None]

    def forward(self, x: Tensor) -> Tensor:  # (B, C, H, W)
        if torch.is_grad_enabled():
            k, b = self._fold(x.dtype)
        else:
            # without autograd the fold is reused until a statistic is
            # replaced (object, storage) or edited in place (version); the
            # cache holds the statistics, so their ids stay unique
            stats = (self.scale, self.bias, self.mean, self.var)
            key = (x.dtype, x.device) + tuple((id(t), t.data_ptr(), t._version) for t in stats)
            if key != self._fold_key:
                self._fold_key, self._fold_cache = key, (stats, self._fold(x.dtype))
            k, b = self._fold_cache[1]
        return torch.addcmul(b, x, k)


def build_norm(norm_cfg: Optional[dict], num_features: int, device=None) -> Optional[nn.Module]:
    """Norm layer from a config dict; the port has ``FrozenBN``."""
    if norm_cfg is None:
        return None
    cfg = dict(norm_cfg)
    kind = cfg.pop("type")
    if kind == "FrozenBN":
        return FrozenBatchNorm(num_features, eps=cfg.pop("eps", 1e-5), device=device)
    raise ValueError(f"norm type {kind!r} is not ported")


_ACTS = {"relu": F.relu, None: None}


def build_act(act: Optional[str]) -> Optional[Callable[[Tensor], Tensor]]:
    if act not in _ACTS:
        raise ValueError(f"activation {act!r} is not ported")
    return _ACTS[act]


class ConvModule(nn.Module):
    """conv -> norm -> act, each of the last two optional. The conv has a
    bias unless a norm follows it."""

    def __init__(
        self,
        in_channels: int,
        out_channels: int,
        kernel_size: int = 3,
        stride: int = 1,
        padding: int = 0,
        norm_cfg: Optional[dict] = None,
        act: Optional[str] = "relu",
        dtype: Optional[torch.dtype] = None,
        device=None,
    ):
        super().__init__()
        self.conv = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            bias=norm_cfg is None, dtype=dtype, device=device,
        )
        self.norm = build_norm(norm_cfg, out_channels, device)
        self.act_fn = build_act(act)

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act_fn is not None:
            x = self.act_fn(x)
        return x


def max_pool_same_torch(x: Tensor, window: int, stride: int, padding: int) -> Tensor:
    """MaxPool2d with symmetric padding (-inf fill), NCHW."""
    return F.max_pool2d(x, window, stride, padding)


def resize_nearest(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Nearest resize of NCHW to (H, W) with the reference's index arithmetic
    ``floor(i * in / out)`` on integers; keeps channels_last memory."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (oh, ow) == (2 * h, 2 * w):
        # src = floor(dst * 0.5): exact in floating point
        return F.interpolate(x, scale_factor=2, mode="nearest")
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    out = x.index_select(2, rows).index_select(3, cols)
    return out.contiguous(memory_format=torch.channels_last)
