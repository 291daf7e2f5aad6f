"""Shared model building blocks.

Counterpart of ``torch_detection_tpu/models/layers.py``, cut to what the
ported slices run, with the flax building blocks Sparse R-CNN and DETR
take from ``flax.linen`` (``LayerNorm``, ``MultiHeadDotProductAttention``
with its key mask, and a float32 ``Dense``). These blocks take NCHW
tensors, PyTorch's convention; the detector keeps them in
``torch.channels_last`` memory, so a ``permute(0, 2, 3, 1)`` gives the
reference's NHWC layout without a copy.

Parameters are created in ``dtype`` (the compute dtype, as the reference's
flax ``dtype`` attribute), except FrozenBN's, which stay float32: the fold
into ``x * k + b`` is computed in float32 and cast at use, as the reference
computes it from its float32 params; GroupNorm's and LayerNorm's stay
float32 too, as flax keeps them.
"""

from __future__ import annotations

import contextlib
import functools
import math
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

    def forget_fold(self) -> None:
        """Drop the cached fold: for a writer that changes a statistic
        without a trace in its key, as FSDP's all-gather does (it copies
        into the same parameter, keeping its version, and its storage may
        come back at the same address)."""
        self._fold_key = self._fold_cache = None

    def forward(self, x: Tensor) -> Tensor:  # (B, C, H, W)
        if torch.is_grad_enabled() or torch.compiler.is_exporting():
            # under torch.export the statistics have no storage to key a
            # cache on, and the graph computes the fold itself
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


class GroupNorm(nn.Module):
    """flax's ``GroupNorm`` over NCHW: ``num_groups`` groups of channels,
    float32 ``scale`` and ``bias`` (flax's names and dtype, float32 in every
    build), statistics and normalisation in float32 with autocast off, the
    result cast back to the input's dtype (bf16 under autocast: flax's
    module rounds its output to its ``dtype`` before the activation).

    flax computes the variance as E[x^2] - E[x]^2 clamped at 0
    (``use_fast_variance``); this module takes ``F.group_norm``'s two-pass
    variance, one fused kernel that saves only its input and the per-group
    statistics for the backward. The two part by float32 rounding of order
    1e-7 * mean^2 / var, almost all of it flax's cancellation (the same
    formula summed in another order parts from flax's as much): the parity
    tests hold them within 1e-5 at the towers' inputs, whose mean is within
    a standard deviation of 0 (``tests/test_torch_fcos.py``)."""

    def __init__(self, num_features: int, num_groups: int = 32, eps: float = 1e-5, device=None):
        super().__init__()
        if num_features % num_groups:
            raise ValueError(f"{num_features} channels do not split into {num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.scale = nn.Parameter(torch.ones(num_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=torch.float32, device=device))

    def forward(self, x: Tensor) -> Tensor:  # (B, C, H, W)
        # the op itself: ``F.group_norm`` refuses a group of one value (batch
        # 1, one channel a group, a 1 x 1 map), which flax normalizes to 0
        with torch.autocast(x.device.type, enabled=False):
            y = torch.group_norm(x.float(), self.num_groups, self.scale, self.bias, self.eps,
                                 torch.backends.cudnn.enabled)
        return y.to(x.dtype)


def build_norm(norm_cfg: Optional[dict], num_features: int, device=None) -> Optional[nn.Module]:
    """Norm layer from a config dict: ``FrozenBN`` or ``GN`` (32 groups
    unless ``num_groups``, eps 1e-5 unless ``eps``, as the reference)."""
    if norm_cfg is None:
        return None
    cfg = dict(norm_cfg)
    kind = cfg.pop("type")
    if kind == "FrozenBN":
        return FrozenBatchNorm(num_features, eps=cfg.pop("eps", 1e-5), device=device)
    if kind == "GN":
        return GroupNorm(num_features, num_groups=cfg.pop("num_groups", 32),
                         eps=cfg.pop("eps", 1e-5), device=device)
    raise ValueError(f"norm type {kind!r} is not ported")


_ACTS = {
    "relu": F.relu,
    "relu6": F.relu6,
    # Darknet's convention (the YOLO family): slope 0.1, not torch's 0.01
    "leaky_relu": functools.partial(F.leaky_relu, negative_slope=0.1),
    "gelu": functools.partial(F.gelu, approximate="tanh"),  # flax's gelu is the tanh form
    "silu": F.silu,
    "sigmoid": torch.sigmoid,
    None: None,
}


def build_act(act: Optional[str]) -> Optional[Callable[[Tensor], Tensor]]:
    if act not in _ACTS:
        raise ValueError(f"activation {act!r} is not ported")
    return _ACTS[act]


class ConvModule(nn.Module):
    """conv -> norm -> act, each of the last two optional. The conv has a
    bias if ``use_bias``, by default unless a norm follows it. ``groups``
    splits the conv into groups of channels (depthwise where it equals
    ``in_channels``), as flax's ``feature_group_count``."""

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
        dilation: int = 1,
        use_bias: Optional[bool] = None,
        groups: int = 1,
    ):
        super().__init__()
        self.conv = nn.Conv2d(
            in_channels, out_channels, kernel_size, stride=stride, padding=padding,
            dilation=dilation, groups=groups,
            bias=norm_cfg is None if use_bias is None else use_bias, dtype=dtype, device=device,
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


class LayerNorm(nn.Module):
    """flax's ``LayerNorm(dtype=float32)`` over the last axis: float32
    ``scale`` and ``bias`` (flax's names, kept in float32 in every build),
    eps 1e-6, computed and returned in float32 with autocast off."""

    def __init__(self, num_features: int, eps: float = 1e-6, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(num_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, dtype=torch.float32, device=device))

    def forward(self, x: Tensor) -> Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return F.layer_norm(x.float(), self.scale.shape, self.scale, self.bias, self.eps)


class Float32Linear(nn.Linear):
    """A linear layer kept and computed in float32 in every build, autocast
    off, as a flax ``Dense(dtype=float32)`` on float32 parameters."""

    def __init__(self, in_features: int, out_features: int, device=None):
        super().__init__(in_features, out_features, dtype=torch.float32, device=device)

    def forward(self, x: Tensor) -> Tensor:
        with torch.autocast(x.device.type, enabled=False):
            return F.linear(x.float(), self.weight, self.bias)


class HeadsLinear(nn.Linear):
    """A projection of flax's ``MultiHeadDotProductAttention``, whose
    ``DenseGeneral`` kernel has rank 3: (in, heads, head_dim) into the heads
    (``heads_axis="out"``) or (heads, head_dim, out) out of them
    (``heads_axis="in"``). Here the heads are one axis of heads * head_dim,
    head-major; ``models/convert.py`` reads ``heads_axis`` to merge them."""

    def __init__(self, in_features: int, out_features: int, heads_axis: str, dtype=None,
                 device=None):
        super().__init__(in_features, out_features, dtype=dtype, device=device)
        if heads_axis not in ("in", "out"):
            raise ValueError(f"heads_axis must be 'in' or 'out', got {heads_axis!r}")
        self.heads_axis = heads_axis


class MultiHeadDotProductAttention(nn.Module):
    """flax's ``MultiHeadDotProductAttention`` without dropout: ``query``,
    ``key``, ``value`` and ``out`` projections (flax's names), the query
    divided by sqrt(head_dim) in the compute dtype before the product, the
    softmax's result cast to the compute dtype, as flax computes them.
    ``attn(x)`` is self-attention; ``attn(inputs_q, inputs_k, inputs_v,
    mask)`` attends from ``inputs_q`` to ``inputs_k`` (default
    ``inputs_q``) with the values of ``inputs_v`` (default ``inputs_k``).
    The boolean ``mask`` broadcasts against the (..., heads, q, k) weights,
    True where a key may be attended; a masked weight is set to the least
    finite value of the weights' dtype before the softmax, as flax's
    ``big_neg``. Parameters in ``dtype``; the compute dtype is the
    projections' output dtype (autocast's, where it is on)."""

    def __init__(self, features: int, num_heads: int, dtype=None, device=None):
        super().__init__()
        if features % num_heads:
            raise ValueError(f"{features} features do not split into {num_heads} heads")
        self.num_heads = num_heads
        kw = dict(dtype=dtype, device=device)
        self.query = HeadsLinear(features, features, "out", **kw)
        self.key = HeadsLinear(features, features, "out", **kw)
        self.value = HeadsLinear(features, features, "out", **kw)
        self.out = HeadsLinear(features, features, "in", **kw)

    def forward(self, inputs_q: Tensor, inputs_k: Optional[Tensor] = None,
                inputs_v: Optional[Tensor] = None, mask: Optional[Tensor] = None
                ) -> Tensor:  # (..., N, features)
        inputs_k = inputs_q if inputs_k is None else inputs_k
        inputs_v = inputs_k if inputs_v is None else inputs_v
        *lead, n, features = inputs_q.shape
        head_dim = features // self.num_heads
        q = self.query(inputs_q).view(*lead, n, self.num_heads, head_dim)
        k = self.key(inputs_k).view(*inputs_k.shape[:-1], self.num_heads, head_dim)
        v = self.value(inputs_v).view(*inputs_v.shape[:-1], self.num_heads, head_dim)
        dtype = q.dtype
        # a 0-d tensor on the device, so that the division is correctly
        # rounded there too (CUDA divides by a Python scalar's reciprocal)
        depth = torch.full((), math.sqrt(head_dim), dtype=torch.float32, device=q.device)
        weights = torch.einsum("...qhd,...khd->...hqk", q / depth.to(dtype), k)
        if mask is not None:
            weights = weights.masked_fill(~mask, torch.finfo(weights.dtype).min)
        weights = torch.softmax(weights, dim=-1).to(dtype)
        out = torch.einsum("...hqk,...khd->...qhd", weights, v)
        return self.out(out.reshape(*lead, n, features))


class SELayer(nn.Module):
    """Squeeze-and-excitation: the spatial mean of each channel, ``fc1``
    (to ``channels // reduction``, at least 1) -> ReLU -> ``fc2`` ->
    sigmoid, the input scaled by the result channel by channel. The two
    layers are ``nn.Linear``, flax's ``Dense`` names, so the converter
    transposes their kernels."""

    def __init__(self, channels: int, reduction: int = 16, dtype=None, device=None):
        super().__init__()
        hidden = max(channels // reduction, 1)
        self.fc1 = nn.Linear(channels, hidden, dtype=dtype, device=device)
        self.fc2 = nn.Linear(hidden, channels, dtype=dtype, device=device)

    def forward(self, x: Tensor) -> Tensor:  # (B, C, H, W)
        y = torch.sigmoid(self.fc2(F.relu(self.fc1(x.mean(dim=(2, 3))))))
        return x * y[:, :, None, None]


def channel_shuffle(x: Tensor, groups: int) -> Tensor:
    """ShuffleNet's channel shuffle of NCHW: channel ``g * (C / groups) + k``
    moves to ``k * groups + g``, the reference's order on NHWC's last axis
    (``view(n, groups, c // groups, h, w).transpose(1, 2)``). Done on the
    NHWC view, so a channels_last input stays channels_last."""
    n, c, h, w = x.shape
    if c % groups:
        raise ValueError(f"{c} channels do not split into {groups} groups")
    y = x.permute(0, 2, 3, 1).reshape(n, h, w, groups, c // groups).transpose(3, 4)
    return y.reshape(n, h, w, c).permute(0, 3, 1, 2)


def channel_split(x: Tensor, sections: int = 2) -> Tuple[Tensor, ...]:
    """NCHW channels in ``sections`` equal parts (ShuffleNet v2's two
    branches)."""
    if x.shape[1] % sections:
        raise ValueError(f"{x.shape[1]} channels do not split into {sections} sections")
    return torch.chunk(x, sections, dim=1)


def avg_pool_torch(x: Tensor, window: int, stride: int, padding: int = 0) -> Tensor:
    """AvgPool2d of NCHW with symmetric zero padding counted in each
    window's divisor, as the reference's (``window * window`` always)."""
    return F.avg_pool2d(x, window, stride, padding, count_include_pad=True)


def max_pool_same_torch(x: Tensor, window: int, stride: int, padding: int) -> Tensor:
    """MaxPool2d with symmetric padding (-inf fill), NCHW."""
    return F.max_pool2d(x, window, stride, padding)


def max_pool_same(x: Tensor, window: int, stride: int) -> Tensor:
    """flax's ``max_pool(..., padding="SAME")`` on NCHW: ceil(size / stride)
    outputs an axis, the padding that takes split with its smaller half
    before, filled with -inf (SSD's pool3 takes 75 rows to 38 with one row
    after; its pool5, 3 x 3 stride 1, pads one on each side)."""
    pads = []
    for size in x.shape[2:]:
        total = max((-(-size // stride) - 1) * stride + window - size, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    if top == bottom and left == right:
        return F.max_pool2d(x, window, stride, (top, left))
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-math.inf), window, stride)


def resize_nearest_2x(x: Tensor) -> Tensor:
    """Nearest 2x upsample of NCHW (source index floor(dst / 2), exact)."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def resize_nearest(x: Tensor, out_hw: Tuple[int, int]) -> Tensor:
    """Nearest resize of NCHW to (H, W) with the reference's index arithmetic
    ``floor(i * in / out)`` on integers; keeps channels_last memory."""
    h, w = x.shape[2:]
    oh, ow = out_hw
    if (oh, ow) == (2 * h, 2 * w):
        return resize_nearest_2x(x)
    rows = torch.arange(oh, device=x.device) * h // oh
    cols = torch.arange(ow, device=x.device) * w // ow
    out = x.index_select(2, rows).index_select(3, cols)
    return out.contiguous(memory_format=torch.channels_last)
