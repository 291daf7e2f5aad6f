"""Carry the JAX package's weights into the port.

The port names its submodules as the reference names its flax modules, so
a parameter's path converts by joining it with dots. Only layouts change:

* conv kernels HWIO -> OIHW;
* transposed-conv kernels (flax ``ConvTranspose``) (kh, kw, in, out) ->
  (in, out, kh, kw) with both spatial axes flipped: flax applies its kernel
  as a convolution of the strided input, ``torch.nn.ConvTranspose2d`` as the
  transpose of a convolution, which reads the kernel mirrored;
* dense kernels (in, out) -> (out, in); fc1 needs no permutation, since both
  sides flatten RoI features in (S, S, C) order;
* the rank-3 ``DenseGeneral`` kernels of flax's attention (``query``,
  ``key``, ``value`` (in, heads, head_dim), ``out`` (heads, head_dim, out))
  and the (heads, head_dim) biases: the head axes merge head-major into one,
  then (in, out) -> (out, in), where the port module is a ``HeadsLinear``;
* LayerNorm ``scale``/``bias`` keep their names, as FrozenBN's;
* FrozenBN ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  keep their names.

A flax kernel does not say whether it is a conv's or a transposed conv's,
so the port module it loads into decides (pass ``model``); without one, a
rank-4 kernel is taken as a conv's.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .layers import HeadsLinear


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def _kernel_to_weight(value: np.ndarray, module: Optional[nn.Module], path: str) -> np.ndarray:
    if isinstance(module, HeadsLinear) and value.ndim == 3:
        if module.heads_axis == "in":  # (heads, head_dim, out)
            return value.reshape(-1, value.shape[-1]).T
        return value.reshape(value.shape[0], -1).T  # (in, heads, head_dim)
    if isinstance(module, nn.ConvTranspose2d) and value.ndim == 4:
        return np.ascontiguousarray(value[::-1, ::-1].transpose(2, 3, 0, 1))
    if isinstance(module, (nn.Conv2d, type(None))) and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)
    if isinstance(module, (nn.Linear, type(None))) and value.ndim == 2:
        return value.T
    raise ValueError(f"no layout for a rank-{value.ndim} kernel at {path} "
                     f"(port module {type(module).__name__})")


def from_jax_variables(
    variables: Mapping[str, Any], model: Optional[nn.Module] = None
) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree with numpy leaves -> the port's
    ``state_dict`` (float32), to load with ``strict=True``. With ``model``,
    each kernel takes the layout of the module of ``model`` at its path
    (``Conv2d``, ``ConvTranspose2d``, ``Linear`` or ``HeadsLinear``; another
    or none raises); a model with transposed convs or attention must be
    passed."""
    modules = dict(model.named_modules()) if model is not None else {}
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            if path.endswith(".kernel"):
                name = path[: -len(".kernel")]
                if model is not None and name not in modules:
                    raise ValueError(f"{path}: the port model has no module {name!r}")
                value = _kernel_to_weight(value, modules.get(name), path)
                path = name + ".weight"
            elif path.endswith(".bias") and value.ndim == 2:
                module = modules.get(path[: -len(".bias")])
                if not isinstance(module, HeadsLinear):
                    raise ValueError(f"no layout for a rank-2 bias at {path} "
                                     f"(port module {type(module).__name__})")
                value = value.reshape(-1)
            state[path] = torch.tensor(value, dtype=torch.float32)
    return state
