"""Carry the JAX package's weights into the port.

The port names its submodules as the reference names its flax modules, so
a parameter's path converts by joining it with dots. Only layouts change:

* conv kernels HWIO -> OIHW;
* dense kernels (in, out) -> (out, in); fc1 needs no permutation, since both
  sides flatten RoI features in (S, S, C) order;
* FrozenBN ``scale``/``bias`` (params) and ``mean``/``var`` (batch_stats)
  keep their names.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = ""):
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, path + ".")
        else:
            yield path, np.asarray(value)


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` tree with numpy leaves -> the port's
    ``state_dict`` (float32), to load with ``strict=True``."""
    state = {}
    for collection in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(collection, {})):
            if path.endswith(".kernel"):
                path = path[: -len("kernel")] + "weight"
                if value.ndim == 4:
                    value = value.transpose(3, 2, 0, 1)
                elif value.ndim == 2:
                    value = value.T
                else:
                    raise ValueError(f"unexpected kernel rank {value.ndim} at {path}")
            state[path] = torch.tensor(value, dtype=torch.float32)
    return state
