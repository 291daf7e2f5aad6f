"""Config: attribute-accessible dict tree loaded from a ``.py`` config file.

The port's own copy of ``torch_detection_tpu/utils/config.py``, cut to what
loading ``configs/*.py`` needs: dotted attribute access, the ``_base_``
inheritance chain and ``_delete_`` replacement. The config files are plain
Python dicts and are shared with the JAX package.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Any, Dict


class ConfigDict(dict):
    """dict with attribute access; nested dicts are wrapped on the fly."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, ConfigDict):
            value = ConfigDict(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e


def _wrap(obj: Any) -> Any:
    if isinstance(obj, dict):
        return ConfigDict({k: _wrap(v) for k, v in obj.items()})
    if isinstance(obj, (list, tuple)):
        return type(obj)(_wrap(v) for v in obj)
    return obj


def _load_py_config(path: Path) -> Dict[str, Any]:
    spec = importlib.util.spec_from_file_location(f"_tdt_cfg_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
        return {
            k: v
            for k, v in vars(mod).items()
            if (k == "_base_" or not k.startswith("_"))
            and not callable(v)
            and not isinstance(v, type(sys))
        }
    finally:
        sys.modules.pop(spec.name, None)


def merge_dicts(base: Dict, override: Dict) -> Dict:
    """Recursive merge; override wins. ``{'_delete_': True}`` replaces a node."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and v.pop("_delete_", False):
            out[k] = merge_dicts({}, v)
        elif k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_dicts(out[k], v)
        else:
            out[k] = v
    return out


class Config(ConfigDict):
    """Top-level config. ``Config.fromfile`` loads a ``.py`` file with its
    ``_base_`` chain (str or list of str, relative to the file)."""

    @classmethod
    def fromfile(cls, filename) -> "Config":
        path = Path(filename).expanduser().resolve()
        if path.suffix != ".py":
            raise ValueError(f"only .py config files are supported, got {path.name}")
        raw = _load_py_config(path)
        bases = raw.pop("_base_", None)
        merged: Dict[str, Any] = {}
        if bases is not None:
            if isinstance(bases, str):
                bases = [bases]
            for b in bases:
                merged = merge_dicts(merged, dict(cls.fromfile(path.parent / b)))
        merged = merge_dicts(merged, raw)
        return cls(_wrap(merged))
