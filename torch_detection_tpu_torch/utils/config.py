"""Config: attribute-accessible dict tree loaded from a py, json, yaml or
pkl config file.

The port's own copy of ``torch_detection_tpu/utils/config.py``: dotted
attribute access, the ``_base_`` inheritance chain (across formats) and
``_delete_`` replacement, and ``Config.dump``. The ``.py`` config files are
plain Python dicts and are shared with the JAX package; a json or yaml file
holds lists where a ``.py`` file may hold tuples, and the port's readers of
config values take either.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path
from typing import Any, Dict

from . import file_handler


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
    """Top-level config. ``Config.fromfile`` loads a ``.py`` file, or a
    json, yaml, yml or pkl file through ``file_handler.load``, with its
    ``_base_`` chain (str or list of str, each relative to the file and of
    any of these formats)."""

    @classmethod
    def fromfile(cls, filename) -> "Config":
        path = Path(filename).expanduser().resolve()
        raw = _load_py_config(path) if path.suffix == ".py" else file_handler.load(path)
        bases = raw.pop("_base_", None)
        merged: Dict[str, Any] = {}
        if bases is not None:
            if isinstance(bases, str):
                bases = [bases]
            for b in bases:
                merged = merge_dicts(merged, dict(cls.fromfile(path.parent / b)))
        merged = merge_dicts(merged, raw)
        return cls(_wrap(merged))

    def dump(self, filepath) -> None:
        """Write the config as plain dicts and lists (tuples become lists)
        in the format of ``filepath``'s suffix: json, yaml, yml or pkl."""
        file_handler.dump(_to_plain(self), filepath)


def _to_plain(obj: Any) -> Any:
    if isinstance(obj, dict):
        return {k: _to_plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_plain(v) for v in obj]
    return obj
