"""File IO keyed by extension: pickle, json and yaml.

The port's own copy of ``torch_detection_tpu/utils/file_handler.py``: the
data tier and the CLIs read and write annotations, proposals and detections
as pickle or json, and ``Config.fromfile`` and ``Config.dump`` read and
write configs in any of the three. PyYAML is imported when a yaml file is
first read or written; without it that call raises an ``ImportError`` that
names PyYAML and the file.
"""

from __future__ import annotations

import json
import pickle
from pathlib import Path
from typing import Any

from .misc import is_str


class PickleHandler:
    binary = True

    def load_from_fileobj(self, file, **kwargs):
        return pickle.load(file, **kwargs)

    def dump_to_fileobj(self, obj, file, **kwargs):
        kwargs.setdefault("protocol", pickle.HIGHEST_PROTOCOL)
        pickle.dump(obj, file, **kwargs)


class JsonHandler:
    binary = False

    def load_from_fileobj(self, file, **kwargs):
        return json.load(file, **kwargs)

    def dump_to_fileobj(self, obj, file, **kwargs):
        json.dump(obj, file, **kwargs)


def _yaml(file):
    try:
        import yaml
    except ImportError as e:
        name = getattr(file, "name", file)
        raise ImportError(f"reading or writing the yaml file {name!s} needs PyYAML "
                          "(the 'yaml' module), which is not installed") from e
    return yaml


class YamlHandler:
    """Reads with ``yaml.SafeLoader`` and writes with ``yaml.safe_dump``."""

    binary = False

    def load_from_fileobj(self, file, **kwargs):
        yaml = _yaml(file)
        kwargs.setdefault("Loader", yaml.SafeLoader)
        return yaml.load(file, **kwargs)

    def dump_to_fileobj(self, obj, file, **kwargs):
        _yaml(file).safe_dump(obj, file, **kwargs)


_HANDLERS = {"pkl": PickleHandler(), "pickle": PickleHandler(), "json": JsonHandler(),
             "yaml": YamlHandler(), "yml": YamlHandler()}


def _handler(filepath, file_format):
    fmt = file_format or Path(filepath).suffix.lstrip(".").lower()
    if fmt not in _HANDLERS:
        raise ValueError(f"unsupported file format: {fmt!r}")
    return _HANDLERS[fmt]


def load(filepath, file_format: str = None, **kwargs) -> Any:
    """Load a pkl, json or yaml file by its extension (or ``file_format``),
    from a path or an open file object."""
    handler = _handler(filepath, file_format)
    if is_str(filepath) or isinstance(filepath, Path):
        with open(filepath, "rb" if handler.binary else "r") as f:
            return handler.load_from_fileobj(f, **kwargs)
    return handler.load_from_fileobj(filepath, **kwargs)


def dump(obj, filepath, file_format: str = None, **kwargs) -> None:
    handler = _handler(filepath, file_format)
    if is_str(filepath) or isinstance(filepath, Path):
        with open(filepath, "wb" if handler.binary else "w") as f:
            handler.dump_to_fileobj(obj, f, **kwargs)
    else:
        handler.dump_to_fileobj(obj, filepath, **kwargs)
