"""String-keyed component registry.

The port's own copy of ``torch_detection_tpu/utils/registry.py``: a config
dict ``{'type': 'ResNet', ...kwargs}`` resolves against one namespace.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional


class Registry:
    """A name -> constructor mapping with decorator-based registration."""

    def __init__(self, name: str):
        self._name = name
        self._module_dict: Dict[str, Callable] = {}

    @property
    def name(self) -> str:
        return self._name

    def __contains__(self, key: str) -> bool:
        return key in self._module_dict

    def __repr__(self) -> str:
        return f"Registry(name={self._name}, items={sorted(self._module_dict)})"

    def get(self, key: str) -> Optional[Callable]:
        return self._module_dict.get(key)

    def register_module(self, cls: Optional[Callable] = None, *, name: Optional[str] = None):
        """Register a class/callable.  Usable as ``@R.register_module`` or
        ``@R.register_module(name='Alias')``."""

        def _register(obj: Callable) -> Callable:
            if not callable(obj):
                raise TypeError(f"can only register callables, got {type(obj)}")
            key = name if name is not None else obj.__name__
            if key in self._module_dict:
                raise KeyError(f"{key} already registered in {self._name}")
            self._module_dict[key] = obj
            return obj

        if cls is None:
            return _register
        return _register(cls)

    def build(self, cfg: Dict[str, Any], **default_kwargs) -> Any:
        """Instantiate from ``{'type': <name-or-callable>, **kwargs}``;
        ``default_kwargs`` fill in keys absent from ``cfg``."""
        if not isinstance(cfg, dict) or "type" not in cfg:
            raise TypeError(f"cfg must be a dict with a 'type' key, got {cfg!r}")
        args = dict(cfg)
        obj_type = args.pop("type")
        if isinstance(obj_type, str):
            obj_cls = self.get(obj_type)
            if obj_cls is None:
                raise KeyError(f"{obj_type} is not registered in {self._name}")
        elif callable(obj_type):
            obj_cls = obj_type
        else:
            raise TypeError(f"'type' must be a str or callable, got {type(obj_type)}")
        for k, v in default_kwargs.items():
            args.setdefault(k, v)
        return obj_cls(**args)


BACKBONES = Registry("backbones")
NECKS = Registry("necks")
HEADS = Registry("heads")
DETECTORS = Registry("detectors")
DATASETS = Registry("datasets")
