"""DataContainer: how collate treats a sample's field.

The port's own copy of ``torch_detection_tpu/data/container.py``:
``cpu_only`` fields (meta dicts) stay host-side Python, ``stack`` fields
are padded and stacked into one array, the others stay a list.
"""

from __future__ import annotations

from typing import Any

import numpy as np


class DataContainer:
    def __init__(self, data: Any, stack: bool = False, cpu_only: bool = False, pad_value: float = 0):
        self._data = data
        self._stack = stack
        self._cpu_only = cpu_only
        self._pad_value = pad_value

    @property
    def data(self) -> Any:
        return self._data

    @property
    def datatype(self):
        return type(self._data)

    @property
    def stack(self) -> bool:
        return self._stack

    @property
    def cpu_only(self) -> bool:
        return self._cpu_only

    @property
    def pad_value(self):
        return self._pad_value

    @property
    def shape(self):
        assert isinstance(self._data, np.ndarray), "shape requires array data"
        return self._data.shape

    def dim(self) -> int:
        assert isinstance(self._data, np.ndarray), "dim requires array data"
        return self._data.ndim

    def __repr__(self) -> str:
        return f"DataContainer(stack={self._stack}, cpu_only={self._cpu_only}, data={self._data!r})"
