"""Foundation helpers.

The port's own copy of ``torch_detection_tpu/utils/misc.py``: the type
checks, ``to_array`` (the host's numpy currency; a batch crosses to the
device once, in ``data/device.py``) and ``random_scale``; and
``expected_sizes``, the one reader of a config's ``img_expected_sizes``.
"""

from __future__ import annotations

import os
import random
from collections.abc import Sequence
from typing import List, Tuple

import numpy as np


def is_str(x) -> bool:
    return isinstance(x, str)


def file_is_exist(filename) -> bool:
    return os.path.isfile(filename)


def is_list_of(seq, expected_type) -> bool:
    """True iff ``seq`` is a Sequence whose every element is ``expected_type``."""
    if not isinstance(seq, Sequence) or isinstance(seq, str):
        return False
    return all(isinstance(item, expected_type) for item in seq)


def to_array(data, dtype=None) -> np.ndarray:
    """Ints, floats, sequences, arrays and tensors as a numpy array."""
    if isinstance(data, np.ndarray):
        arr = data
    elif isinstance(data, (int, float)):
        arr = np.array(data)
    elif isinstance(data, Sequence) and not is_str(data):
        arr = np.asarray(data)
    else:
        try:  # torch tensors, anything with __array__
            arr = np.asarray(data)
        except Exception as e:
            raise TypeError(f"cannot convert {type(data)} to array") from e
    return arr.astype(dtype) if dtype is not None else arr


def expected_sizes(sizes) -> List[Tuple[int, int]]:
    """``img_expected_sizes`` as a list of (long, short) tuples: one pair or
    a list of pairs, tuples from a ``.py`` config or lists from a json or
    yaml one."""
    if not isinstance(sizes[0], (list, tuple)):
        sizes = [sizes]
    return [tuple(s) for s in sizes]


def random_scale(img_expected_sizes, size_mode: str = "range", rng: random.Random = None) -> Tuple[int, int]:
    """Pick one (long, short) scale for multi-scale training.

    * a single ``(long, short)`` tuple is returned as-is;
    * ``size_mode='value'``: uniformly pick one of the provided tuples;
    * ``size_mode='range'``: exactly 2 tuples; sample long/short edges
      uniformly from [min, max] of the respective edge across the two.
    """
    rand = rng if rng is not None else random
    if isinstance(img_expected_sizes, tuple):
        if len(img_expected_sizes) != 2:
            raise ValueError("expected a (long, short) tuple")
        return img_expected_sizes
    if not is_list_of(img_expected_sizes, tuple):
        raise TypeError("img_expected_sizes must be a tuple or a list of tuples")
    if len(img_expected_sizes) == 1:
        return img_expected_sizes[0]
    if size_mode == "value":
        return img_expected_sizes[rand.randint(0, len(img_expected_sizes) - 1)]
    if size_mode == "range":
        if len(img_expected_sizes) != 2:
            raise ValueError("size_mode='range' requires exactly 2 (long, short) tuples")
        longs = [max(s) for s in img_expected_sizes]
        shorts = [min(s) for s in img_expected_sizes]
        long_edge = rand.randint(min(longs), max(longs))
        short_edge = rand.randint(min(shorts), max(shorts))
        return (long_edge, short_edge)
    raise ValueError(f"unknown size_mode {size_mode!r}")
