"""Profiling helpers on ``torch.profiler``.

Counterpart of ``torch_detection_tpu/engine/profiling.py``: ``trace``
records a scope (host operators, and the GPU's kernels when one is in use)
and writes it as a Chrome trace under ``log_dir``, viewable in Perfetto or
``chrome://tracing``; ``annotate`` names a host span on that timeline, so
the input pipeline's time shows beside the device's; ``ThroughputMeter``
tracks images/s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

TRACE_NAME = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed scope: CPU activity, plus CUDA activity when a
    GPU is available; on exit the Chrome trace is written to
    ``log_dir/trace.json`` (the directory is made)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_NAME))


def annotate(name: str):
    """A named host span on the profiler's timeline (a context manager)."""
    return torch.profiler.record_function(name)


class ThroughputMeter:
    """Rolling images/s with a warm-up skip (the first ``warmup_steps``
    steps are excluded: they include cuDNN's planning and the kernels'
    build)."""

    def __init__(self, warmup_steps: int = 2):
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._images = 0
        self._t0: Optional[float] = None

    def step(self, batch_size: int) -> None:
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._t0 = time.perf_counter()
            self._images = 0
        elif self._steps > self.warmup_steps:
            self._images += batch_size

    @property
    def images_per_sec(self) -> float:
        if self._t0 is None or self._images == 0:
            return 0.0
        return self._images / (time.perf_counter() - self._t0)
