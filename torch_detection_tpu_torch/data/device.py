"""Host -> device batch staging with prefetch.

Counterpart of ``torch_detection_tpu/data/device.py``: ``prefetch_to_device``
walks an iterator of numpy batches and issues the copies of the next
``size`` batches ahead of their use, so that the copy of batch N+1 overlaps
the device's work on batch N.

On a CUDA device each array is copied into pinned host memory, then to the
device with ``non_blocking`` on a side stream. Before a batch is handed
out, the consumer's stream waits on that batch's copy event, and each of
its tensors is recorded on the consumer's stream (``record_stream``), so
that the allocator does not reuse its memory while the consumer's work on
it is queued. On the CPU the arrays become tensors without a copy.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, Iterator, Optional, Union

import numpy as np
import torch

from ..utils.device import resolve_device


def _to_cpu_tensor(v):
    return torch.from_numpy(v) if isinstance(v, np.ndarray) else v


def prefetch_to_device(
    iterator: Iterable[Dict],
    size: int = 2,
    device: Optional[Union[str, torch.device]] = None,
    skip_keys: tuple = ("img_meta",),
) -> Iterator[Dict]:
    """Yield batches whose arrays lie on ``device`` (default ``cuda``),
    staging ``size`` batches ahead. ``skip_keys`` stay on the host (the meta
    dicts); tensors already on ``device`` pass through."""
    if size < 1:
        raise ValueError(f"prefetch size must be at least 1, got {size}")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    it = iter(iterator)
    if device.type != "cuda":
        for batch in it:
            yield {k: v if k in skip_keys else _to_cpu_tensor(v).to(device) for k, v in batch.items()}
        return

    copy_stream = torch.cuda.Stream(device)
    staged = collections.deque()

    def stage(batch: Dict):
        out = {}
        with torch.cuda.stream(copy_stream):
            for k, v in batch.items():
                if k in skip_keys:
                    out[k] = v
                    continue
                t = _to_cpu_tensor(v)
                if t.device != device:
                    t = t.pin_memory().to(device, non_blocking=True)
                out[k] = t
        return out, copy_stream.record_event()

    for batch in it:
        staged.append(stage(batch))
        if len(staged) == size:
            break
    while staged:
        out, done = staged.popleft()
        consumer = torch.cuda.current_stream(device)
        consumer.wait_event(done)
        for k, v in out.items():
            if k not in skip_keys and isinstance(v, torch.Tensor):
                v.record_stream(consumer)
        yield out
        batch = next(it, None)
        if batch is not None:
            staged.append(stage(batch))
