"""Data loader: sampler + collate + a background prefetch thread.

Counterpart of ``torch_detection_tpu/data/loader.py``: a plain Python
iterable whose thread decodes, augments and collates ahead of the consumer,
with an optional ordered thread pool for the samples (decode, resize and
the numpy passes release the interpreter lock), and ``iter_batches``
starting mid-epoch without decoding the skipped batches. The batches stay
numpy; ``data/device.py::prefetch_to_device`` puts them on the device.
"""

from __future__ import annotations

import queue
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

from .collate import collate
from .sampler import DistributedGroupSampler, GroupSampler


class DataLoader:
    """Iterates fixed-shape batches; call ``set_epoch`` between epochs for
    the epoch's shuffle and augmentations."""

    def __init__(
        self,
        dataset,
        sampler,
        batch_size: int,
        collate_fn: Callable,
        prefetch: int = 2,
        drop_last: bool = False,
        workers: int = 0,
    ):
        self.dataset = dataset
        self.sampler = sampler
        self.batch_size = batch_size
        self.collate_fn = collate_fn
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.workers = workers  # > 0: samples decoded by a thread pool, in order

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _samples(self, skip_indices: int = 0) -> Iterator:
        # the sampler's order is fixed by (seed, epoch), so dropping
        # k * batch_size indices undecoded lands on batch k exactly
        it = iter(self.sampler)
        for _ in range(skip_indices):
            next(it, None)
        if self.workers <= 0:
            for idx in it:
                yield self.dataset[int(idx)]
            return
        # at most 2 x workers samples in flight, consumed in submission order
        window = 2 * self.workers
        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            pending: deque = deque()
            try:
                for idx in it:
                    pending.append(ex.submit(self.dataset.__getitem__, int(idx)))
                    if len(pending) >= window:
                        yield pending.popleft().result()
                while pending:
                    yield pending.popleft().result()
            finally:
                for f in pending:
                    f.cancel()

    def _produce(self, skip_batches: int = 0) -> Iterator:
        buf = []
        for sample in self._samples(skip_indices=skip_batches * self.batch_size):
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield self.collate_fn(buf)
                buf = []
        if buf and not self.drop_last:
            yield self.collate_fn(buf)

    def __iter__(self) -> Iterator:
        yield from self.iter_batches(0)

    def iter_batches(self, skip_batches: int = 0) -> Iterator:
        """Iterate the epoch from batch ``skip_batches`` on (mid-epoch
        resume): the skipped batches' samples are never decoded. An error in
        the prefetch thread is raised in the consumer."""
        if self.prefetch <= 0:
            yield from self._produce(skip_batches)
            return
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        sentinel = object()
        error = []
        stop = threading.Event()

        def put(item) -> bool:
            """Queue ``item``; False once the consumer has stopped."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                for item in self._produce(skip_batches):
                    if not put(item):
                        return
            except BaseException as e:  # raised again in the consumer
                error.append(e)
            put(sentinel)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    if error:
                        raise error[0]
                    return
                yield item
        finally:
            stop.set()  # a consumer that stops early (preemption) frees the thread
            t.join(timeout=60)


def build_dataloader(
    dataset,
    sample_per_replica: int = 2,
    dist: bool = False,
    num_replicas: Optional[int] = None,
    rank: Optional[int] = None,
    seed: int = 0,
    max_gts: int = 100,
    canvas: Optional[Tuple[int, int]] = None,
    canvas_buckets: Optional[Sequence[Tuple[int, int]]] = None,
    size_divisor: int = 32,
    prefetch: int = 2,
    workers: int = 0,
    s2d: bool = False,
    max_proposals: Optional[int] = None,
    collate_fn: Optional[Callable] = None,
) -> DataLoader:
    """A loader with grouped sampling and ``collate`` at the given canvas.
    ``dist=True``: this rank's shard (``DistributedGroupSampler``;
    ``num_replicas`` and ``rank`` default to ``torch.distributed``'s), so
    each rank loads ``sample_per_replica`` images a step."""
    if dist:
        sampler = DistributedGroupSampler(dataset, sample_per_replica, num_replicas=num_replicas,
                                          rank=rank, seed=seed)
    else:
        sampler = GroupSampler(dataset, sample_per_replica, seed=seed)

    if collate_fn is None:
        def collate_fn(samples):
            return collate(
                samples,
                max_gts=max_gts,
                canvas=canvas,
                canvas_buckets=canvas_buckets,
                size_divisor=size_divisor,
                s2d=s2d,
                max_proposals=max_proposals,
            )

    return DataLoader(
        dataset,
        sampler,
        batch_size=sample_per_replica,
        collate_fn=collate_fn,
        prefetch=prefetch,
        workers=workers,
    )
