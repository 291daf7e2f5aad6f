"""The aspect-ratio-grouped batch sampler.

Counterpart of ``torch_detection_tpu/data/sampler.py::GroupSampler``:
shuffle within each aspect group, pad each group to a batch multiple by
repeating it, then permute whole batches, all from ``(seed, epoch)``. The
distributed sampler waits for the multi-GPU slice of the port.
"""

from __future__ import annotations

from typing import Iterator, List

import numpy as np


class GroupSampler:
    """Batches are homogeneous in aspect-ratio group, so they pad less."""

    def __init__(self, dataset, sample_per_replica: int = 1, seed: int = 0):
        self.test_mode = getattr(dataset, "test_mode", False)
        self.dataset = dataset
        self.sample_per_replica = sample_per_replica
        self.seed = seed
        self.epoch = 0
        if self.test_mode:
            assert sample_per_replica == 1
            self.num_samples = len(dataset)
        else:
            assert hasattr(dataset, "flag")
            self.flag = dataset.flag.astype(np.int64)
            self.group_sizes = np.bincount(self.flag)
            self.num_samples = int(
                sum(
                    int(np.ceil(s / sample_per_replica)) * sample_per_replica
                    for s in self.group_sizes
                )
            )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        if self.test_mode:
            return iter(range(len(self.dataset)))
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
        chunks: List[np.ndarray] = []
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == i)[0]
            rng.shuffle(idx)
            pad_to = int(np.ceil(size / self.sample_per_replica)) * self.sample_per_replica
            chunks.append(np.resize(idx, pad_to))  # cyclic repeat when pad > size
        batches = np.concatenate(chunks).reshape(-1, self.sample_per_replica)
        out = batches[rng.permutation(len(batches))].reshape(-1)
        assert len(out) == self.num_samples
        return iter(out.tolist())
