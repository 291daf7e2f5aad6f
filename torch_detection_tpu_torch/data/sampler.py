"""The aspect-ratio-grouped batch sampler.

Counterpart of ``torch_detection_tpu/data/sampler.py::GroupSampler``:
shuffle within each aspect group, pad each group to a batch multiple by
repeating it, then permute whole batches, all from ``(seed, epoch)``; and
``DistributedGroupSampler``, each rank's share of that order.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

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


class DistributedGroupSampler:
    """One rank's shard of the grouped order, index for index the
    reference's ``DistributedGroupSampler``.

    Every rank computes the same epoch-seeded order: each group shuffled
    by ``SeedSequence([seed, epoch])``, padded cyclically to a multiple of
    ``sample_per_replica * num_replicas``, cut into batches of
    ``sample_per_replica`` whose order is permuted; rank ``r`` takes the
    contiguous slice ``[r * num_samples, (r + 1) * num_samples)``. In test
    mode the indices, padded cyclically to ``num_replicas * num_samples``,
    are dealt out strided (rank ``r`` takes ``r, r + N, ...``), so each
    rank keeps the evaluation order. ``num_replicas`` and ``rank`` default
    to the data ranks' count and this rank's place among them
    (``parallel.distributed.data_size``/``data_rank``: the world's, without
    a ``model`` axis); the ranks of a model group load the same shard."""

    def __init__(
        self,
        dataset,
        sample_per_replica: int = 1,
        num_replicas: Optional[int] = None,
        rank: Optional[int] = None,
        seed: int = 0,
    ):
        if num_replicas is None or rank is None:
            from ..parallel.distributed import data_rank, data_size

            num_replicas = data_size() if num_replicas is None else num_replicas
            rank = data_rank() if rank is None else rank
        if not 0 <= rank < num_replicas:
            raise ValueError(f"rank {rank} is not one of {num_replicas} replicas")
        self.test_mode = getattr(dataset, "test_mode", False)
        self.dataset = dataset
        self.sample_per_replica = sample_per_replica
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0
        if self.test_mode:
            assert sample_per_replica == 1
            self.num_samples = int(np.ceil(len(dataset) / num_replicas))
        else:
            assert hasattr(dataset, "flag")
            self.flag = dataset.flag.astype(np.int64)
            self.group_sizes = np.bincount(self.flag)
            self.num_samples = int(
                sum(
                    int(np.ceil(s / sample_per_replica / num_replicas)) * sample_per_replica
                    for s in self.group_sizes
                )
            )
        self.total_size = self.num_samples * self.num_replicas

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.num_samples

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, self.epoch]))
        if self.test_mode:
            indices = list(range(len(self.dataset)))
            indices += indices[: self.total_size - len(indices)]
            return iter(indices[self.rank: self.total_size: self.num_replicas])
        chunks: List[np.ndarray] = []
        per_round = self.sample_per_replica * self.num_replicas
        for i, size in enumerate(self.group_sizes):
            if size == 0:
                continue
            idx = np.where(self.flag == i)[0]
            idx = idx[rng.permutation(int(size))]
            chunks.append(np.resize(idx, int(np.ceil(size / per_round)) * per_round))
        indices = np.concatenate(chunks)
        assert len(indices) == self.total_size
        batches = indices.reshape(-1, self.sample_per_replica)
        flat = batches[rng.permutation(len(batches))].reshape(-1)
        offset = self.num_samples * self.rank
        return iter(flat[offset: offset + self.num_samples].tolist())
