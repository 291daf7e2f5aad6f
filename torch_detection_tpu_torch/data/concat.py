"""ConcatDataset and the config-driven dataset factory.

Counterpart of ``torch_detection_tpu/data/concat.py``: a concatenation
that keeps each image's aspect ``flag``, and ``get_datasets``, which fans
one config with list-valued ``ann_file`` / ``img_prefix`` /
``proposal_file`` out to N datasets.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence

import numpy as np

from ..utils.registry import DATASETS


class ConcatDataset:
    """Concatenation preserving the per-image aspect-ratio ``flag``."""

    def __init__(self, datasets: Sequence):
        assert len(datasets) > 0
        self.datasets = list(datasets)
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()
        if hasattr(self.datasets[0], "flag"):
            self.flag = np.concatenate([d.flag for d in self.datasets])
        self.test_mode = getattr(self.datasets[0], "test_mode", False)

    def __len__(self) -> int:
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx: int):
        ds = bisect.bisect_right(self.cumulative_sizes, idx)
        base = 0 if ds == 0 else self.cumulative_sizes[ds - 1]
        return self.datasets[ds][idx - base]

    def set_epoch(self, epoch: int) -> None:
        for d in self.datasets:
            if hasattr(d, "set_epoch"):
                d.set_epoch(epoch)


def get_datasets(dataset_cfg: Dict):
    """Build 1..N datasets from one config; list-valued ``ann_file`` /
    ``img_prefix`` / ``proposal_file`` fan out, everything else is shared."""
    cfg = dict(dataset_cfg)
    ann_files = cfg.pop("ann_file", None)
    img_prefixes = cfg.pop("img_prefix", None)
    proposal_files = cfg.pop("proposal_file", None)

    def as_list(x, n=None):
        if x is None:
            return None if n is None else [None] * n
        if isinstance(x, (list, tuple)):
            return list(x)
        return [x] if n is None else [x] * n

    ann_files = as_list(ann_files)
    num = len(ann_files) if ann_files is not None else 1
    if ann_files is None:
        ann_files = [None]
    img_prefixes = as_list(img_prefixes, num) or [None] * num
    proposal_files = as_list(proposal_files, num) or [None] * num
    if len(img_prefixes) == 1 < num:
        img_prefixes = img_prefixes * num
    if len(proposal_files) == 1 < num:
        proposal_files = proposal_files * num
    assert len(img_prefixes) == len(proposal_files) == num

    datasets: List = []
    for i in range(num):
        one = dict(cfg)
        if ann_files[i] is not None:
            one["ann_file"] = ann_files[i]
        if img_prefixes[i] is not None:
            one["img_prefix"] = img_prefixes[i]
        if proposal_files[i] is not None:
            one["proposal_file"] = proposal_files[i]
        datasets.append(DATASETS.build(one))
    if len(datasets) == 1:
        return datasets[0]
    return ConcatDataset(datasets)
