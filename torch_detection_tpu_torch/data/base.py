"""BaseDataset: annotation schema, filtering, group flags, train/test prep.

Counterpart of ``torch_detection_tpu/data/base.py``: samples are dicts of
numpy arrays and DataContainers, images HWC; every random draw of a sample
comes from ``(seed, epoch, idx)``, so an epoch's augmentations repeat
exactly (and on every process); retry-on-empty redraws within the same
aspect group. Gt masks (``with_mask``) wait for the mask tier of the port.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..utils.file_handler import load
from ..utils.misc import is_list_of, random_scale
from .container import DataContainer
from .ops.image import img_aspect_ratio_flag
from .transforms import BackgroundErasing, BboxTransforms, ImageTransforms


class BaseDataset:
    """Annotation schema (one entry per image):

    {
        'filename': 'a.jpg',
        'width': 600,
        'height': 1000,
        'ann': {
            'bboxes': (n, 4) float32 xyxy,
            'labels': (n,) int64 (1-based; 0 is background),
            'bboxes_ignore': (k, 4) float32,
        }
    }
    """

    def __init__(
        self,
        ann_file,
        img_prefix,
        img_means=(0.0, 0.0, 0.0),
        img_stds=(1.0, 1.0, 1.0),
        img_expected_sizes=(1333, 800),
        size_divisor: Optional[int] = None,
        flip_ratio: float = 0.0,
        be_cell_size: int = 32,
        be_random_ratio: float = 0.5,
        proposal_file: Optional[str] = None,
        num_max_proposals: int = 1000,
        with_mask: bool = False,
        with_crowd: bool = False,
        with_label: bool = True,
        test_mode: bool = False,
        with_background_erasing: bool = False,
        debug: bool = False,
        seed: int = 0,
        size_mode: str = "value",
        normalize_on_device: bool = False,
    ):
        if with_mask:
            raise NotImplementedError("with_mask: gt masks wait for the mask tier of the port")
        self.img_infos = self.load_annotations(ann_file)
        self.img_prefix = img_prefix
        self.img_means, self.img_stds = img_means, img_stds
        self.img_expected_sizes = (
            img_expected_sizes if isinstance(img_expected_sizes, list) else [img_expected_sizes]
        )
        self.img_expected_sizes = [tuple(s) for s in self.img_expected_sizes]
        assert is_list_of(self.img_expected_sizes, tuple)
        self.size_divisor = size_divisor
        self.flip_ratio = flip_ratio
        self.be_cell_size = be_cell_size
        self.be_random_ratio = be_random_ratio
        self.seed = seed
        self.size_mode = size_mode
        self.epoch = 0  # set by the loader for the epoch's augmentation stream

        self.proposals = self.load_proposals(proposal_file) if proposal_file is not None else None
        self.num_max_proposals = num_max_proposals

        if not test_mode:
            valid_inds = self._filter_imgs()
            self.img_infos = [self.img_infos[i] for i in valid_inds]
            if self.proposals is not None:
                self.proposals = [self.proposals[i] for i in valid_inds]

        self.with_crowd = with_crowd
        self.with_label = with_label
        self.test_mode = test_mode
        self.with_background_erasing = with_background_erasing
        self.debug = debug
        if self.debug:
            self.img_infos = self.img_infos[:50]

        if not self.test_mode:
            self._set_group_flag()

        self.img_transforms = ImageTransforms(
            img_means=self.img_means, img_stds=self.img_stds,
            size_divisor=self.size_divisor, normalize_on_device=normalize_on_device,
        )
        self.bbox_transforms = BboxTransforms()
        self.background_erasing = BackgroundErasing()

    # ------------------------------------------------------------- loading
    def __len__(self) -> int:
        return len(self.img_infos)

    def load_annotations(self, ann_file) -> List[Dict]:
        return load(ann_file)

    def load_proposals(self, proposal_file):
        return load(proposal_file)

    def _filter_imgs(self, min_size: int = 32) -> List[int]:
        return [
            i
            for i, info in enumerate(self.img_infos)
            if min(info["width"], info["height"]) >= min_size
        ]

    def _set_group_flag(self) -> None:
        """Group 1 = landscape (w/h > 1), group 0 = portrait; the samplers
        batch within a group to pad less."""
        self.flag = np.zeros(len(self.img_infos), dtype=np.uint8)
        for i, info in enumerate(self.img_infos):
            self.flag[i] = img_aspect_ratio_flag(info["width"], info["height"])

    def _sample_rng(self, idx: int, salt: int = 0) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, self.epoch, idx, salt])
        )

    def _rand_another(self, idx: int, attempt: int) -> int:
        pool = np.where(self.flag == self.flag[idx])[0]
        rng = self._sample_rng(idx, salt=1000 + attempt)
        return int(rng.choice(pool))

    def get_ann_info(self, idx: int) -> Dict:
        return self.img_infos[idx]["ann"]

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    # ------------------------------------------------------------- access
    def __getitem__(self, idx: int):
        if self.test_mode:
            return self.prepare_test_img(idx)
        attempt = 0
        while True:
            data = self.prepare_train_img(idx)
            if data is not None:
                return data
            idx = self._rand_another(idx, attempt)
            attempt += 1

    def _meta(self, img_info, img_shape, pad_shape, scale_factor, flipped_flag, flipped_direction):
        return dict(
            filename=img_info["filename"],
            ori_shape=(img_info["height"], img_info["width"], 3),
            img_shape=tuple(img_shape),
            pad_shape=tuple(pad_shape),
            scale_factor=scale_factor,
            flipped_flag=flipped_flag,
            flipped_direction=flipped_direction,
        )

    # ------------------------------------------------------------- train
    def prepare_train_img(self, idx: int) -> Optional[Dict]:
        img_info = self.img_infos[idx]
        img_path = osp.join(self.img_prefix, img_info["filename"])
        rng = self._sample_rng(idx)

        proposals = scores = None
        if self.proposals is not None:
            proposals = np.asarray(self.proposals[idx][: self.num_max_proposals])
            if len(proposals) == 0:
                return None
            if proposals.shape[1] not in (4, 5):
                raise ValueError(f"proposals must be (n,4) or (n,5), got {proposals.shape}")
            if proposals.shape[1] == 5:
                scores = proposals[:, 4, None]
                proposals = proposals[:, :4]

        ann = self.get_ann_info(idx)
        gt_bboxes = np.asarray(ann["bboxes"], np.float32)
        gt_labels = np.asarray(ann["labels"], np.int64)
        gt_bboxes_ignore = np.asarray(ann.get("bboxes_ignore", np.zeros((0, 4))), np.float32)
        if len(gt_bboxes) == 0:
            return None

        expected_size = random_scale(self.img_expected_sizes, self.size_mode, _PyRandom(rng))
        img, img_shape, pad_shape, scale_factor, flipped_flag, flipped_direction = (
            self.img_transforms(img_path, expected_size=expected_size, flip_ratio=self.flip_ratio, rng=rng)
        )
        geometry = (img_shape, scale_factor, flipped_flag, flipped_direction)
        if proposals is not None:
            proposals = self.bbox_transforms(proposals, *geometry)
            if scores is not None:
                proposals = np.hstack([proposals, scores])
        gt_bboxes = self.bbox_transforms(gt_bboxes, *geometry)
        if self.with_background_erasing:
            img = self.background_erasing(
                img, img_shape, gt_bboxes,
                cell_size=self.be_cell_size, random_ratio=self.be_random_ratio, rng=rng,
            )
        if self.with_crowd and len(gt_bboxes_ignore):
            gt_bboxes_ignore = self.bbox_transforms(gt_bboxes_ignore, *geometry)

        img_meta = self._meta(img_info, img_shape, pad_shape, scale_factor, flipped_flag,
                              flipped_direction)
        data = dict(
            img=DataContainer(img, stack=True),
            img_meta=DataContainer(img_meta, cpu_only=True),
            gt_bboxes=DataContainer(gt_bboxes.astype(np.float32)),
        )
        if proposals is not None:
            data["proposals"] = DataContainer(proposals.astype(np.float32))
        if self.with_label:
            data["gt_labels"] = DataContainer(gt_labels)
        if self.with_crowd:
            data["gt_bboxes_ignore"] = DataContainer(gt_bboxes_ignore)
        return data

    # ------------------------------------------------------------- test
    def prepare_test_img(self, idx: int) -> Dict:
        """One entry per (scale, flip) pair of the test-time augmentation,
        each with the ``img_meta`` that maps its boxes back to the original
        image."""
        img_info = self.img_infos[idx]
        img_path = osp.join(self.img_prefix, img_info["filename"])
        rng = self._sample_rng(idx)

        proposal = None
        if self.proposals is not None:
            proposal = np.asarray(self.proposals[idx][: self.num_max_proposals])
            if proposal.shape[1] not in (4, 5):
                raise ValueError(f"proposals must be (n,4) or (n,5), got {proposal.shape}")

        gt_bboxes = self.get_ann_info(idx)["bboxes"] if self.with_background_erasing else None

        def prepare_single_scale(expected_size, flip_ratio):
            img, img_shape, pad_shape, scale_factor, flipped_flag, flipped_direction = (
                self.img_transforms(img_path, expected_size, flip_ratio=flip_ratio, rng=rng)
            )
            geometry = (img_shape, scale_factor, flipped_flag, flipped_direction)
            if gt_bboxes is not None and len(gt_bboxes):
                boxes = self.bbox_transforms(np.asarray(gt_bboxes, np.float32), *geometry)
                img = self.background_erasing(
                    img, img_shape, boxes,
                    cell_size=self.be_cell_size, random_ratio=self.be_random_ratio, rng=rng,
                )
            meta = self._meta(img_info, img_shape, pad_shape, scale_factor, flipped_flag,
                              flipped_direction)
            prop = None
            if proposal is not None:
                p, s = (proposal[:, :4], proposal[:, 4, None]) if proposal.shape[1] == 5 else (proposal, None)
                p = self.bbox_transforms(p, *geometry)
                prop = np.hstack([p, s]) if s is not None else p
            return img, meta, prop

        imgs, img_metas, proposals = [], [], []
        for expected_size in self.img_expected_sizes:
            for flip in ((0, 1) if self.flip_ratio > 0 else (0,)):
                img, meta, prop = prepare_single_scale(expected_size, flip_ratio=flip)
                imgs.append(img)
                img_metas.append(DataContainer(meta, cpu_only=True))
                proposals.append(prop)
        data = dict(img=imgs, img_meta=img_metas)
        if self.proposals is not None:
            data["proposals"] = proposals
        return data


class _PyRandom:
    """Adapter: np.random.Generator -> the random.Random subset random_scale uses."""

    def __init__(self, rng: np.random.Generator):
        self._rng = rng

    def randint(self, a: int, b: int) -> int:
        return int(self._rng.integers(a, b + 1))
