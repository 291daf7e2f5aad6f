"""Golden mAP of the port: a narrow model trained on the learnable synthetic
mini-COCO of ``data_fixtures.make_golden_coco`` (8 PNGs of 64 x 64, 1-2
bright squares of two classes an image) through the port's data tier, then
scored by the port's ``evaluate_detector``; each family's band is the
reference's (``tests/test_golden_map.py``), not loosened.

Marked ``slow`` like the reference's file: it stays outside Tier-1
(``TD_RUN_SLOW=1`` runs it). The reference's ``optax.adam(lr)`` is the
port's AdamW with weight decay 0; the weights are the port's own seeded
init, so the scores are the port's, held to the reference's bands.

SOLOv2 (the reference's ``test_golden_map_solov2``): ResNet-18, FPN 32,
2-conv GN(8) towers, E = 16, grids (12, 10, 8, 6, 4), 400 steps of b4 at
lr 1e-3; band ``segm_mAP_50 >= 0.3`` and ``mAP_50 >= 0.3``.
"""

import numpy as np
import pytest
import torch

from data_fixtures import make_golden_coco
from torch_detection_tpu_torch.builder import build_detector, build_loss_fn
from torch_detection_tpu_torch.data import build_dataloader, get_datasets
from torch_detection_tpu_torch.engine.validate import evaluate_detector
from torch_detection_tpu_torch.models.detectors import SOLOV2Config
from torch_detection_tpu_torch.parallel.train_step import make_optimizer, make_train_step

CANVAS = (64, 64)
SOLOV2_MODEL = dict(
    type="SOLOV2",
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=32, num_outs=5),
    head=dict(type="SOLOV2Head", num_classes=2, in_channels=32, feat_channels=32,
              kernel_channels=16, stacked_convs=2, grid_numbers=(12, 10, 8, 6, 4),
              norm_groups=8),
    mask_feat_head=dict(type="MaskFeatHead", in_channels=32, feat_channels=32, out_channels=16,
                        num_inputs=4, norm_groups=8),
)
SOLOV2_CFG = SOLOV2Config(
    num_classes=2, grid_numbers=(12, 10, 8, 6, 4),
    scale_ranges=((1, 32), (16, 48), (32, 64), (48, 96), (64, 256)),
    max_pos_cells=64, pre_nms_top_k=32, max_detections=10, mask_out_size=14, score_thr=0.05,
    update_thr=0.02,
)


@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    return make_golden_coco(str(tmp_path_factory.mktemp("golden")))


def data_cfg(golden, train: bool) -> dict:
    ann_file, img_dir = golden
    return dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir, img_means=(0, 0, 0),
                img_stds=(1, 1, 1), img_expected_sizes=CANVAS, size_divisor=32, flip_ratio=0.0,
                test_mode=not train, with_mask=True)


def train_and_eval(golden, model_cfg, det_cfg, steps: int, lr: float = 1e-3, batch: int = 4,
                   seed: int = 0) -> dict:
    """The reference's ``_train_and_eval`` on the port: the loader at seed 3
    with ``max_gts`` 4 on the 64 x 64 canvas, AdamW without weight decay,
    ``steps`` steps; the loss must fall; then ``evaluate_detector`` with
    the mask metrics on the val split."""
    loader = build_dataloader(get_datasets(data_cfg(golden, True)), sample_per_replica=batch,
                              seed=3, max_gts=4, canvas=CANVAS, prefetch=0)
    model = build_detector(model_cfg, "float32", device="cpu", seed=seed).train()
    optimizer = make_optimizer(model.parameters(), lr, weight_decay=0.0, kind="adamw")
    step = make_train_step(build_loss_fn(model, det_cfg, rng_seed=seed), optimizer)
    losses, epoch = [], 0
    while len(losses) < steps:
        loader.set_epoch(epoch)
        epoch += 1
        for b in loader:
            metrics = step({k: torch.from_numpy(np.asarray(v)) for k, v in b.items()
                            if k != "img_meta"})
            losses.append(float(metrics["loss"]))
            if len(losses) >= steps:
                break
    assert np.isfinite(losses[-1]) and losses[-1] < losses[0], (losses[0], losses[-1])
    model.eval()
    return evaluate_detector(model, det_cfg, get_datasets(data_cfg(golden, False)), batch=batch,
                             canvas=CANVAS, segm=True)


@pytest.mark.slow
def test_golden_map_solov2(golden):
    torch.set_num_threads(4)
    res = train_and_eval(golden, SOLOV2_MODEL, SOLOV2_CFG, steps=400)
    # the reference's band: box mAP rides the stride-4 mask-extent boxes
    assert res["segm_mAP_50"] >= 0.3, res
    assert res["mAP_50"] >= 0.3, res
