"""The port's entry points: config file -> detector -> ``make_inference_fn``.

The slice's configuration, ``configs/faster_rcnn_r50_fpn_coco.py`` with
its ``_base_``, is loaded by the port's own config code and built at full
width (ResNet-50, FPN 256, 80 classes) on the CPU; its detection config
must equal the JAX package's field by field.
"""

from pathlib import Path

import pytest
import torch

from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch.builder import build_detection_cfg, build_detector
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "faster_rcnn_r50_fpn_coco.py"


def test_config_file_loads_as_the_reference_loads_it():
    assert Config.fromfile(CONFIG) == JaxConfig.fromfile(CONFIG)


def test_detection_cfg_matches_reference():
    cfg = build_detection_cfg(Config.fromfile(CONFIG).detection)
    want = jax_builder.build_detection_cfg(JaxConfig.fromfile(CONFIG).detection)
    for field in ("num_classes", "roi_strides", "roi_size", "finest_scale", "rcnn_target_means",
                  "rcnn_target_stds", "score_thr", "nms_iou_thr", "max_detections"):
        assert getattr(cfg, field) == getattr(want, field), field
    for field in ("pre_nms_per_level", "post_nms_top_k", "nms_iou_thr"):
        assert getattr(cfg.proposal_test, field) == getattr(want.proposal_test, field), field
    # the port's constants: a pool of 2 * post_nms_top_k and no min-size filter
    assert want.proposal_test.pool_k == 2 * cfg.proposal_test.post_nms_top_k
    assert want.proposal_test.min_box_size == 0
    for field in ("strides", "ratios", "resolved_scales", "num_base_anchors"):
        assert getattr(cfg.anchor_generator, field) == getattr(want.anchor_generator, field), field
    assert not want.approx_top_k  # the port selects exactly


@pytest.mark.parametrize(
    "det_cfg,match",
    [
        (dict(style="cascade_rcnn"), "style"),  # Cascade R-CNN: a later slice
        (dict(style="faster_rcnn", rpn_num_samples=256), "rpn_num_samples"),  # training key
    ],
)
def test_detection_cfg_refuses_what_is_not_ported(det_cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        build_detection_cfg(det_cfg)


def test_full_width_detector_answers_on_cpu():
    cfg = Config.fromfile(CONFIG)
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == 41_429_156
    infer = make_inference_fn(model, build_detection_cfg(cfg.detection))
    image = torch.randn((1, 64, 96, 3), generator=torch.Generator().manual_seed(0))
    res = infer(image, torch.tensor([[64.0, 96.0]]), torch.tensor([2.0]))
    assert res.boxes.shape == (1, 100, 4) and res.valid.shape == (1, 100)
    assert torch.isfinite(res.boxes).all() and bool(res.valid.any())
    assert float(res.boxes[res.valid].max()) <= 95.0 / 2.0


def test_seed_fixes_the_weights():
    small = dict(
        type="TwoStageDetector",
        backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
        neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16, num_outs=5),
        rpn_head=dict(type="RPNHead", in_channels=16, feat_channels=16, num_base_anchors=3),
        bbox_head=dict(type="BBoxHead", num_classes=3, fc_channels=32),
    )
    a, b, c = (build_detector(small, "float32", device="cpu", seed=s).state_dict() for s in (3, 3, 4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bbox_head.fc1.weight"], c["bbox_head.fc1.weight"])


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_detector(Config.fromfile(CONFIG).model)
