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
from torch_detection_tpu_torch.ops.assign import MaxIoUAssigner
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
        (dict(style="mask_scoring_rcnn"), "style"),  # a style of neither builder
        (dict(style="faster_rcnn", rpn_pos_fraction=0.5), "rpn_pos_fraction"),  # neither reads it
        (dict(style="fast_rcnn", anchor=dict(strides=(4,))), "anchor"),  # Fast R-CNN has none
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


# each two-stage style (and Sparse R-CNN's and DETR's), its loss and its inference
# (box and, where it has one, mask); the cascade configs subclass
# FasterRCNNConfig, so a dispatch that tested a base class first would send
# them down Faster R-CNN's path
_FAMILIES = {
    "faster_rcnn": ("faster_rcnn_loss", "faster_rcnn_inference", None),
    "mask_rcnn": ("mask_rcnn_loss", "faster_rcnn_inference", "mask_rcnn_inference"),
    "cascade_rcnn": ("cascade_rcnn_loss", "cascade_rcnn_inference", None),
    "cascade_mask_rcnn": ("cascade_mask_rcnn_loss", "cascade_rcnn_inference",
                          "cascade_mask_rcnn_inference"),
    "fast_rcnn": ("fast_rcnn_loss", "fast_rcnn_inference", None),
    "sparse_rcnn": ("sparse_rcnn_train_loss", "sparse_rcnn_inference", None),
    "detr": ("detr_train_loss", "detr_inference", None),
}
# the single-stage styles; FreeAnchorConfig subclasses RetinaNetConfig, so a
# dispatch that tested RetinaNet first would train it on retina_loss; SSD,
# YOLOv3, YOLOX and CenterNet subclass no other config
_DENSE_FAMILIES = {
    "retina": ("retina_loss", "retina_inference", None),
    "fcos": ("fcos_loss", "fcos_inference", None),
    "atss": ("atss_loss", "atss_inference", None),
    "gfl": ("gfl_loss", "gfl_inference", None),
    "fovea": ("fovea_loss", "fovea_inference", None),
    "free_anchor": ("free_anchor_loss", "retina_inference", None),
    "paa": ("paa_loss", "paa_inference", None),
    "ssd": ("ssd_loss", "ssd_inference", None),
    "yolo": ("yolo_loss", "yolo_inference", None),
    "yolox": ("yolox_loss", "yolox_inference", None),
    "centernet": ("centernet_loss", "centernet_inference", None),
}


def _record_dispatch(monkeypatch):
    """Every loss and inference the dispatch can pick replaced by a
    recorder of its name."""
    from torch_detection_tpu_torch import builder
    from torch_detection_tpu_torch.engine import validate

    def recorder(name):
        def record(*args, **kwargs):
            return {"loss": torch.zeros(()), "called": name}
        return record

    families = {**_FAMILIES, **_DENSE_FAMILIES}
    for name in {loss for loss, _, _ in families.values()}:
        monkeypatch.setattr(builder, name, recorder(name))
    for name in {f for _, box, mask in families.values() for f in (box, mask) if f}:
        monkeypatch.setattr(validate, name, recorder(name))
    return builder


@pytest.mark.parametrize("style", _FAMILIES)
def test_each_two_stage_style_reaches_its_own_loss_and_inference(style, monkeypatch):
    """Every loss and inference the dispatch can pick is replaced by a
    recorder of its name; each style's config must reach its own."""
    builder = _record_dispatch(monkeypatch)
    loss, box, mask = _FAMILIES[style]
    det_cfg = build_detection_cfg(dict(style=style))
    loss_fn = builder.build_loss_fn(torch.nn.Linear(1, 1), det_cfg)
    assert loss_fn({})[1]["called"] == loss
    args = (None, None, None, None, None) if style == "fast_rcnn" else (None, None, None)
    assert make_inference_fn(None, det_cfg)(*args)["called"] == box
    if mask is None:
        with pytest.raises(ValueError, match="mask-capable"):
            make_inference_fn(None, det_cfg, segm=True)
    else:
        assert make_inference_fn(None, det_cfg, segm=True)(*args)["called"] == mask


@pytest.mark.parametrize("style", _DENSE_FAMILIES)
def test_each_single_stage_style_reaches_its_own_loss_and_inference(style, monkeypatch):
    """As the two-stage test, for the single-stage styles: the model's
    outputs go to the style's own loss (FreeAnchor's, never RetinaNet's)
    and its own inference (FreeAnchor's is RetinaNet's)."""
    builder = _record_dispatch(monkeypatch)
    loss, box, _ = _DENSE_FAMILIES[style]
    det_cfg = build_detection_cfg(dict(style=style))
    batch = {k: None for k in ("image", "gt_boxes", "gt_labels", "gt_valid", "img_shape")}
    loss_fn = builder.build_loss_fn(lambda image: ((), ()), det_cfg)
    assert loss_fn(batch)[1]["called"] == loss
    assert make_inference_fn(None, det_cfg)(None, None, None)["called"] == box
    with pytest.raises(ValueError, match="mask-capable"):
        make_inference_fn(None, det_cfg, segm=True)


def test_paa_assigner_drops_foreign_keys_and_refuses_what_is_not_ported():
    """A PAA config's merged ``assigner`` keeps MaxIoUAssigner's fields, as
    the reference's builder (``_base_`` the ATSS config leaves ``topk``);
    ``gt_max_assign_all`` and ``ignore_iof_thr`` build for PAA and
    FreeAnchor and equal the reference's fields; a foreign key raises for
    every style but PAA."""
    merged = dict(topk=9, pos_iou_thr=0.1, neg_iou_thr=0.1, min_pos_iou=0.0)
    got = build_detection_cfg(dict(style="paa", assigner=merged))
    want = jax_builder.build_detection_cfg(dict(style="paa", assigner=merged))
    for field in ("pos_iou_thr", "neg_iou_thr", "min_pos_iou"):
        assert getattr(got.assigner, field) == getattr(want.assigner, field) == merged[field]
    assert want.assigner.gt_max_assign_all and got.assigner.gt_max_assign_all
    build_detection_cfg(dict(style="paa", assigner=dict(merged, gt_max_assign_all=True)))
    for style in ("paa", "free_anchor"):
        for extra in (dict(ignore_iof_thr=0.5), dict(gt_max_assign_all=False)):
            cfg = dict(style=style, assigner=dict(merged, **extra))
            if style != "paa":
                cfg["assigner"].pop("topk")
            got = build_detection_cfg(cfg).assigner
            asked = dict(merged, **extra)
            for field in ("pos_iou_thr", "gt_max_assign_all", "ignore_iof_thr"):
                assert getattr(got, field) == asked.get(field, getattr(MaxIoUAssigner(), field))
    with pytest.raises(TypeError, match="topk"):  # only PAA drops foreign keys
        build_detection_cfg(dict(style="free_anchor", assigner=merged))
