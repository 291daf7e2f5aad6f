"""The golden cases of the port, defined once for
``tests/test_torch_golden_map.py`` (on the CPU) and ``chip_smoke.py`` (on
the card): the reference's six narrow RoI models and twelve narrow dense
and set models of ``tests/test_golden_map.py`` as config dicts that both
packages' builders read, their detection configs, steps and bands, the
init seeds whose mean score a family is held to, the golden dataset
config and the Fast R-CNN proposal writer.
This module imports neither JAX nor OpenCV: the card's machine has
neither.
"""

import json

import numpy as np

from torch_detection_tpu_torch.models import detectors, heads
from torch_detection_tpu_torch.ops import anchors, assign
from torch_detection_tpu_torch.utils.file_handler import dump

CANVAS = (64, 64)

# the reference's golden RoI models (tests/test_golden_map.py:266-495, :656-677)
R18 = dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3))
FPN16 = dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16, num_outs=5)
RPN16 = dict(type="RPNHead", in_channels=16, feat_channels=16, num_base_anchors=3)
BBOX64 = dict(type="BBoxHead", num_classes=2, fc_channels=64)
MASK16 = dict(type="FCNMaskHead", num_classes=2, in_channels=16, conv_channels=16, num_convs=1)
GOLDEN_MODELS = {
    "faster_rcnn": dict(type="TwoStageDetector", backbone=R18, neck=FPN16, rpn_head=RPN16,
                        bbox_head=BBOX64),
    "fast_rcnn": dict(type="FastRCNN",
                      backbone=dict(type="ResNet", depth=18, num_stages=3, out_indices=(0, 1, 2)),
                      neck=dict(type="FPN", in_channels=(64, 128, 256), out_channels=16,
                                num_outs=3),
                      bbox_head=BBOX64),
    "cascade_rcnn": dict(type="CascadeRCNN", backbone=R18, neck=FPN16, rpn_head=RPN16,
                         bbox_head=BBOX64, num_stages=3),
    "cascade_mask_rcnn": dict(type="CascadeMaskRCNN", backbone=R18, neck=FPN16, rpn_head=RPN16,
                              bbox_head=BBOX64, mask_head=MASK16, num_stages=3),
    "mask_rcnn": dict(type="MaskRCNN", backbone=R18, neck=FPN16, rpn_head=RPN16,
                      bbox_head=BBOX64, mask_head=MASK16),
    "sparse_rcnn": dict(type="SparseRCNN", backbone=R18,
                        neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=64,
                                  num_outs=4),
                        num_proposals=16, num_stages=2, num_classes=2, d_model=64, nhead=4,
                        dim_feedforward=128, dynamic_dim=16, roi_strides=(4, 8, 16, 32)),
}

# the reference's golden dense and set models (tests/test_golden_map.py:124-262, :499-519,
# :553-652, :680-707)
R18_C4 = dict(type="ResNet", depth=18, num_stages=3, out_indices=(0, 1, 2))
FPN32 = dict(type="FPN", in_channels=(64, 128, 256), out_channels=32, num_outs=3)


def _dense(head: str, **kw) -> dict:
    """A ResNet-18 (3 stages), FPN 32 x 3 detector with a 1-conv ``head``."""
    return dict(type="SingleStageDetector", backbone=R18_C4, neck=FPN32,
                head=dict(type=head, num_classes=2, in_channels=32, feat_channels=32,
                          stacked_convs=1, **kw))


GOLDEN_MODELS.update({
    "retinanet": _dense("RetinaHead", num_base_anchors=9),
    "fcos": _dense("FCOSHead"),
    "atss": _dense("ATSSHead"),
    "yolov3": dict(type="SingleStageDetector",
                   backbone=dict(type="Darknet", depth=53, stages=(1, 1, 1, 1, 1),
                                 base_channels=8, out_indices=(2, 3, 4)),
                   neck=dict(type="YOLOV3Neck", in_channels=(64, 128, 256),
                             out_channels=(64, 32, 16)),
                   head=dict(type="YOLOV3Head", num_classes=2, anchors_per_level=1,
                             in_channels=(64, 32, 16), out_channels=(128, 64, 32))),
    "centernet": dict(type="SingleStageDetector",
                      backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,)),
                      neck=dict(type="CTResNetNeck", in_channels=512,
                                num_deconv_filters=(64, 32, 32)),
                      head=dict(type="CenterNetHead", num_classes=2, in_channels=32,
                                feat_channels=32)),
    "ssd": dict(type="SingleStageDetector",
                backbone=dict(type="ResNet", depth=18, num_stages=3, out_indices=(1, 2)),
                neck=None,
                head=dict(type="SSDHead", num_classes=2, in_channels=(128, 256),
                          anchors_per_level=(6, 6))),
    "yolox": dict(type="SingleStageDetector",
                  backbone=dict(type="CSPDarknet", deepen_factor=0.33, widen_factor=0.25,
                                out_indices=(2, 3, 4)),
                  neck=dict(type="YOLOXPAFPN", in_channels=(64, 128, 256), out_channels=64,
                            num_csp_blocks=1),
                  head=dict(type="YOLOXHead", num_classes=2, in_channels=64, feat_channels=64,
                            stacked_convs=1)),
    "gfl": _dense("GFLHead", reg_max=8),
    "foveabox": _dense("FoveaHead"),
    "detr": dict(type="DETR", backbone=dict(type="ResNet", depth=18, num_stages=3,
                                            out_indices=(2,)),
                 num_classes=2, d_model=64, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
                 dim_feedforward=128, num_queries=16),
    "free_anchor": _dense("RetinaHead", num_base_anchors=9),
    "paa": _dense("PAAHead"),
})


def _dense_cfg(name: str, d, a, s):
    """The reference's detection config of golden dense or set family ``name``."""
    top = dict(score_thr=0.05, max_detections=10, pre_nms_top_k=100)
    ranked = dict(top, pre_select_per_level=50)
    # anchor sizes 16/32/64 (ATSS, GFL) and 32/64/128 (PAA) at strides 4/8/16
    atss_anchors = a.AnchorGenerator(strides=(4, 8, 16), ratios=(1.0,), octave_base_scale=4.0,
                                     scales_per_octave=1)
    if name == "retinanet":
        return d.RetinaNetConfig(num_classes=2,
                                 anchor_generator=a.AnchorGenerator(strides=(4, 8, 16)), **top)
    if name == "fcos":
        return d.FCOSConfig(num_classes=2, strides=(4, 8, 16),
                            regress_ranges=((-1.0, 16.0), (16.0, 32.0), (32.0, 1e8)), **ranked)
    if name == "atss":
        return d.ATSSConfig(num_classes=2, anchor_generator=atss_anchors,
                            assigner=s.ATSSAssigner(topk=9), **ranked)
    if name == "yolov3":
        return d.YOLOV3Config(
            num_classes=2, anchor_generator=a.YOLOAnchorGenerator(
                strides=(32, 16, 8),
                base_sizes=(((28.0, 28.0),), ((22.0, 22.0),), ((16.0, 16.0),))), **ranked)
    if name == "centernet":
        return d.CenterNetConfig(num_classes=2, score_thr=0.05, max_detections=10)
    if name == "ssd":
        return d.SSDConfig(num_classes=2, anchor_generator=a.SSDAnchorGenerator(
            strides=(8, 16), min_sizes=(12.0, 26.0), max_sizes=(26.0, 48.0),
            ratios=((2.0, 3.0), (2.0, 3.0))), **top)
    if name == "yolox":
        return d.YOLOXConfig(num_classes=2, max_detections=10, pre_nms_top_k=100, score_thr=0.01)
    if name == "gfl":
        return d.GFLConfig(num_classes=2, anchor_generator=atss_anchors,
                           assigner=s.ATSSAssigner(topk=9), reg_max=8, **ranked)
    if name == "foveabox":
        return d.FoveaConfig(num_classes=2, strides=(4, 8, 16), base_edges=(8.0, 16.0, 32.0),
                             scale_ranges=((1.0, 16.0), (8.0, 32.0), (16.0, 1e8)), **ranked)
    if name == "detr":
        return d.DETRConfig(num_classes=2, num_queries=16, max_detections=10, score_thr=0.05)
    if name == "free_anchor":
        return d.FreeAnchorConfig(num_classes=2,
                                  anchor_generator=a.AnchorGenerator(strides=(4, 8, 16)),
                                  pre_anchor_topk=16, **top)
    if name == "paa":
        return d.PAAConfig(num_classes=2, anchor_generator=a.AnchorGenerator(
            strides=(4, 8, 16), ratios=(1.0,), octave_base_scale=8.0, scales_per_octave=1),
            topk=8, **ranked)
    raise KeyError(name)


def golden_detection_cfg(name: str, d=detectors, h=heads, a=anchors, s=assign):
    """The reference's detection config of golden family ``name``, built from
    either package's detectors, heads, anchors and assign modules."""
    if name in GOLDEN_DENSE:
        return _dense_cfg(name, d, a, s)
    if name == "fast_rcnn":
        return d.FastRCNNConfig(num_classes=2, roi_strides=(4, 8, 16), rcnn_num_samples=32,
                                max_detections=10)
    if name == "sparse_rcnn":
        return d.SparseRCNNConfig(num_classes=2, num_proposals=16, max_detections=10,
                                  score_thr=0.05)
    proposals = h.ProposalConfig(pre_nms_per_level=128, post_nms_top_k=64)
    extra = {"mask_rcnn": dict(mask_roi_size=7, mask_size=14),
             "cascade_mask_rcnn": dict(mask_roi_size=7, mask_size=14, mask_num_rois=16)}
    cls = {"faster_rcnn": "FasterRCNNConfig", "cascade_rcnn": "CascadeRCNNConfig",
           "cascade_mask_rcnn": "CascadeMaskRCNNConfig", "mask_rcnn": "MaskRCNNConfig"}[name]
    return getattr(d, cls)(
        num_classes=2,
        anchor_generator=a.AnchorGenerator(strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0),
                                           scales=(8.0,), octave_base_scale=None),
        proposal_train=proposals, proposal_test=proposals, rpn_num_samples=64,
        rcnn_num_samples=32, max_detections=10, **extra.get(name, {}))


# name: (steps, training keywords, band); the reference's (tests/test_golden_map.py)
GOLDEN_ROI = {
    "faster_rcnn": (400, {}, {"mAP_50": 0.5, "mAP": 0.3}),
    "fast_rcnn": (300, dict(proposals=True), {"mAP_50": 0.5, "mAP": 0.3}),
    "cascade_rcnn": (400, {}, {"mAP_50": 0.5, "mAP": 0.3}),
    "cascade_mask_rcnn": (400, dict(with_mask=True, segm=True),
                          {"mAP_50": 0.5, "mAP": 0.3, "segm_mAP_50": 0.3}),
    "mask_rcnn": (400, dict(with_mask=True, segm=True),
                  {"mAP_50": 0.5, "mAP": 0.3, "segm_mAP_50": 0.3}),
    "sparse_rcnn": (400, {}, {"mAP_50": 0.25, "mAP": 0.12}),
}
BOX_BAND = {"mAP_50": 0.5, "mAP": 0.15}
GOLDEN_DENSE = {
    "retinanet": (200, {}, BOX_BAND),
    "fcos": (200, {}, BOX_BAND),
    "atss": (200, {}, BOX_BAND),
    "yolov3": (200, {}, BOX_BAND),
    "centernet": (300, {}, BOX_BAND),
    "ssd": (200, {}, BOX_BAND),
    "yolox": (400, {}, {"mAP_50": 0.5, "mAP": 0.3}),
    "gfl": (200, {}, {"mAP_50": 0.8, "mAP": 0.5}),
    "foveabox": (200, {}, BOX_BAND),
    "detr": (300, {}, {"mAP_50": 0.4, "mAP": 0.2}),
    "free_anchor": (200, {}, BOX_BAND),
    "paa": (200, {}, BOX_BAND),
}
GOLDEN_CASES = {**GOLDEN_ROI, **GOLDEN_DENSE}

# The init seeds whose mean score a family is held to; seed 0 alone for the others.
# Sparse R-CNN's mAP_50 at one seed lies anywhere from 0.15 to 0.80 (seeds 0-7 on an
# H100), so one seed falls on either side of the band, in the reference as in the port
# (tests/test_torch_golden_map.py holds the reference to the same mean at these seeds).
GOLDEN_SEEDS = {"sparse_rcnn": tuple(range(8))}


def golden_seeds(name: str) -> tuple:
    """The init seeds of golden family ``name`` (``GOLDEN_SEEDS``)."""
    return GOLDEN_SEEDS.get(name, (0,))


def mean_scores(results, keys) -> dict:
    """The mean of each metric of ``keys`` over the per-seed ``results``."""
    return {k: float(np.mean([r[k] for r in results])) for k in keys}


def data_cfg(golden, train: bool, with_mask: bool = False, proposal_file=None) -> dict:
    """The golden set's dataset config: ``golden`` is its (annotation file,
    image folder); masks read in training with ``with_mask``; 16 proposals
    an image from ``proposal_file``."""
    ann_file, img_dir = golden
    cfg = dict(type="CocoDataset", ann_file=ann_file, img_prefix=img_dir, img_means=(0, 0, 0),
               img_stds=(1, 1, 1), img_expected_sizes=CANVAS, size_divisor=32, flip_ratio=0.0,
               test_mode=not train, with_mask=with_mask and train)
    if proposal_file is not None:
        cfg.update(proposal_file=proposal_file, num_max_proposals=16)
    return cfg


def write_golden_proposals(ann_file, path) -> str:
    """The reference's Fast R-CNN proposals (``tests/test_golden_map.py:300-325``):
    four jitters of each gt (``default_rng(5)``, sigma 2 px, score 0.9) and
    four background distractors an image (score 0.1), clipped to the image,
    written as pkl by the port's ``dump``."""
    rng = np.random.default_rng(5)
    with open(ann_file) as f:
        coco = json.load(f)
    by_img = {}
    for a in coco["annotations"]:
        by_img.setdefault(a["image_id"], []).append(a["bbox"])
    props = []
    for im in coco["images"]:
        rows = []
        for (x, y, w, h) in by_img.get(im["id"], []):
            for _ in range(4):
                d = rng.normal(0, 2.0, 4)
                rows.append([x + d[0], y + d[1], x + w - 1 + d[2], y + h - 1 + d[3], 0.9])
        for _ in range(4):
            x0, y0 = rng.uniform(0, 40, 2)
            rows.append([x0, y0, x0 + rng.uniform(8, 20), y0 + rng.uniform(8, 20), 0.1])
        arr = np.asarray(rows, np.float32)
        arr[:, 0::2] = arr[:, 0::2].clip(0, im["width"] - 1)
        arr[:, 1::2] = arr[:, 1::2].clip(0, im["height"] - 1)
        props.append(arr)
    dump(props, str(path))
    return str(path)
