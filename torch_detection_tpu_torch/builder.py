"""Config -> objects: the detector, its detection config, its loss, the
training loader, and the optimizer with its learning-rate schedule.

Counterpart of ``torch_detection_tpu/builder.py`` for the ``retina``
(the default), ``faster_rcnn``, ``mask_rcnn``, ``cascade_rcnn``,
``cascade_mask_rcnn``, ``fast_rcnn``, ``sparse_rcnn``, ``detr``, ``fcos``,
``atss``, ``gfl``, ``fovea``, ``free_anchor``, ``paa``, ``ssd``, ``yolo``,
``yolox``, ``centernet`` and ``solov2`` styles: every style of the
reference's builder.
"""

from __future__ import annotations

import copy
import functools
import logging
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from .data import build_dataloader, get_datasets
from .engine.trainer import detection_lr_schedule
from .models.detectors import (
    ATSSConfig,
    CascadeMaskRCNNConfig,
    CascadeRCNNConfig,
    CenterNetConfig,
    DETRConfig,
    FasterRCNNConfig,
    FastRCNNConfig,
    FCOSConfig,
    FoveaConfig,
    FreeAnchorConfig,
    GFLConfig,
    MaskRCNNConfig,
    PAAConfig,
    RetinaNetConfig,
    SOLOV2Config,
    SparseRCNNConfig,
    SSDConfig,
    YOLOV3Config,
    YOLOXConfig,
    atss_loss,
    cascade_mask_rcnn_loss,
    cascade_rcnn_loss,
    centernet_loss,
    detr_train_loss,
    fast_rcnn_loss,
    faster_rcnn_loss,
    fcos_loss,
    fovea_loss,
    free_anchor_loss,
    gfl_loss,
    mask_rcnn_loss,
    paa_loss,
    retina_loss,
    sampling_noise,
    solov2_loss,
    sparse_rcnn_train_loss,
    ssd_loss,
    yolo_loss,
    yolox_loss,
)
from .models.inits import init_weights
from .ops.anchors import AnchorGenerator, SSDAnchorGenerator, YOLOAnchorGenerator
from .ops.assign import ATSSAssigner, GridAssigner, MaxIoUAssigner
from .parallel.distributed import broadcast_module, data_size, global_rows, world_size
from .parallel.mesh import make_mesh, shard_model
from .parallel.tensor_parallel import apply_tensor_parallel
from .parallel.train_step import Optimizer, make_optimizer
from .utils.registry import DETECTORS

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the dtypes the kernels take

# detection-config keys each style's paths read (besides ``anchor``)
_RETINA_KEYS = ("num_classes", "target_means", "target_stds", "focal_gamma", "focal_alpha",
                "smooth_l1_beta", "reg_loss_weight", "score_thr", "nms_iou_thr",
                "pre_select_per_level", "pre_nms_top_k", "max_detections", "nms_method",
                "soft_sigma")
_FAST_RCNN_KEYS = ("num_classes", "score_thr", "nms_iou_thr", "max_detections", "roi_size",
                   "finest_scale", "rcnn_num_samples", "rcnn_pos_fraction", "smooth_l1_beta")
_FASTER_RCNN_KEYS = _FAST_RCNN_KEYS + ("rpn_num_samples",)
_MASK_KEYS = ("mask_size", "mask_roi_size", "mask_loss_weight")
_CASCADE_KEYS = ("num_stages", "stage_pos_ious", "stage_loss_weights", "stage_target_stds")
_SPARSE_KEYS = ("num_classes", "num_proposals", "cls_weight", "l1_weight", "giou_weight",
                "focal_gamma", "focal_alpha", "score_thr", "max_detections")
_DETR_KEYS = ("num_classes", "num_queries", "cls_weight", "bbox_weight", "giou_weight",
              "eos_coef", "aux_loss", "score_thr", "max_detections")
_FCOS_KEYS = ("num_classes", "strides", "regress_ranges", "focal_gamma", "focal_alpha",
              "score_thr", "nms_iou_thr", "pre_select_per_level", "pre_nms_top_k",
              "max_detections")
_ATSS_KEYS = ("num_classes", "target_means", "target_stds", "focal_gamma", "focal_alpha",
              "reg_loss_weight", "score_thr", "nms_iou_thr", "pre_select_per_level",
              "pre_nms_top_k", "max_detections")
_GFL_KEYS = ("num_classes", "reg_max", "qfl_beta", "qfl_weight", "dfl_weight", "giou_weight",
             "score_thr", "nms_iou_thr", "pre_select_per_level", "pre_nms_top_k",
             "max_detections")
_FOVEA_KEYS = ("num_classes", "strides", "base_edges", "scale_ranges", "sigma", "focal_gamma",
               "focal_alpha", "smooth_l1_beta", "reg_loss_weight", "score_thr", "nms_iou_thr",
               "pre_select_per_level", "pre_nms_top_k", "max_detections")
_FREE_ANCHOR_KEYS = _RETINA_KEYS + ("pre_anchor_topk", "bbox_thr", "bag_gamma", "bag_alpha",
                                    "loc_loss_weight")
_PAA_KEYS = ("num_classes", "target_means", "target_stds", "topk", "gmm_iters", "focal_gamma",
             "focal_alpha", "reg_loss_weight", "iou_loss_weight", "score_thr", "nms_iou_thr",
             "pre_select_per_level", "pre_nms_top_k", "max_detections", "score_voting",
             "voting_sigma")
_SSD_KEYS = ("num_classes", "target_means", "target_stds", "neg_pos_ratio", "smooth_l1_beta",
             "score_thr", "nms_iou_thr", "pre_nms_top_k", "max_detections")
_YOLO_KEYS = ("num_classes", "loss_xy_weight", "loss_wh_weight", "loss_conf_weight",
              "loss_cls_weight", "conf_thr", "score_thr", "nms_iou_thr", "pre_select_per_level",
              "pre_nms_top_k", "max_detections")
_YOLOX_KEYS = ("num_classes", "strides", "center_radius", "candidate_topk", "iou_cost_weight",
               "reg_loss_weight", "use_l1", "score_thr", "nms_iou_thr", "pre_nms_top_k",
               "max_detections")
_CENTERNET_KEYS = ("num_classes", "down_ratio", "min_overlap", "heat_weight", "wh_weight",
                   "off_weight", "score_thr", "max_detections", "nms_iou_thr")
_SOLOV2_KEYS = ("num_classes", "grid_numbers", "scale_ranges", "sigma", "mask_stride",
                "focal_gamma", "focal_alpha", "dice_weight", "max_pos_cells", "score_thr",
                "update_thr", "mask_thr", "pre_nms_top_k", "max_detections", "nms_method",
                "nms_sigma", "mask_out_size")
# style -> (config class, its keys, the field the ``assigner`` key sets or None)
_STYLES = {"retina": (RetinaNetConfig, _RETINA_KEYS, "assigner"),
           "faster_rcnn": (FasterRCNNConfig, _FASTER_RCNN_KEYS, None),
           "mask_rcnn": (MaskRCNNConfig, _FASTER_RCNN_KEYS + _MASK_KEYS, None),
           "cascade_rcnn": (CascadeRCNNConfig, _FASTER_RCNN_KEYS + _CASCADE_KEYS, None),
           "cascade_mask_rcnn": (CascadeMaskRCNNConfig,
                                 _FASTER_RCNN_KEYS + _CASCADE_KEYS + _MASK_KEYS, None),
           "fast_rcnn": (FastRCNNConfig, _FAST_RCNN_KEYS, "rcnn_assigner"),
           "sparse_rcnn": (SparseRCNNConfig, _SPARSE_KEYS, None),
           "detr": (DETRConfig, _DETR_KEYS, None),
           "fcos": (FCOSConfig, _FCOS_KEYS, None),
           "atss": (ATSSConfig, _ATSS_KEYS, "assigner"),
           "gfl": (GFLConfig, _GFL_KEYS, "assigner"),
           "fovea": (FoveaConfig, _FOVEA_KEYS, None),
           "free_anchor": (FreeAnchorConfig, _FREE_ANCHOR_KEYS, "assigner"),
           "paa": (PAAConfig, _PAA_KEYS, "assigner"),
           "ssd": (SSDConfig, _SSD_KEYS, "assigner"),
           "yolo": (YOLOV3Config, _YOLO_KEYS, "assigner"),
           "yolox": (YOLOXConfig, _YOLOX_KEYS, None),
           "centernet": (CenterNetConfig, _CENTERNET_KEYS, None),
           "solov2": (SOLOV2Config, _SOLOV2_KEYS, None)}
# the assigner class of each config's assigner field (the R-CNNs', RetinaNet's, FreeAnchor's,
# PAA's and SSD's MaxIoUAssigner)
_ASSIGNERS = {ATSSConfig: ATSSAssigner, GFLConfig: ATSSAssigner, YOLOV3Config: GridAssigner}
# the reference MaxIoUAssigner's fields; a PAA config keeps only these of its merged
# ``assigner`` (``_base_`` the ATSS config leaves ATSS's ``topk`` in it)
_MAX_IOU_FIELDS = ("pos_iou_thr", "neg_iou_thr", "min_pos_iou", "gt_max_assign_all",
                   "ignore_iof_thr")
DetectionConfig = Union[RetinaNetConfig, FasterRCNNConfig, FastRCNNConfig, SparseRCNNConfig,
                        DETRConfig, FCOSConfig, ATSSConfig, GFLConfig, FoveaConfig,
                        FreeAnchorConfig, PAAConfig, SSDConfig, YOLOV3Config, YOLOXConfig,
                        CenterNetConfig, SOLOV2Config]


def _tuples(value):
    """Lists, nested ones too, as the tuples the frozen configs hold."""
    return tuple(_tuples(v) for v in value) if isinstance(value, (list, tuple)) else value


def build_detector(
    model_cfg: Dict[str, Any],
    compute_dtype: Optional[str] = None,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    param_dtype: Optional[str] = None,
):
    """The detector of ``model_cfg`` on ``device`` (default ``cuda``), its
    weights drawn from ``seed``, in eval mode and channels_last memory.
    ``compute_dtype`` ('float32', 'bfloat16') is the dtype of its
    activations, and of its parameters unless ``param_dtype`` names another:
    the serving build keeps bf16 parameters, the training build
    (``param_dtype='float32'``) float32 parameters that are cast to the
    compute dtype at use. FrozenBN stays float32."""
    cfg = copy.deepcopy(dict(model_cfg))
    dtype = _DTYPES[compute_dtype] if compute_dtype is not None else None
    pdtype = _DTYPES[param_dtype] if param_dtype is not None else None
    model = DETECTORS.build(cfg, dtype=dtype, param_dtype=pdtype, device=device)
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(memory_format=torch.channels_last).eval()


def _build_anchor_generator(config_cls, anchor: Dict[str, Any]):
    """The anchor generator of ``config_cls`` from its ``anchor`` dict: SSD's
    min/max sizes and per-level ratios, YOLOv3's per-level (w, h) base
    sizes, else the ``AnchorGenerator`` of strides, ratios and scales."""
    if config_cls is SSDConfig:
        return SSDAnchorGenerator(strides=tuple(anchor["strides"]),
                                  min_sizes=tuple(anchor["min_sizes"]),
                                  max_sizes=tuple(anchor["max_sizes"]),
                                  ratios=_tuples(anchor["ratios"]))
    if config_cls is YOLOV3Config:
        return YOLOAnchorGenerator(strides=tuple(anchor["strides"]),
                                   base_sizes=_tuples(anchor["base_sizes"]))
    return AnchorGenerator(
        strides=tuple(anchor.get("strides", (8, 16, 32, 64, 128))),
        ratios=tuple(anchor.get("ratios", (0.5, 1.0, 2.0))),
        scales=tuple(anchor["scales"]) if "scales" in anchor else None,
        octave_base_scale=anchor.get("octave_base_scale", None if "scales" in anchor else 4.0),
        scales_per_octave=anchor.get("scales_per_octave", 3),
    )


def _build_assigner(config_cls, assigner: Dict[str, Any]):
    """The assigner of ``config_cls`` from its config dict. PAA's keeps the
    MaxIoUAssigner fields of a merged dict and drops the rest, as the
    reference. A MaxIoUAssigner takes ``gt_max_assign_all`` and
    ``ignore_iof_thr``; no detector hands its assigner ignore regions, in
    the reference as here (R14), so the builder says once that
    ``ignore_iof_thr`` changes nothing in training."""
    cls = _ASSIGNERS.get(config_cls, MaxIoUAssigner)
    if cls is not MaxIoUAssigner:
        return cls(**assigner)
    if config_cls is PAAConfig:
        assigner = {k: v for k, v in assigner.items() if k in _MAX_IOU_FIELDS}
    if assigner.get("ignore_iof_thr", -1.0) > 0:
        _log_no_ignore_regions()
    return cls(**assigner)


@functools.lru_cache(maxsize=None)
def _log_no_ignore_regions() -> None:
    logger.info("assigner ignore_iof_thr is set, but no detector passes ignore regions to its "
                "assigner (as in the reference: R14), so it changes no assignment in training")


def build_detection_cfg(det_cfg: Dict[str, Any]) -> DetectionConfig:
    """The static detection config of a ``style='retina'`` (the default),
    ``'faster_rcnn'``, ``'mask_rcnn'``, ``'cascade_rcnn'``,
    ``'cascade_mask_rcnn'``, ``'fast_rcnn'``, ``'sparse_rcnn'``, ``'detr'``,
    ``'fcos'``, ``'atss'``, ``'gfl'``, ``'fovea'``, ``'free_anchor'``,
    ``'paa'``, ``'ssd'``, ``'yolo'``, ``'yolox'``, ``'centernet'`` or
    ``'solov2'`` config. RetinaNet's, FreeAnchor's,
    PAA's and SSD's ``assigner`` is their ``MaxIoUAssigner``, Fast R-CNN's
    its ``rcnn_assigner``, ATSS's and GFL's their ``ATSSAssigner``, YOLOv3's
    its ``GridAssigner``. Keys the port does not read yet raise instead of
    being dropped."""
    cfg = dict(det_cfg)
    style = cfg.pop("style", "retina")
    if style not in _STYLES:
        raise NotImplementedError(f"detection style {style!r} is not one of the builder's styles")
    config_cls, keys, assigner_field = _STYLES[style]
    kwargs: Dict[str, Any] = {}
    anchor = cfg.pop("anchor", None) if hasattr(config_cls, "anchor_generator") else None
    if anchor:
        kwargs["anchor_generator"] = _build_anchor_generator(config_cls, dict(anchor))
    if assigner_field and "assigner" in cfg:
        kwargs[assigner_field] = _build_assigner(config_cls, dict(cfg.pop("assigner")))
    for key in keys:
        if key in cfg:
            kwargs[key] = _tuples(cfg.pop(key))
    if cfg:
        raise NotImplementedError(f"detection keys not ported yet: {sorted(cfg)}")
    return config_cls(**kwargs)


def build_loss_fn(model, det_cfg, rng_seed: int = 0) -> Callable:
    """``loss_fn(batch, step=0) -> (loss, metrics)`` for the detector family
    of ``det_cfg``. The sampling draws of a step come from a
    ``torch.Generator`` on the model's device seeded from
    ``(rng_seed, step)``, so every step draws a fresh stream and a step
    repeats exactly (the counterpart of the reference's ``_step_rng``); in
    a data-parallel step each rank draws the global batch's and keeps its
    own images' rows (``parallel.distributed.global_rows``).
    A mask config adds the mask losses, whose batch carries ``gt_masks``;
    a ``FastRCNNConfig``'s batch carries ``proposals`` and
    ``proposal_valid``. RetinaNet, Sparse R-CNN and DETR draw nothing;
    Sparse R-CNN's and DETR's forward and loss take the batch's
    ``img_shape``, as ATSS's, GFL's, PAA's and YOLOv3's losses do (FCOS's,
    FoveaBox's, FreeAnchor's, SSD's, YOLOX's, CenterNet's and SOLOv2's do
    not; SSD's is R11; SOLOv2's batch carries ``gt_masks``). The
    set-prediction and dense configs are
    tested first: no R-CNN config class is their base, and
    ``FreeAnchorConfig``, a ``RetinaNetConfig``, is a dense config tested
    before RetinaNet's."""
    if isinstance(det_cfg, DETRConfig):
        def detr_loss_fn(batch: Dict[str, torch.Tensor], step: int = 0):
            losses = detr_train_loss(det_cfg, model, batch)
            return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}

        return detr_loss_fn
    if isinstance(det_cfg, SparseRCNNConfig):
        def sparse_loss_fn(batch: Dict[str, torch.Tensor], step: int = 0):
            losses = sparse_rcnn_train_loss(det_cfg, model, batch)
            return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}

        return sparse_loss_fn
    dense = _dense_loss(det_cfg)
    if dense is not None:
        def dense_loss_fn(batch: Dict[str, torch.Tensor], step: int = 0):
            losses = dense(model(batch["image"]), batch)
            return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}

        return dense_loss_fn
    if isinstance(det_cfg, RetinaNetConfig):
        def retina_loss_fn(batch: Dict[str, torch.Tensor], step: int = 0):
            cls_scores, bbox_preds = model(batch["image"])
            losses = retina_loss(det_cfg, cls_scores, bbox_preds, batch["gt_boxes"],
                                 batch["gt_labels"], batch["gt_valid"], batch.get("img_shape"))
            return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}

        return retina_loss_fn
    loss = _rcnn_loss(det_cfg)
    device = next(model.parameters()).device

    def loss_fn(batch: Dict[str, torch.Tensor], step: int = 0):
        generator = torch.Generator(device=device).manual_seed((rng_seed << 32) + int(step))
        losses = loss(det_cfg, model, batch,
                      global_rows(functools.partial(sampling_noise, generator)))
        return losses["loss"], {k: v for k, v in losses.items() if k != "loss"}

    return loss_fn


def _dense_loss(det_cfg) -> Optional[Callable]:
    """``loss(head_outputs, batch)`` of the FCOS, ATSS, GFL, FoveaBox,
    FreeAnchor, PAA, SSD, YOLOv3, YOLOX, CenterNet and SOLOv2 configs, as
    the reference's: ATSS's, GFL's, PAA's and YOLOv3's take the batch's
    ``img_shape`` (the valid anchors), the others do not (SSD's: R11);
    YOLOv3's head outputs are one tuple of prediction maps, YOLOX's three
    tuples of maps, CenterNet's three maps, SOLOv2's two tuples and the mask
    features (its loss also takes ``gt_masks``); None for another config.
    ``FreeAnchorConfig`` subclasses ``RetinaNetConfig``, whose loss
    ``build_loss_fn`` tests after this."""
    gts = ("gt_boxes", "gt_labels", "gt_valid")
    if isinstance(det_cfg, SOLOV2Config):
        return lambda out, batch: solov2_loss(det_cfg, *out, *(batch[k] for k in gts),
                                              batch["gt_masks"])
    if isinstance(det_cfg, YOLOXConfig):
        return lambda out, batch: yolox_loss(det_cfg, *out, *(batch[k] for k in gts))
    if isinstance(det_cfg, CenterNetConfig):
        return lambda out, batch: centernet_loss(det_cfg, *out, *(batch[k] for k in gts))
    if isinstance(det_cfg, SSDConfig):
        return lambda out, batch: ssd_loss(det_cfg, *out, *(batch[k] for k in gts))
    if isinstance(det_cfg, YOLOV3Config):
        return lambda out, batch: yolo_loss(det_cfg, out, *(batch[k] for k in gts),
                                            img_shapes=batch.get("img_shape"))
    if isinstance(det_cfg, FreeAnchorConfig):
        return lambda out, batch: free_anchor_loss(det_cfg, *out, *(batch[k] for k in gts))
    if isinstance(det_cfg, PAAConfig):
        return lambda out, batch: paa_loss(det_cfg, *out, *(batch[k] for k in gts),
                                           img_shapes=batch.get("img_shape"))
    if isinstance(det_cfg, FoveaConfig):
        return lambda out, batch: fovea_loss(det_cfg, *out, *(batch[k] for k in gts))
    if isinstance(det_cfg, GFLConfig):
        return lambda out, batch: gfl_loss(det_cfg, *out, *(batch[k] for k in gts),
                                           img_shapes=batch.get("img_shape"))
    if isinstance(det_cfg, ATSSConfig):
        return lambda out, batch: atss_loss(det_cfg, *out, *(batch[k] for k in gts),
                                            img_shapes=batch.get("img_shape"))
    if isinstance(det_cfg, FCOSConfig):
        return lambda out, batch: fcos_loss(det_cfg, *out, *(batch[k] for k in gts))
    return None


def _rcnn_loss(det_cfg) -> Callable:
    """The loss of an R-CNN family's config. The cascade configs subclass
    ``FasterRCNNConfig``, so each subclass is tested before its base."""
    for config_cls, loss in ((CascadeMaskRCNNConfig, cascade_mask_rcnn_loss),
                             (CascadeRCNNConfig, cascade_rcnn_loss),
                             (MaskRCNNConfig, mask_rcnn_loss),
                             (FasterRCNNConfig, faster_rcnn_loss),
                             (FastRCNNConfig, fast_rcnn_loss)):
        if isinstance(det_cfg, config_cls):
            return loss
    raise NotImplementedError(f"{type(det_cfg).__name__} training is not ported yet")


def build_lr_schedule(cfg, steps_per_epoch: int) -> Callable[[int], float]:
    """The config's learning-rate schedule as a plain ``step -> lr``: the
    ``step`` or ``cosine`` policy, the cosine over ``schedule.total_epochs``
    (which ``--epochs`` does not change, as in the reference)."""
    opt_cfg = cfg.get("optimizer", {})
    sched_cfg = cfg.get("schedule", {})
    return detection_lr_schedule(
        opt_cfg.get("lr", 0.01),
        steps_per_epoch=max(int(steps_per_epoch), 1),
        total_epochs=sched_cfg.get("total_epochs", 12),
        decay_epochs=tuple(sched_cfg.get("decay_epochs", (8, 11))),
        warmup_steps=sched_cfg.get("warmup_steps", 500),
        warmup_ratio=sched_cfg.get("warmup_ratio", 1.0 / 3),
        policy=sched_cfg.get("policy", "step"),
        min_lr_ratio=sched_cfg.get("min_lr_ratio", 0.0),
    )


def build_train_loader(cfg, dist: bool = False, num_replicas: Optional[int] = None,
                       rank: Optional[int] = None):
    """The training loader of a full config tree: the ``train`` dataset,
    grouped sampling (``dist``: the rank's shard, of ``num_replicas`` and
    ``rank`` where given, else the data ranks'), ``collate`` at the canvas;
    ``workers_per_host`` threads decode the samples."""
    data_cfg = cfg["data"]
    return build_dataloader(
        get_datasets(dict(data_cfg["train"])),
        sample_per_replica=data_cfg.get("sample_per_replica", 2),
        dist=dist,
        num_replicas=num_replicas,
        rank=rank,
        max_gts=data_cfg.get("max_gts", 100),
        canvas=tuple(data_cfg["canvas"]) if data_cfg.get("canvas") else None,
        size_divisor=data_cfg["train"].get("size_divisor", 32) or 32,
        workers=int(data_cfg.get("workers_per_host", 0)),
        max_proposals=data_cfg.get("max_proposals"),
        s2d=bool(cfg["model"].get("backbone", {}).get("stem_s2d", False)),
    )


def build_train_objects(
    cfg,
    device: Optional[Union[str, torch.device]] = None,
    seed: int = 0,
    loader=None,
) -> Tuple[Any, DetectionConfig, Any, Optimizer]:
    """(model, det_cfg, loader, optimizer) from a full config tree: the
    training build of the detector (float32 parameters, the runtime's
    compute dtype, train mode), the training loader of ``cfg['data']``
    (``build_train_loader``) unless the caller passes one (any object with
    ``set_epoch``, ``iter_batches`` and ``__len__``, such as ready
    batches), and the config's optimizer (``type`` ``sgd``, the default, or
    ``adamw``) with its momentum, weight decay, clip and a schedule of
    ``len(loader)`` steps an epoch.

    In a group of more than one rank (``parallel.init_distributed``) every
    rank starts from rank 0's weights and the ranks form the
    ``(data, runtime.mesh.model)`` mesh (``parallel.mesh.make_mesh``); each
    data rank's loader yields ``sample_per_replica`` images a step from its
    own shard (``DistributedGroupSampler``), the ranks of a model group the
    same, so the global batch is ``sample_per_replica * data``. With
    ``runtime.mesh.model > 1`` the model is sharded by the reference's
    tensor-parallel rule (``parallel.tensor_parallel``), and with
    ``runtime.fsdp`` over several data ranks by FSDP
    (``parallel.mesh.shard_model``), both before the optimizer takes its
    parameters, the optimizer's ``fsdp_root`` FSDP's root."""
    runtime = cfg.get("runtime", {})
    model = build_detector(cfg["model"], runtime.get("compute_dtype"), device, seed,
                           param_dtype="float32").train()
    det_cfg = build_detection_cfg(cfg["detection"])
    broadcast_module(model)
    model_axis = int(runtime.get("mesh", {}).get("model", 1) or 1)
    fsdp_root = None
    if world_size() > 1 or model_axis > 1:
        mesh = make_mesh(model=model_axis, device_type=next(model.parameters()).device.type)
        if model_axis > 1:
            apply_tensor_parallel(model, mesh)
        if runtime.get("fsdp") and data_size() > 1:
            fsdp_root = shard_model(model, mesh)
    if loader is None:
        loader = build_train_loader(cfg, dist=data_size() > 1)
    opt_cfg = cfg.get("optimizer", {})
    optimizer = make_optimizer(
        model.parameters(),
        learning_rate=build_lr_schedule(cfg, len(loader)),
        momentum=opt_cfg.get("momentum", 0.9),
        weight_decay=opt_cfg.get("weight_decay", 1e-4),
        grad_clip_norm=opt_cfg.get("grad_clip_norm"),
        kind=opt_cfg.get("type", "sgd"),
        fsdp_root=fsdp_root,
    )
    return model, det_cfg, loader, optimizer
