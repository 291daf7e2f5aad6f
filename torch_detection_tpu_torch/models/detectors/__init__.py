from .atss import ATSSConfig, atss_inference, atss_loss, atss_targets, decode_atss
from .cascade_mask_rcnn import (
    CascadeMaskRCNN,
    CascadeMaskRCNNConfig,
    cascade_mask_rcnn_inference,
    cascade_mask_rcnn_loss,
)
from .cascade_rcnn import (
    CascadeRCNN,
    CascadeRCNNConfig,
    cascade_rcnn_inference,
    cascade_rcnn_loss,
)
from .centernet import (
    CenterNetConfig,
    centernet_inference,
    centernet_loss,
    centernet_targets,
    decode_centernet,
)
from .detr import DETR, DETRConfig, decode_detr, detr_inference, detr_loss, detr_train_loss
from .fast_rcnn import FastRCNN, FastRCNNConfig, fast_rcnn_inference, fast_rcnn_loss
from .fcos import FCOSConfig, decode_fcos, fcos_inference, fcos_loss, fcos_targets
from .foveabox import FoveaConfig, decode_fovea, fovea_inference, fovea_loss, fovea_targets
from .free_anchor import FreeAnchorConfig, free_anchor_loss
from .gfl import GFLConfig, decode_gfl, gfl_inference, gfl_loss, integral
from .mask_rcnn import (
    MaskDetections,
    MaskRCNN,
    MaskRCNNConfig,
    mask_rcnn_inference,
    mask_rcnn_loss,
)
from .paa import PAAConfig, decode_paa, paa_inference, paa_loss, paa_reassign
from .single_stage import (
    RetinaNetConfig,
    SingleStageDetector,
    decode_detections,
    retina_inference,
    retina_loss,
)
from .sparse_rcnn import (
    SparseRCNN,
    SparseRCNNConfig,
    decode_sparse_rcnn,
    sparse_rcnn_inference,
    sparse_rcnn_loss,
    sparse_rcnn_train_loss,
)
from .ssd import SSDConfig, decode_ssd, ssd_candidates, ssd_inference, ssd_loss
from .two_stage import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_inference,
    faster_rcnn_loss,
    sampling_noise,
)
from .yolov3 import YOLOV3Config, decode_yolo, yolo_candidates, yolo_inference, yolo_loss
from .yolox import YOLOXConfig, decode_yolox, simota_assign, yolox_inference, yolox_loss

__all__ = ["ATSSConfig", "FCOSConfig", "GFLConfig", "atss_inference", "atss_loss",
           "atss_targets", "decode_atss", "decode_fcos", "decode_gfl", "fcos_inference",
           "fcos_loss", "fcos_targets", "gfl_inference", "gfl_loss", "integral",
           "FoveaConfig", "decode_fovea", "fovea_inference", "fovea_loss", "fovea_targets",
           "FreeAnchorConfig", "free_anchor_loss", "PAAConfig", "decode_paa", "paa_inference",
           "paa_loss", "paa_reassign",
           "CascadeMaskRCNN", "CascadeMaskRCNNConfig", "CascadeRCNN", "CascadeRCNNConfig",
           "DETR", "DETRConfig", "decode_detr", "detr_inference", "detr_loss", "detr_train_loss",
           "FastRCNN", "FastRCNNConfig", "FasterRCNNConfig", "MaskDetections", "MaskRCNN",
           "MaskRCNNConfig", "RetinaNetConfig", "SingleStageDetector", "TwoStageDetector",
           "cascade_mask_rcnn_inference", "cascade_mask_rcnn_loss", "cascade_rcnn_inference",
           "cascade_rcnn_loss", "decode_detections", "fast_rcnn_inference", "fast_rcnn_loss",
           "faster_rcnn_inference", "faster_rcnn_loss", "mask_rcnn_inference", "mask_rcnn_loss",
           "retina_inference", "retina_loss", "sampling_noise", "SparseRCNN", "SparseRCNNConfig",
           "decode_sparse_rcnn", "sparse_rcnn_inference", "sparse_rcnn_loss",
           "sparse_rcnn_train_loss", "SSDConfig", "decode_ssd", "ssd_candidates", "ssd_inference",
           "ssd_loss", "YOLOV3Config", "decode_yolo", "yolo_candidates", "yolo_inference",
           "yolo_loss", "CenterNetConfig", "centernet_inference", "centernet_loss",
           "centernet_targets", "decode_centernet", "YOLOXConfig", "decode_yolox", "simota_assign",
           "yolox_inference", "yolox_loss"]
