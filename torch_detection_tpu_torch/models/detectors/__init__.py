from .mask_rcnn import (
    MaskDetections,
    MaskRCNN,
    MaskRCNNConfig,
    mask_rcnn_inference,
    mask_rcnn_loss,
)
from .single_stage import (
    RetinaNetConfig,
    SingleStageDetector,
    decode_detections,
    retina_inference,
    retina_loss,
)
from .two_stage import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_inference,
    faster_rcnn_loss,
    sampling_noise,
)

__all__ = ["FasterRCNNConfig", "MaskDetections", "MaskRCNN", "MaskRCNNConfig", "RetinaNetConfig",
           "SingleStageDetector", "TwoStageDetector", "decode_detections", "faster_rcnn_inference",
           "faster_rcnn_loss", "mask_rcnn_inference", "mask_rcnn_loss", "retina_inference",
           "retina_loss", "sampling_noise"]
