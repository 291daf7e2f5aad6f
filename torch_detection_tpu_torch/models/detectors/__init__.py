from .two_stage import (
    FasterRCNNConfig,
    TwoStageDetector,
    faster_rcnn_inference,
    faster_rcnn_loss,
    sampling_noise,
)

__all__ = ["FasterRCNNConfig", "TwoStageDetector", "faster_rcnn_inference", "faster_rcnn_loss",
           "sampling_noise"]
