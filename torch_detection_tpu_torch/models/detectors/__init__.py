from .two_stage import FasterRCNNConfig, TwoStageDetector, faster_rcnn_inference

__all__ = ["FasterRCNNConfig", "TwoStageDetector", "faster_rcnn_inference"]
