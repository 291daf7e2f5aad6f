"""The port's command-line entry points: ``python -m
torch_detection_tpu_torch.tools.train`` and ``... .tools.test``."""
