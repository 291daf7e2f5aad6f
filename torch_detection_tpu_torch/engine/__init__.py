from .validate import make_inference_fn

__all__ = ["make_inference_fn"]
