"""torch_detection_tpu_torch: the PyTorch and CUDA port of torch_detection_tpu.

The JAX package ``torch_detection_tpu`` stays the reference; this package
mirrors its module paths and holds each module to it in the tests
(``tests/test_torch_*.py``). Plain tensor code is PyTorch; every TPU kernel
of the reference becomes a kernel written by hand for Hopper under
``csrc/``, built by ``kernels.py``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
