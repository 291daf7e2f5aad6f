"""Float32 matrix products that stay float32 on every device.

``float32_matmul(a, b)`` is ``a @ b`` of float32 operands with autocast off
and TF32 off (``torch.set_float32_matmul_precision("highest")`` for the
call), in the forward and in the backward. The products whose sums the
reference keeps in float32 go through it: SOLOv2's dynamic convolution and
mask crops, and the mask IoU of Matrix NMS, whose 0/1 intersection counts
are exact in float32 (below 2^24) but would be rounded by a bf16 output.
A caller's own TF32 setting is restored after the call.
"""

from __future__ import annotations

import contextlib

import torch
from torch import Tensor


@contextlib.contextmanager
def _ieee_float32(device_type: str):
    precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        torch.set_float32_matmul_precision(precision)


class _Float32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor) -> Tensor:
        ctx.save_for_backward(a, b)
        with _ieee_float32(a.device.type):
            return torch.matmul(a, b)

    @staticmethod
    def backward(ctx, g: Tensor):
        a, b = ctx.saved_tensors
        ga = gb = None
        with _ieee_float32(g.device.type):
            if ctx.needs_input_grad[0]:
                ga = torch.matmul(g, b.transpose(-1, -2))
            if ctx.needs_input_grad[1]:
                gb = torch.matmul(a.transpose(-1, -2), g)
        return ga, gb


def float32_matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` in IEEE float32 (operands cast to float32), batched over
    equal leading dims; differentiable."""
    a, b = a.float(), b.float()
    if a.shape[:-2] != b.shape[:-2]:
        raise ValueError(f"batch dims {tuple(a.shape[:-2])} and {tuple(b.shape[:-2])} differ")
    return _Float32MatMul.apply(a, b)
