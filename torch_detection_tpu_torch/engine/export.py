"""Serving export: a detector as one ``torch.export`` artifact, weights included.

Counterpart of ``torch_detection_tpu/engine/export.py``. The artifact is a
``.pt2`` file that ``torch.export.save`` writes: the whole serving path,
from the uint8 wire through the on-device normalisation and padding mask,
the backbone, neck and heads, to the decode and NMS, with the weights as
constants and fixed shapes ``(image_u8 (B, H, W, 3) or the s2d wire's
(B, H/2, W/2, 12), img_shape (B, 2) int32, scale_factor (B,) float32)`` ->
``{"boxes", "scores", "labels", "valid"[, "mask_probs"]}``.

Unlike a ``jax.export`` module, the artifact is not free of framework code
at serving time: its graph names the port's registered ops (RoIAlign's
``torch_detection_tpu_torch::roi_align`` in the two-stage families), so
the process that loads it needs the port's op library imported.
``load_serving`` imports it; the model code is not needed.
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Callable, Dict, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor, nn

from ..models.detectors import CascadeMaskRCNNConfig, FastRCNNConfig, MaskRCNNConfig, SOLOV2Config
from ..ops import roi_align  # noqa: F401  registers torch_detection_tpu_torch::roi_align
from ..ops.preprocess import MEAN, STD, fused_normalize_pad, fused_normalize_pad_s2d
from .validate import _inference

DEFAULT_MEAN, DEFAULT_STD = MEAN, STD

_MASK_CONFIGS = (MaskRCNNConfig, CascadeMaskRCNNConfig, SOLOV2Config)


class ServingModule(nn.Module):
    """The serving path of ``model``: ``forward(image_u8, img_shape,
    scale_factor)`` -> the detections as a dict of tensors."""

    def __init__(self, model, det_cfg, mean: Sequence[float], std: Sequence[float],
                 s2d_wire: bool):
        super().__init__()
        if isinstance(det_cfg, FastRCNNConfig):
            raise ValueError("FastRCNNConfig: Fast R-CNN serving needs proposals beside the "
                             "image, and the serving artifact takes the image alone")
        self.model = model
        self.det_cfg = det_cfg
        self.segm = isinstance(det_cfg, _MASK_CONFIGS)
        self.inference = _inference(det_cfg, self.segm)
        self.mean, self.std = tuple(mean), tuple(std)
        self.normalize = fused_normalize_pad_s2d if s2d_wire else fused_normalize_pad

    def forward(self, image_u8: Tensor, img_shape: Tensor, scale_factor: Tensor) -> Dict[str, Tensor]:
        # export_serving traces with grad off already; a no_grad scope inside
        # the traced graph would only add a set-grad pass to the export
        scope = contextlib.nullcontext() if torch.compiler.is_exporting() else torch.no_grad()
        with scope:
            x = self.normalize(image_u8, img_shape, self.mean, self.std, out_dtype=self.model.dtype)
            d = self.inference(self.det_cfg, self.model, x, img_shape.to(torch.float32),
                               scale_factor)
        out = {"boxes": d.boxes, "scores": d.scores, "labels": d.labels, "valid": d.valid}
        if self.segm:
            out["mask_probs"] = d.mask_probs
        return out


def make_serving_fn(model, det_cfg, mean: Sequence[float] = DEFAULT_MEAN,
                    std: Sequence[float] = DEFAULT_STD, s2d_wire: bool = False) -> ServingModule:
    """The serving module of ``model`` (its own weights and compute dtype:
    the serving build's bf16). ``s2d_wire=True`` (an ``stem_s2d``
    backbone): the image is the 2x2 space-to-depth uint8 canvas
    (B, H/2, W/2, 12), ``img_shape`` stays in the original frame. Mask
    R-CNN, Cascade Mask R-CNN and SOLOv2 add ``mask_probs``. Fast R-CNN
    raises ``ValueError``: its inference needs proposals."""
    return ServingModule(model, det_cfg, mean, std, s2d_wire)


def serving_inputs(batch: int, canvas: Tuple[int, int], s2d_wire: bool,
                   device) -> Tuple[Tensor, Tensor, Tensor]:
    """Zero inputs of the artifact's calling convention: the image (or
    wire) uint8, full-canvas ``img_shape`` int32, unit ``scale_factor``."""
    h, w = canvas
    shape = (batch, h // 2, w // 2, 12) if s2d_wire else (batch, h, w, 3)
    return (torch.zeros(shape, dtype=torch.uint8, device=device),
            torch.tensor([[h, w]] * batch, dtype=torch.int32, device=device),
            torch.ones(batch, dtype=torch.float32, device=device))


def export_serving(model, det_cfg, batch: int, canvas: Tuple[int, int],
                   mean: Sequence[float] = DEFAULT_MEAN, std: Sequence[float] = DEFAULT_STD,
                   s2d_wire: bool = False):
    """``torch.export`` of the serving module on the model's device with
    static shapes; returns the ``ExportedProgram``."""
    serving = make_serving_fn(model, det_cfg, mean, std, s2d_wire)
    device = next(model.parameters()).device
    with torch.no_grad():
        return torch.export.export(serving, serving_inputs(batch, canvas, s2d_wire, device),
                                   strict=False)


def save_serving(exported, path) -> None:
    """Write the artifact (``torch.export.save``; a path or a file object)."""
    with warnings.catch_warnings():
        # channels_last weights are not contiguous, so the archive finds no
        # "complete" tensor in their storage and writes each storage whole
        warnings.filterwarnings("ignore", message="No complete tensor found")
        torch.export.save(exported, path)


def load_serving(path) -> Callable[..., Dict[str, Tensor]]:
    """Load an artifact -> ``call(image_u8, img_shape, scale_factor)`` over
    numpy arrays or tensors, on the device the artifact was exported on.
    The port's op library is imported with this module, as the artifact's
    graph needs it; its model code is not."""
    program = torch.export.load(path)
    module = program.module()
    device = next(iter(program.state_dict.values()), None)
    device = device.device if device is not None else torch.device("cpu")

    def call(image_u8, img_shape, scale_factor) -> Dict[str, Tensor]:
        args = (torch.as_tensor(np.asarray(a) if not isinstance(a, Tensor) else a).to(device)
                for a in (image_u8, img_shape, scale_factor))
        with torch.no_grad():  # the graph's weights are parameters; serving records no graph
            return module(*args)

    return call
