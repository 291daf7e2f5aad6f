"""Export a detector config (and checkpoint) as a serving artifact.

    python -m torch_detection_tpu_torch.tools.export CONFIG --out serve.pt2
        [--checkpoint CKPT] [--batch 8] [--canvas HxW] [--check] [--device cuda|cpu]

Counterpart of ``tools/export.py``: the config's serving build (its
``runtime.compute_dtype``, bf16 for the COCO configs) with seeded weights,
or the weights of ``--checkpoint`` (a checkpoint directory of the port,
``torch://W.pth`` or ``file://``), through ``engine.export_serving`` at a
fixed batch and canvas (default: the config's ``data.canvas``, else
800x1216), saved with ``torch.export.save``. The normalisation comes from
``data.val`` (else ``data.train``), the space-to-depth wire from
``model.backbone.stem_s2d``. Load the file with ``engine.load_serving``:
the process needs the port's op library (the artifact's graph names
``torch_detection_tpu_torch::roi_align``), not its model code.
``--check`` loads the file back and runs it and the live module on seeded
uint8 input; it prints each output's largest difference and fails unless
the two are equal bit for bit (they run the same kernels on the same
inputs). Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..builder import build_detection_cfg, build_detector
from ..engine.checkpoint import load_checkpoint
from ..engine.export import (
    DEFAULT_MEAN,
    DEFAULT_STD,
    export_serving,
    load_serving,
    make_serving_fn,
    save_serving,
)
from ..ops.preprocess import space_to_depth_2x2_np
from ..utils.config import Config
from ..utils.device import resolve_device


def check_inputs(batch: int, canvas, s2d_wire: bool, seed: int = 0):
    """Seeded uint8 images filling the canvas (relaid space-to-depth on
    the s2d wire), their (h, w) and unit scale factors, as numpy."""
    img = np.random.default_rng(seed).integers(0, 256, (batch, *canvas, 3), dtype=np.uint8)
    if s2d_wire:
        img = space_to_depth_2x2_np(img)
    return (img, np.tile(np.asarray([canvas], np.int32), (batch, 1)),
            np.ones((batch,), np.float32))


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser(description="export a detector as a serving artifact")
    parser.add_argument("config", help="config (.py, .json, .yaml, .yml)")
    parser.add_argument("--checkpoint", default=None,
                        help="a checkpoint dir of the port, torch://w.pth or file://... "
                             "(default: seeded weights)")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--canvas", default=None, help="HxW (default: the config's canvas)")
    parser.add_argument("--check", action="store_true",
                        help="load the artifact back and compare it with the live module")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = Config.fromfile(args.config)
    runtime = cfg.get("runtime", {})
    device = resolve_device(args.device)
    model = build_detector(cfg["model"], runtime.get("compute_dtype"), device)
    det_cfg = build_detection_cfg(cfg["detection"])
    if args.checkpoint:
        load_checkpoint(model, args.checkpoint)
    data_cfg = cfg.get("data", {})
    canvas = (tuple(int(v) for v in args.canvas.split("x")) if args.canvas
              else tuple(data_cfg.get("canvas") or (800, 1216)))
    split = data_cfg.get("val") or data_cfg.get("train") or {}
    mean = tuple(split.get("img_means", DEFAULT_MEAN))
    std = tuple(split.get("img_stds", DEFAULT_STD))
    s2d_wire = bool(cfg["model"].get("backbone", {}).get("stem_s2d", False))

    t0 = time.perf_counter()
    exported = export_serving(model, det_cfg, args.batch, canvas, mean, std, s2d_wire)
    export_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    save_serving(exported, args.out)
    save_s = time.perf_counter() - t0
    result: Dict[str, Any] = dict(export_s=export_s, save_s=save_s,
                                  mb=os.path.getsize(args.out) / 1e6, canvas=canvas,
                                  s2d_wire=s2d_wire,
                                  serving=make_serving_fn(model, det_cfg, mean, std, s2d_wire))
    logging.info("exported %s -> %s (batch %d, canvas %s, %s wire, %s) in %.1f s, saved in "
                 "%.1f s, %.1f MB", args.config, args.out, args.batch, canvas,
                 "s2d" if s2d_wire else "rgb", device, export_s, save_s, result["mb"])
    if args.check:
        t0 = time.perf_counter()
        loaded = load_serving(args.out)
        result.update(load_s=time.perf_counter() - t0, loaded=loaded)
        inputs = check_inputs(args.batch, canvas, s2d_wire)
        got = loaded(*inputs)
        want = result["serving"](*(torch.from_numpy(a).to(device) for a in inputs))
        diffs = {k: float((got[k].double() - want[k].double()).abs().max()) if want[k].numel()
                 else 0.0 for k in want}
        result["max_diff"] = diffs
        logging.info("check: loaded in %.1f s; the artifact against the live module, largest "
                     "difference of each output: %s", result["load_s"], diffs)
        unequal = [k for k in want if set(got) != set(want) or not torch.equal(got[k], want[k])]
        if unequal:
            raise AssertionError(f"check: the artifact's {unequal} differ from the live "
                                 f"module's: {diffs}")
        logging.info("check ok: the artifact equals the live module bit for bit on %s",
                     sorted(want))
    return result


if __name__ == "__main__":
    main()
