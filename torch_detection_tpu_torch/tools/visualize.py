"""Draw a detector's detections on images.

    python -m torch_detection_tpu_torch.tools.visualize CONFIG CKPT IMG [IMG ...]
        [--out-dir vis] [--score-thr 0.3] [--segm] [--device cuda|cpu]

Counterpart of ``tools/visualize.py``: each image is read (PNG or JPEG),
normalised with the training set's means and stds, resized to its first
``img_expected_sizes``, padded onto the config's canvas and run through
``make_inference_fn`` (one image a batch); the boxes above ``--score-thr``
are drawn with their labels (``bbox_visualize``) and, with ``--segm`` (a
mask family), the masks pasted at the image's size under them
(``mask_visualize``). Each result is written as ``OUT_DIR/<stem>.png``.
CKPT is a checkpoint directory of the port or a torch ``.pth``
(``torch://``). Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..builder import build_detection_cfg, build_detector
from ..data.ops.bbox import bbox_visualize
from ..data.ops.image import img_normalize, img_pad_size_divisor, img_read, img_resize
from ..data.ops.mask import mask_visualize
from ..engine.checkpoint import load_checkpoint
from ..engine.validate import make_inference_fn
from ..models.heads.mask_head import paste_masks_np
from ..utils.config import Config
from ..utils.device import resolve_device


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Draw every image; returns the written files' paths."""
    parser = argparse.ArgumentParser(description="visualize detections")
    parser.add_argument("config")
    parser.add_argument("checkpoint", help="a checkpoint dir of the port or torch://w.pth")
    parser.add_argument("images", nargs="+")
    parser.add_argument("--out-dir", default="vis")
    parser.add_argument("--score-thr", type=float, default=0.3)
    parser.add_argument("--segm", action="store_true",
                        help="overlay instance masks too (mask families)")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    device = resolve_device(args.device)
    cfg = Config.fromfile(args.config)
    model = build_detector(cfg["model"], cfg.get("runtime", {}).get("compute_dtype"), device)
    det_cfg = build_detection_cfg(cfg["detection"])
    load_checkpoint(model, args.checkpoint)
    infer = make_inference_fn(model, det_cfg, segm=args.segm)

    train_cfg = cfg["data"]["train"]
    means = tuple(train_cfg.get("img_means", (123.675, 116.28, 103.53)))
    stds = tuple(train_cfg.get("img_stds", (58.395, 57.12, 57.375)))
    sizes = train_cfg.get("img_expected_sizes", (1333, 800))
    if isinstance(sizes, list):
        sizes = sizes[0]
    canvas = tuple(cfg["data"].get("canvas") or (800, 1344))
    os.makedirs(args.out_dir, exist_ok=True)

    written = []
    for path in args.images:
        raw = img_read(path)
        img, sf = img_resize(img_normalize(raw, means, stds), size=tuple(sizes), return_scale=True)
        hw = img.shape[:2]
        img = img_pad_size_divisor(img, 32)
        if img.shape[0] > canvas[0] or img.shape[1] > canvas[1]:
            raise ValueError(f"{path}: resized to {hw}, padded {img.shape[:2]}, larger than the "
                             f"canvas {canvas}")
        padded = np.zeros((1, canvas[0], canvas[1], 3), np.float32)
        padded[0, : img.shape[0], : img.shape[1]] = img
        dets = infer(torch.from_numpy(padded).to(device),
                     torch.tensor([[hw[0], hw[1]]], dtype=torch.float32, device=device),
                     torch.tensor([sf], dtype=torch.float32, device=device))
        v = dets.valid[0].cpu().numpy()
        boxes = dets.boxes[0].float().cpu().numpy()[v]
        scores = dets.scores[0].float().cpu().numpy()[v]
        labels = dets.labels[0].cpu().numpy()[v]
        base = raw.copy()
        if args.segm:
            # the detections are in the original frame already: paste at the image's size
            probs = dets.mask_probs[0].float().cpu().numpy()[v]
            keep = scores > args.score_thr
            base = mask_visualize(base, paste_masks_np(probs[keep], boxes[keep], raw.shape[:2]),
                                  None)
        out_file = os.path.join(args.out_dir, os.path.splitext(os.path.basename(path))[0] + ".png")
        bbox_visualize(base, np.concatenate([boxes, scores[:, None]], axis=1), labels,
                       score_thr=args.score_thr, out_file=out_file)
        written.append(out_file)
        logging.info("%s: %d detections above %.2f -> %s", path,
                     int((scores > args.score_thr).sum()), args.score_thr, out_file)
    return written


if __name__ == "__main__":
    main()
