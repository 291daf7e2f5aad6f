"""Dump a detector's RPN proposals over a split, as a ``proposal_file`` pkl.

    python -m torch_detection_tpu_torch.tools.dump_proposals CONFIG CKPT
        --split {train,val} --out X.pkl [--batch B] [--top-k K]
        [--max-images N] [--device cuda|cpu]

Counterpart of ``tools/dump_proposals.py``: a Faster or Mask R-CNN
checkpoint's RPN over a test-mode (unfiltered), single-scale, unflipped view
of the split without its ``proposal_file``, batches bucketed by
``pick_canvas`` on the config's canvas, ``generate_proposals`` with
``post_nms_top_k = K``. The pkl holds one (n, 5) float32 array an image,
``[x1, y1, x2, y2, score]`` in the original frame, in dataset order: what
``CocoDataset(proposal_file=...)`` reads, so Fast R-CNN trains and tests on
it (a train-mode dataset filters it as it filters its images). CKPT is a
checkpoint directory of the port or a torch ``.pth`` (``torch://``). A
config without an RPN exits with an error. Runs on ``cuda`` unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..builder import build_detection_cfg, build_detector
from ..data import get_datasets
from ..data.collate import pick_canvas
from ..engine.checkpoint import load_checkpoint
from ..models.detectors import TwoStageDetector
from ..models.heads.rpn_head import generate_proposals
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.file_handler import dump
from ..utils.misc import expected_sizes


def main(argv: Optional[Sequence[str]] = None) -> List[np.ndarray]:
    parser = argparse.ArgumentParser(description="dump RPN proposals to a pkl")
    parser.add_argument("config", help="config (.py, .json, .yaml, .yml)")
    parser.add_argument("checkpoint", help="a checkpoint dir of the port or torch://w.pth")
    parser.add_argument("--split", choices=("train", "val"), default="val")
    parser.add_argument("--out", required=True, help="output .pkl path")
    parser.add_argument("--batch", type=int, default=4)
    parser.add_argument("--top-k", type=int, default=1000,
                        help="proposals kept an image (the post-NMS slate)")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = Config.fromfile(args.config)
    runtime = cfg.get("runtime", {})
    device = resolve_device(args.device)
    model = build_detector(cfg["model"], runtime.get("compute_dtype"), device)
    if not isinstance(model, TwoStageDetector):
        raise SystemExit("dump_proposals needs a detector with an RPN (a TwoStageDetector config)")
    det_cfg = build_detection_cfg(cfg["detection"])
    load_checkpoint(model, args.checkpoint)

    # an unfiltered test-mode view of the split: single scale, no flip
    split_cfg = dict(cfg["data"][args.split])
    if "img_expected_sizes" in split_cfg:
        split_cfg["img_expected_sizes"] = expected_sizes(split_cfg["img_expected_sizes"])[0]
    split_cfg["flip_ratio"] = 0
    split_cfg["test_mode"] = True
    split_cfg.pop("proposal_file", None)
    dataset = get_datasets(split_cfg)
    canvas = tuple(cfg["data"].get("canvas") or (800, 1344))
    prop_cfg = dataclasses.replace(det_cfg.proposal_test, post_nms_top_k=args.top_k)

    @torch.inference_mode()
    def rpn_proposals(image, img_shape):
        _, rpn_scores, rpn_deltas = model(image)
        return generate_proposals(prop_cfg, det_cfg.anchor_generator, rpn_scores, rpn_deltas,
                                  img_shapes=img_shape)

    n = len(dataset) if args.max_images is None else min(args.max_images, len(dataset))
    out: List[Optional[np.ndarray]] = [None] * n
    pending = {}  # bucket -> [(idx, img, img_shape, scale_factor)]

    def flush(bucket, items):
        padded = np.zeros((args.batch, bucket[0], bucket[1], 3), np.float32)
        shapes = np.ones((args.batch, 2), np.float32)
        for j, (_, img, img_shape, _) in enumerate(items):
            padded[j, : img.shape[0], : img.shape[1]] = img
            shapes[j] = img_shape
        props = rpn_proposals(torch.from_numpy(padded).to(device),
                              torch.from_numpy(shapes).to(device))
        boxes = props.boxes.float().cpu().numpy()
        scores = props.scores.float().cpu().numpy()
        valid = props.valid.cpu().numpy()
        for j, (idx, _, _, sf) in enumerate(items):
            v = valid[j]
            # the canvas frame -> the original image's
            out[idx] = np.hstack([boxes[j][v] / float(sf), scores[j][v, None]]).astype(np.float32)

    for i in range(n):
        sample = dataset[i]
        img = sample["img"][0]
        meta = sample["img_meta"][0].data
        bucket = pick_canvas([img.shape[:2]], canvas=canvas)
        items = pending.setdefault(bucket, [])
        items.append((i, img, meta["img_shape"][:2], meta["scale_factor"]))
        if len(items) == args.batch:
            flush(bucket, items)
            pending[bucket] = []
        if (i + 1) % 100 == 0:
            logging.info("proposals: %d/%d images", i + 1, n)
    for bucket, items in pending.items():
        if items:
            flush(bucket, items)

    dump(out, args.out)
    counts = [len(p) for p in out]
    logging.info("wrote %s: %d images, proposals an image min %d mean %.1f max %d", args.out, n,
                 min(counts), float(np.mean(counts)), max(counts))
    return out


if __name__ == "__main__":
    main()
