"""Evaluate a detector checkpoint: inference over the val set, COCO mAP.

    python -m torch_detection_tpu_torch.tools.test CONFIG CKPT [--batch B]
        [--max-images N] [--segm] [--out res.json] [--device cuda|cpu]

Counterpart of ``tools/test.py``: the test-mode ``CocoDataset`` at the
config's first scale, canvas buckets of ``--batch`` images through
``make_inference_fn``, detections in the original frame, ``eval_coco_map``'s
12 metrics, and with ``--out`` the detections (``.json``: COCO results
format; otherwise a pickle of per-image dicts). ``--segm`` (the mask
families) loads the val split's gt masks, adds the 12 mask metrics
(``segm_*``) and with a ``.json`` ``--out`` writes ``<out>.segm.json``, the
masks as COCO RLE. CKPT is a checkpoint directory of the port or a torch
``.pth`` (``torch://``; with ``backbone.`` keys a whole mmdetection
detector). Runs on ``cuda`` unless ``--device cpu``. ``--tta`` and
``--voc-metric`` are not ported yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import argparse
import logging
from typing import Dict, Optional, Sequence

import numpy as np

from ..builder import build_detection_cfg, build_detector
from ..data import get_datasets
from ..engine.checkpoint import load_checkpoint
from ..engine.validate import coco_detection_dump, coco_segm_dump, evaluate_detector
from ..utils.config import Config
from ..utils.device import resolve_device
from ..utils.file_handler import dump


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    parser = argparse.ArgumentParser(description="evaluate a detector")
    parser.add_argument("config")
    parser.add_argument("checkpoint", help="a checkpoint dir of the port or torch://w.pth")
    parser.add_argument("--tta", action="store_true", help="multi-scale x flip fusion")
    parser.add_argument("--batch", type=int, default=8,
                        help="images per inference batch (per canvas bucket)")
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--voc-metric", action="store_true", help="VOC AP@0.5 instead of COCO mAP")
    parser.add_argument("--segm", action="store_true", help="mask-IoU COCO metrics too")
    parser.add_argument("--out", default=None,
                        help="dump detections: .json = COCO results format, .pkl = per-image dicts")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    for flag in ("tta", "voc_metric"):
        if getattr(args, flag):
            raise NotImplementedError(f"--{flag.replace('_', '-')} is not ported yet")

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = Config.fromfile(args.config)
    runtime = cfg.get("runtime", {})
    device = resolve_device(args.device)
    model = build_detector(cfg["model"], runtime.get("compute_dtype"), device)
    det_cfg = build_detection_cfg(cfg["detection"])
    load_checkpoint(model, args.checkpoint)

    val_cfg = dict(cfg["data"]["val"])
    sizes = val_cfg.get("img_expected_sizes")
    if isinstance(sizes, list):  # single-scale evaluation: the first size
        val_cfg["img_expected_sizes"] = sizes[0]
    val_cfg["flip_ratio"] = 0
    if args.segm:
        val_cfg["with_mask"] = True  # the gt masks of the mask-IoU metrics
    dataset = get_datasets(val_cfg)
    canvas = tuple(cfg["data"].get("canvas") or (800, 1344))
    results = evaluate_detector(
        model, det_cfg, dataset, batch=args.batch, canvas=canvas, max_images=args.max_images,
        return_detections=bool(args.out), segm=args.segm,
    )
    if args.out:
        results, detections = results
        if args.out.endswith(".json"):
            payload = coco_detection_dump(dataset, detections)
            if args.segm:
                segm_out = args.out[: -len(".json")] + ".segm.json"
                dump(coco_segm_dump(dataset, detections), segm_out)
                logging.info("dumped segm RLE results to %s", segm_out)
        else:
            payload = [{k: np.asarray(v) for k, v in d.items()} for d in detections]
        dump(payload, args.out)
        logging.info("dumped %d images of detections to %s", len(detections), args.out)
    for k, v in results.items():
        logging.info("%s: %.4f", k, v)
    print(results)
    return results


if __name__ == "__main__":
    main()
