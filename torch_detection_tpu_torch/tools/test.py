"""Evaluate a detector checkpoint: inference over the val set, COCO mAP.

    python -m torch_detection_tpu_torch.tools.test CONFIG CKPT [--tta] [--batch B]
        [--max-images N] [--segm] [--voc-metric] [--out res.json] [--device cuda|cpu]
    python -m torch.distributed.run --nproc_per_node=N \
        -m torch_detection_tpu_torch.tools.test CONFIG CKPT --shard-eval [...]

Counterpart of ``tools/test.py``: the test-mode ``CocoDataset`` at the
config's first scale without flips (``--tta``: the val config as it is, each
of its ``img_expected_sizes`` and, with a ``flip_ratio``, each flipped too,
every augmentation bucketed at its size rounded up to 128 and the
augmentations' detections fused by class-wise NMS in the original frame,
masks by their source detection), canvas buckets of ``--batch`` images through
``make_inference_fn``, detections in the original frame, ``eval_coco_map``'s
12 metrics (``--voc-metric``: VOC2007's 11-point AP at IoU 0.5, difficult
objects ignored), and with ``--out`` the detections (``.json``: COCO results
format; otherwise a pickle of per-image dicts). ``--segm`` (the mask
families) loads the val split's gt masks, adds the 12 mask metrics
(``segm_*``) and with a ``.json`` ``--out`` writes ``<out>.segm.json``, the
masks as COCO RLE. CKPT is a checkpoint directory of the port or a torch
``.pth`` (``torch://``; with ``backbone.`` keys a whole mmdetection
detector). Runs on ``cuda`` unless ``--device cpu``. ``--shard-eval``,
launched by torchrun with N processes (``parallel.init_distributed``; nccl
on ``cuda:LOCAL_RANK``, gloo with ``--device cpu``, or ``--dist-backend``),
spreads the images over the ranks, ``--batch`` a rank, and gathers the
detections: rank 0 writes ``--out``, and every rank returns its metrics
(those of one process; in bf16 near-tied scores may rank otherwise, see
``evaluate_detector``). ``--shard-eval`` in one process, and a launch of
several processes without it, raise ``ValueError``.
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
from ..parallel.distributed import init_distributed, is_main, shutdown_distributed
from ..utils.config import Config
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
    parser.add_argument("--shard-eval", action="store_true",
                        help="spread the images over the ranks of a torchrun launch")
    parser.add_argument("--out", default=None,
                        help="dump detections: .json = COCO results format, .pkl = per-image dicts")
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--dist-backend", default=None,
                        help="under torchrun: nccl (the default on cuda) or gloo")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    dist_info = init_distributed(args.dist_backend, args.device)
    try:
        if args.shard_eval != (dist_info["process_count"] > 1):
            raise ValueError(f"--shard-eval {'needs' if args.shard_eval else 'is needed by'} a "
                             f"torchrun launch of several processes (this one has "
                             f"{dist_info['process_count']})")
        return _test(args, dist_info["device"])
    finally:
        shutdown_distributed(dist_info)


def _test(args, device) -> Dict[str, float]:
    cfg = Config.fromfile(args.config)
    runtime = cfg.get("runtime", {})
    model = build_detector(cfg["model"], runtime.get("compute_dtype"), device)
    det_cfg = build_detection_cfg(cfg["detection"])
    load_checkpoint(model, args.checkpoint)

    val_cfg = dict(cfg["data"]["val"])
    if not args.tta:
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
        tta=args.tta, return_detections=bool(args.out), segm=args.segm, voc_metric=args.voc_metric,
    )
    if args.out:
        results, detections = results
    if args.out and is_main():
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
    if is_main():
        for k, v in results.items():
            logging.info("%s: %.4f", k, v)
        print(results)
    return results


if __name__ == "__main__":
    main()
