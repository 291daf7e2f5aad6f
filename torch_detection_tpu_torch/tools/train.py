"""Train a detector from a config file.

    python -m torch_detection_tpu_torch.tools.train CONFIG [--epochs N]
        [--work-dir DIR] [--resume CKPT | --auto-resume] [--seed S]
        [--pretrained torch://W.pth | modelzoo://resnet50 | CKPT]
        [--profile-dir DIR] [--device cuda|cpu] [--dist-backend nccl|gloo]
        [--dump-final PATH]
    python -m torch.distributed.run --nproc_per_node=N \
        -m torch_detection_tpu_torch.tools.train CONFIG [...]

Counterpart of ``tools/train.py``: COCO folder -> ``CocoDataset`` ->
``GroupSampler`` -> ``DataLoader`` -> the device -> ``Trainer.run``, with
``epoch_N/`` checkpoints, ``metrics.jsonl`` and the validation hook when
``runtime.val_interval_epochs > 0``. ``--resume`` continues from a
checkpoint (a mid-epoch ``step_N`` at its batch), ``--auto-resume`` from the
newest in the work directory. ``--pretrained`` (or ``runtime.pretrained``)
initialises the model from a torchvision or mmdetection ``.pth``
(``torch://``, ``modelzoo://``, ``file://``): a state dict with
``backbone.`` keys loads as a whole detector, one without them as the
backbone. Validation in training reports the mask metrics too under
``runtime.val_segm``, and VOC2007's AP instead of COCO's under
``runtime.val_voc_metric``. ``runtime.ema_decay`` keeps an EMA of the
parameters, which validation scores and the checkpoints carry;
``runtime.accum_steps`` averages that many micro-batches of each batch a
step; ``schedule.policy="cosine"`` (with ``min_lr_ratio``) anneals over
``schedule.total_epochs``. ``--profile-dir`` writes a ``torch.profiler``
Chrome trace of the first epoch run to ``DIR/trace.json``. Runs on ``cuda``
unless ``--device cpu``.

Launched by torchrun with N processes, each rank joins the group
(``parallel.init_distributed``: ``nccl`` on ``cuda:LOCAL_RANK``, ``gloo``
with ``--device cpu``, or ``--dist-backend``), loads its own share of each
step, ``sample_per_replica`` images, and the step is the global batch's
(``parallel/train_step.py``); ``runtime.fsdp`` shards the model by FSDP.
``runtime.mesh.model`` (default 1) makes the ranks a ``(data, model)``
mesh: the ranks of a model group load the same images and shard the wide
kernels' output channels between them (tensor parallelism), so the global
batch is ``sample_per_replica * data``; ``runtime.accum_steps`` need not be
a multiple of the data ranks. Only rank 0 writes the work directory, and
validation spreads the val images over the data ranks. ``--dump-final
PATH`` writes every parameter after training, whole, to
``PATH.rank<k>.npz`` on every rank, so that a multi-process run can show
its replicas agree.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
from typing import Optional, Sequence

import numpy as np

from ..builder import build_loss_fn, build_train_objects
from ..engine.checkpoint import latest_checkpoint, load_checkpoint
from ..engine.trainer import Trainer
from ..parallel.distributed import init_distributed, shutdown_distributed
from ..parallel.mesh import full_tensor
from ..utils.config import Config
from ..utils.misc import expected_sizes


def main(argv: Optional[Sequence[str]] = None) -> Trainer:
    parser = argparse.ArgumentParser(description="train a detector")
    parser.add_argument("config", help="config (.py, .json, .yaml, .yml)")
    parser.add_argument("--epochs", type=int, default=None)
    parser.add_argument("--work-dir", default=None)
    parser.add_argument("--resume", default=None, help="checkpoint dir to resume from")
    parser.add_argument("--auto-resume", action="store_true",
                        help="resume from the newest epoch_N or step_N in the work dir if any")
    parser.add_argument("--pretrained", default=None,
                        help="torch://w.pth, modelzoo://resnet50, file://... or a checkpoint dir")
    parser.add_argument("--profile-dir", default=None,
                        help="write a torch.profiler trace of the first epoch run here")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    parser.add_argument("--dist-backend", default=None,
                        help="under torchrun: nccl (the default on cuda) or gloo (on cpu, or "
                             "ranks sharing a GPU)")
    parser.add_argument("--dump-final", default=None, metavar="PATH",
                        help="after training write every parameter to PATH.rank<k>.npz on each rank")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    cfg = Config.fromfile(args.config)
    runtime = cfg.get("runtime", {})
    work_dir = args.work_dir or runtime.get("work_dir", "work_dirs/default")
    total_epochs = args.epochs or cfg.get("schedule", {}).get("total_epochs", 12)
    dist_info = init_distributed(args.dist_backend, args.device)
    try:
        return _train(args, cfg, runtime, work_dir, total_epochs, dist_info)
    finally:
        shutdown_distributed(dist_info)


def _train(args, cfg, runtime, work_dir: str, total_epochs: int, dist_info) -> Trainer:
    device = dist_info["device"]

    model, det_cfg, loader, optimizer = build_train_objects(cfg, device, seed=args.seed)
    pretrained = args.pretrained or runtime.get("pretrained")
    if pretrained:
        meta = load_checkpoint(model, pretrained)
        if "loaded" in meta:
            backbone = [k for k in model.state_dict() if k.startswith("backbone.")]
            logging.info("loaded %d tensors from %s, %d of the backbone's %d", len(meta["loaded"]),
                         pretrained, sum(k.startswith("backbone.") for k in meta["loaded"]),
                         len(backbone))
        else:
            logging.info("loaded pretrained weights from %s", pretrained)
    loss_fn = build_loss_fn(model, det_cfg, rng_seed=args.seed)

    # validation in training: the val split every N epochs, the best kept in best/
    val_hook = None
    val_interval = int(runtime.get("val_interval_epochs", 0) or 0)
    if val_interval > 0 and cfg["data"].get("val"):
        from ..data import get_datasets
        from ..engine.validate import make_validation_hook

        val_cfg = dict(cfg["data"]["val"])
        if "img_expected_sizes" in val_cfg:  # single-scale evaluation in training
            val_cfg["img_expected_sizes"] = expected_sizes(val_cfg["img_expected_sizes"])[0]
        val_cfg["flip_ratio"] = 0
        segm = bool(runtime.get("val_segm", False))
        if segm:
            val_cfg["with_mask"] = True  # the gt masks of the mask-IoU metrics
        val_hook = make_validation_hook(
            model, det_cfg, get_datasets(val_cfg),
            batch=int(runtime.get("val_batch", 8)),
            canvas=tuple(cfg["data"].get("canvas") or (800, 1344)),
            max_images=runtime.get("val_max_images"), segm=segm,
            voc_metric=bool(runtime.get("val_voc_metric", False)),
        )

    trainer = Trainer(
        loss_fn, model, optimizer, loader,
        work_dir=work_dir,
        log_interval=runtime.get("log_interval", 50),
        checkpoint_interval_epochs=runtime.get("checkpoint_interval_epochs", 1),
        val_hook=val_hook,
        val_interval_epochs=val_interval or 1,
        checkpoint_interval_steps=runtime.get("checkpoint_interval_steps"),
        handle_preemption=bool(runtime.get("handle_preemption", True)),
        profile_dir=args.profile_dir,
        ema_decay=runtime.get("ema_decay"),
        accum_steps=int(runtime.get("accum_steps", 1) or 1),
    )
    resume = args.resume
    if args.auto_resume and not resume:
        resume = latest_checkpoint(work_dir)
        if resume:
            logging.info("auto-resume found %s", resume)
    start_epoch = skip_batches = 0
    if resume:
        # the model's and the optimizer's state by name, the step counts and the EMA with them
        meta = load_checkpoint(model, resume, strict=True, optimizer=optimizer)
        start_epoch = int(meta.get("epoch", 0))
        # a mid-epoch checkpoint carries its batch position; those batches are not decoded
        skip_batches = int(meta.get("batches_done", 0))
        logging.info("resuming from %s at epoch %d batch %d (step %d)", resume, start_epoch,
                     skip_batches, optimizer.steps)

    trainer.run(total_epochs, start_epoch=start_epoch, skip_batches=skip_batches)

    if args.dump_final:
        # every rank writes: a multi-process run holds its replicas to each other bit for bit
        params = {n: full_tensor(p).detach().cpu().numpy() for n, p in model.named_parameters()}
        out = f"{args.dump_final}.rank{dist_info['process_index']}.npz"
        np.savez(out, **params)
        logging.info("dumped %d final parameters to %s", len(params), out)

    # the run's summary from its curve, work_dir/metrics.jsonl (rank 0's)
    if trainer.metrics_path is not None and os.path.exists(trainer.metrics_path):
        with open(trainer.metrics_path) as f:
            records = [json.loads(line) for line in f if line.strip()]
        steps = [r for r in records if "loss" in r]
        if steps:
            last = steps[-1]
            logging.info(
                "run summary: %d logged windows, final loss %.4f @ step %d, mean %.1f img/s, "
                "%d skipped steps, loader wait %.1f s - curve at %s",
                len(steps), last["loss"], int(last["step"]),
                float(np.mean([r["images_per_sec"] for r in steps])),
                int(last["skipped_steps"]), trainer.loader_wait_s, trainer.metrics_path,
            )
        vals = [r for r in records if "val_mAP" in r]
        if vals:
            best = max(vals, key=lambda r: r["val_mAP"])
            logging.info("best val mAP %.4f at epoch %d", best["val_mAP"], int(best["epoch"]))
    return trainer


if __name__ == "__main__":
    main()
