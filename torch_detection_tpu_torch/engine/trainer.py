"""Training loop and the learning-rate schedule.

Counterpart of ``torch_detection_tpu/engine/trainer.py``: the mmdetection
schedule (linear warmup, then step decay) and ``Trainer``: epochs from
``start_epoch``, a mid-epoch start that skips the batches already done,
each batch put on the model's device by ``data/device.py``, metrics logged
and appended to ``work_dir/metrics.jsonl`` (the reference's record keys),
``epoch_N`` and ``step_N`` checkpoints with retention, the validation hook
with ``best/``, and cooperative preemption (SIGTERM or SIGINT: finish the
step, save ``step_N`` with the batch position, return). With
``profile_dir`` the first epoch run is traced by ``torch.profiler``
(``engine/profiling.py::trace``: host spans ``data`` and ``train_step``
from ``annotate``, and the GPU's kernels), up to that epoch's end or a
preemption. The EMA of the parameters, gradient accumulation and sharded
state wait for a later slice.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import shutil
import signal
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from ..data.device import prefetch_to_device
from ..parallel.train_step import Optimizer, make_train_step
from .checkpoint import save_checkpoint
from .profiling import annotate, trace

logger = logging.getLogger(__name__)

PREFETCH = 2  # batches whose host-to-device copies are issued ahead of their step


def detection_lr_schedule(
    base_lr: float,
    steps_per_epoch: int,
    decay_epochs: Sequence[int] = (8, 11),
    warmup_steps: int = 500,
    warmup_ratio: float = 1.0 / 3.0,
) -> Callable[[int], float]:
    """mmdetection's step schedule: from ``warmup_ratio * base_lr`` linearly
    up to ``base_lr`` over ``warmup_steps``, then ``base_lr`` times 0.1 for
    every boundary ``epoch * steps_per_epoch`` reached."""
    boundaries = sorted({int(e * steps_per_epoch) for e in decay_epochs})

    def schedule(step: int) -> float:
        if step < warmup_steps:
            return base_lr * (warmup_ratio + (1 - warmup_ratio) * step / warmup_steps)
        return base_lr * 0.1 ** sum(step >= b for b in boundaries)

    return schedule


class Trainer:
    """Drives a loss, a model's optimizer and a data loader for N epochs.

    ``loss_fn(batch, step) -> (loss, metrics)`` (``builder.build_loss_fn``).
    The loader is any object with ``set_epoch(epoch)``,
    ``iter_batches(skip_batches)`` yielding batch dicts of numpy arrays or
    tensors, and ``__len__``. Every ``log_interval`` steps the metrics are
    read on the host, logged and kept in ``history`` with images/s over the
    window and the learning rate. With ``work_dir`` None nothing is
    written: no metrics file, no checkpoint. ``profile_dir`` traces the
    first epoch that ``run`` trains into ``profile_dir/trace.json``."""

    def __init__(
        self,
        loss_fn: Callable,
        model,
        optimizer: Optimizer,
        dataloader,
        work_dir: Optional[str] = None,
        log_interval: int = 50,
        checkpoint_interval_epochs: int = 1,
        max_keep_checkpoints: int = 3,
        val_hook: Optional[Callable[[], Dict[str, float]]] = None,
        val_interval_epochs: int = 1,
        best_metric: str = "mAP",
        checkpoint_interval_steps: Optional[int] = None,
        handle_preemption: bool = False,
        profile_dir: Optional[str] = None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.dataloader = dataloader
        self.device = next(model.parameters()).device
        self.work_dir = os.path.abspath(work_dir) if work_dir is not None else None
        self.metrics_path = None
        if self.work_dir is not None:
            os.makedirs(self.work_dir, exist_ok=True)
            self.metrics_path = os.path.join(self.work_dir, "metrics.jsonl")
        self.log_interval = log_interval
        self.checkpoint_interval_epochs = checkpoint_interval_epochs
        self.max_keep_checkpoints = max_keep_checkpoints
        self.val_hook = val_hook
        self.val_interval_epochs = max(1, val_interval_epochs)
        self.best_metric = best_metric
        self.best_score = float("-inf")
        self.checkpoint_interval_steps = checkpoint_interval_steps
        self.handle_preemption = handle_preemption
        self.profile_dir = profile_dir
        self.train_step = make_train_step(loss_fn, optimizer)
        self.skipped_steps = 0
        self.preempted = False
        self._preempt_requested = False
        self._saved: List[str] = []
        self.history: List[Dict[str, Any]] = []
        self.loader_wait_s = 0.0  # host time spent waiting for the next batch

    def request_preemption(self) -> None:
        """Stop after the step in flight, saving its (epoch, batch) position."""
        self._preempt_requested = True

    def _install_preemption_handler(self) -> Dict:
        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, lambda *_: self.request_preemption())
            except ValueError:  # not the main thread
                logger.warning("cannot install the preemption handler off the main thread")
        return previous

    def run(self, num_epochs: int, start_epoch: int = 0, skip_batches: int = 0) -> List[Dict[str, Any]]:
        """Train epochs ``start_epoch`` .. ``num_epochs - 1``, the first from
        batch ``skip_batches`` on; returns ``history``."""
        previous = self._install_preemption_handler() if self.handle_preemption else {}
        try:
            self._run(num_epochs, start_epoch, skip_batches)
        finally:
            for sig, handler in previous.items():
                signal.signal(sig, handler)
        return self.history

    def _batches(self, skip: int):
        """The epoch's batches on the model's device, and the host's wait
        for each counted in ``loader_wait_s``."""
        it = prefetch_to_device(self.dataloader.iter_batches(skip), PREFETCH, self.device)
        while True:
            t0 = time.perf_counter()
            with annotate("data"):
                batch = next(it, None)
            self.loader_wait_s += time.perf_counter() - t0
            if batch is None:
                return
            yield batch

    def _run(self, num_epochs: int, start_epoch: int, skip_batches: int) -> None:
        for epoch in range(start_epoch, num_epochs):
            first = epoch == start_epoch
            profiling = (trace(self.profile_dir) if self.profile_dir and first
                         else contextlib.nullcontext())
            with profiling:
                finished = self._epoch(epoch, skip_batches if first else 0)
            if not finished:
                return
            if (epoch + 1) % self.checkpoint_interval_epochs == 0:
                self._checkpoint(f"epoch_{epoch + 1}",
                                 {"epoch": epoch + 1, "step": self.optimizer.steps})
            if self.val_hook is not None and (epoch + 1) % self.val_interval_epochs == 0:
                self._validate(epoch)

    def _epoch(self, epoch: int, batches_done: int) -> bool:
        """Train one epoch from batch ``batches_done``; False when preempted."""
        self.dataloader.set_epoch(epoch)
        epoch_t0 = window_t0 = time.perf_counter()
        n_images = 0
        batches = self._batches(batches_done)
        for batch in batches:
            batch.pop("img_meta", None)
            with annotate("train_step"):
                metrics = self.train_step(batch)
            self.skipped_steps += int(metrics["skipped_nonfinite"])
            n_images += batch["image"].shape[0]
            batches_done += 1
            step = self.optimizer.steps
            if (self.checkpoint_interval_steps and step % self.checkpoint_interval_steps == 0
                    ) or self._preempt_requested:
                self._checkpoint(f"step_{step}", {"epoch": epoch,
                                                  "batches_done": batches_done, "step": step})
            if self._preempt_requested:
                self.preempted = True
                batches.close()
                logger.info("preempted at epoch %d batch %d (step %d); state saved",
                            epoch, batches_done, step)
                return False
            if step % self.log_interval == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                dt = time.perf_counter() - window_t0
                window_t0 = time.perf_counter()
                metrics.update(
                    skipped_steps=self.skipped_steps,
                    images_per_sec=self.log_interval * batch["image"].shape[0] / max(dt, 1e-9),
                    epoch=epoch,
                    step=step,
                    lr=float(self.optimizer.schedule(step)),
                )
                self.history.append(metrics)
                self._write_metrics(metrics)
                parts = " ".join(f"{k[5:]} {v:.4f}" for k, v in sorted(metrics.items())
                                 if k.startswith("loss_"))
                logger.info("epoch %d step %d loss %.4f (%s) %.1f img/s", epoch, step,
                            metrics["loss"], parts, metrics["images_per_sec"])
        logger.info("epoch %d done: %d images in %.1fs", epoch, n_images,
                    time.perf_counter() - epoch_t0)
        return True

    def _write_metrics(self, record: Dict[str, Any]) -> None:
        """Append one JSON object a logged window or validation to
        ``work_dir/metrics.jsonl``."""
        if self.metrics_path is None:
            return
        clean = {
            k: (float(v) if isinstance(v, (int, float, np.floating, np.integer)) else v)
            for k, v in record.items()
            if v is not None
        }
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps(clean) + "\n")

    def _validate(self, epoch: int) -> None:
        t0 = time.perf_counter()
        metrics = self.val_hook()
        parts = " ".join(f"{k} {v:.4f}" for k, v in sorted(metrics.items()))
        logger.info("epoch %d val (%.1fs): %s", epoch, time.perf_counter() - t0, parts)
        record = {"epoch": epoch, **{f"val_{k}": v for k, v in metrics.items()}}
        self.history.append(record)
        self._write_metrics(record)
        score = metrics.get(self.best_metric)
        if score is not None and score > self.best_score:
            self.best_score = float(score)
            if self.work_dir is not None:
                path = os.path.join(self.work_dir, "best")
                save_checkpoint(path, self.model, self.optimizer,
                                meta={"epoch": epoch + 1, "step": self.optimizer.steps,
                                      self.best_metric: float(score)})
                logger.info("new best %s %.4f at epoch %d -> %s", self.best_metric,
                            self.best_score, epoch, path)

    def _checkpoint(self, name: str, meta: Dict[str, int]) -> None:
        """Save ``work_dir/name``; a mid-epoch ``step_N``'s meta carries its
        ``batches_done``, the position a resume starts from."""
        if self.work_dir is None:
            return
        path = os.path.join(self.work_dir, name)
        save_checkpoint(path, self.model, self.optimizer, meta=meta)
        self._saved.append(path)
        # keep the newest ``max_keep_checkpoints``: the failure-recovery window
        while len(self._saved) > self.max_keep_checkpoints:
            shutil.rmtree(self._saved.pop(0), ignore_errors=True)
        logger.info("saved checkpoint %s", path)
