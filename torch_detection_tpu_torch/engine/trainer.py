"""Training loop and the learning-rate schedule.

Counterpart of ``torch_detection_tpu/engine/trainer.py``: the mmdetection
schedule (linear warmup, then step decay) and ``Trainer.run`` cut to its
loop and its logging. Checkpoints, the validation hook, preemption and the
metrics file wait for a later slice.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Sequence

from ..parallel.train_step import Optimizer, make_train_step

logger = logging.getLogger(__name__)


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
    """Drives a loss, an optimizer and a data loader for N epochs.

    ``loss_fn(batch, step) -> (loss, metrics)`` (``builder.build_loss_fn``).
    The loader is any object with ``set_epoch(epoch)``, ``iter_batches()``
    yielding batch dicts, and ``__len__``. Every ``log_interval`` steps the
    metrics are read on the host, logged and kept in ``history`` with
    images/s over the window and the learning rate."""

    def __init__(self, loss_fn: Callable, optimizer: Optimizer, dataloader,
                 log_interval: int = 50):
        self.optimizer = optimizer
        self.dataloader = dataloader
        self.log_interval = log_interval
        self.train_step = make_train_step(loss_fn, optimizer)
        self.skipped_steps = 0
        self.history: List[Dict[str, Any]] = []

    def run(self, num_epochs: int) -> List[Dict[str, Any]]:
        for epoch in range(num_epochs):
            self.dataloader.set_epoch(epoch)
            epoch_t0 = window_t0 = time.perf_counter()
            n_images = 0
            for batch in self.dataloader.iter_batches():
                batch.pop("img_meta", None)
                metrics = self.train_step(batch)
                self.skipped_steps += int(metrics["skipped_nonfinite"])
                n_images += batch["image"].shape[0]
                if self.optimizer.steps % self.log_interval == 0:
                    metrics = {k: float(v) for k, v in metrics.items()}
                    dt = time.perf_counter() - window_t0
                    window_t0 = time.perf_counter()
                    metrics.update(
                        skipped_steps=self.skipped_steps,
                        images_per_sec=self.log_interval * batch["image"].shape[0] / max(dt, 1e-9),
                        epoch=epoch,
                        step=self.optimizer.steps,
                        lr=float(self.optimizer.schedule(self.optimizer.steps)),
                    )
                    self.history.append(metrics)
                    parts = " ".join(f"{k[5:]} {v:.4f}" for k, v in sorted(metrics.items())
                                     if k.startswith("loss_"))
                    logger.info("epoch %d step %d loss %.4f (%s) %.1f img/s", epoch,
                                metrics["step"], metrics["loss"], parts,
                                metrics["images_per_sec"])
            logger.info("epoch %d done: %d images in %.1fs", epoch, n_images,
                        time.perf_counter() - epoch_t0)
        return self.history
