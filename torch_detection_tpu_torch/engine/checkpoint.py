"""Checkpoint save and load, in torch's format.

Counterpart of ``torch_detection_tpu/engine/checkpoint.py``. A checkpoint is
a directory: ``model.pt`` (the model's ``state_dict``), ``optimizer.pt``
(the optimizer's state keyed by parameter name, its step and update counts)
and ``meta.json`` (epoch, step, ``batches_done`` of a mid-epoch save, time).
Loading reports missing and unexpected keys by name, and the optimizer's
state is restored by parameter name, never by position. Importing
torchvision or mmdetection weights (``torch://``, ``modelzoo://``) waits for
the port's ``models/torch_import.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

logger = logging.getLogger(__name__)

MODEL_FILE, OPTIMIZER_FILE, META_FILE = "model.pt", "optimizer.pt", "meta.json"


def _named_params(model, optimizer) -> Dict[int, str]:
    """id(parameter) -> name, for the optimizer's parameters."""
    names = {id(p): n for n, p in model.named_parameters()}
    missing = [i for i, p in enumerate(optimizer.params) if id(p) not in names]
    if missing:
        raise ValueError(f"optimizer parameters {missing} are not the model's")
    return names


def optimizer_state(model, optimizer) -> Dict[str, Any]:
    """The optimizer's state keyed by the model's parameter names."""
    names = _named_params(model, optimizer)
    per_param = optimizer.torch_optimizer.state
    return {
        "state": {names[id(p)]: dict(per_param[p]) for p in optimizer.params if p in per_param},
        "steps": optimizer.steps,
        "count": optimizer.count,
    }


def save_checkpoint(path: str, model, optimizer=None, meta: Optional[Dict] = None) -> None:
    """Write the model's ``state_dict``, the optimizer's state (if given)
    and ``meta`` (with the time) into the directory ``path``. The files are
    written under temporary names and renamed, so a checkpoint that exists
    is whole."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    meta = dict(meta or {})
    meta.setdefault("time", time.asctime())
    payloads = [(MODEL_FILE, model.state_dict())]
    if optimizer is not None:
        payloads.append((OPTIMIZER_FILE, optimizer_state(model, optimizer)))
    for name, payload in payloads:
        torch.save(payload, os.path.join(path, name + ".tmp"))
    with open(os.path.join(path, META_FILE + ".tmp"), "w") as f:
        json.dump(meta, f)
    for name in [n for n, _ in payloads] + [META_FILE]:
        os.replace(os.path.join(path, name + ".tmp"), os.path.join(path, name))


def latest_checkpoint(work_dir: str) -> Optional[str]:
    """The newest ``epoch_N`` / ``step_N`` checkpoint directory in
    ``work_dir``, or None. Checkpoints are written one after another, so
    the newest modification time is the latest training state whichever
    family it belongs to (the number breaks ties)."""
    work_dir = os.path.abspath(os.path.expanduser(work_dir))
    if not os.path.isdir(work_dir):
        return None
    best, best_key = None, (-1.0, -1)
    for name in os.listdir(work_dir):
        prefix, _, suffix = name.partition("_")
        path = os.path.join(work_dir, name)
        if prefix not in ("epoch", "step") or not suffix.isdigit() or not os.path.isfile(
                os.path.join(path, META_FILE)):
            continue
        key = (os.path.getmtime(os.path.join(path, META_FILE)), int(suffix))
        if key > best_key:
            best_key, best = key, path
    return best


def load_checkpoint_file(path: str) -> Dict[str, Any]:
    """{'model': state_dict, 'optimizer': state or absent, 'meta': dict}."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isdir(path):
        raise FileNotFoundError(f"no checkpoint directory at {path}")
    with open(os.path.join(path, META_FILE)) as f:
        payload = {"meta": json.load(f)}
    payload["model"] = torch.load(os.path.join(path, MODEL_FILE), map_location="cpu",
                                  weights_only=True)
    opt = os.path.join(path, OPTIMIZER_FILE)
    if os.path.exists(opt):
        payload["optimizer"] = torch.load(opt, map_location="cpu", weights_only=True)
    return payload


def _report(what: str, missing, unexpected, mismatched, strict: bool) -> None:
    problems = []
    if missing:
        problems.append(f"missing keys: {sorted(missing)}")
    if unexpected:
        problems.append(f"unexpected keys: {sorted(unexpected)}")
    if mismatched:
        problems.append(f"shape mismatches: {sorted(mismatched)}")
    if problems:
        msg = f"{what}: " + "; ".join(problems)
        if strict:
            raise RuntimeError(msg)
        logger.warning(msg)


def load_model_state(model, state: Dict[str, torch.Tensor], strict: bool = False) -> None:
    """Copy ``state`` into ``model`` by key, into each tensor's own dtype and
    device. Missing, unexpected and mis-shaped keys are logged by name, or
    raised when ``strict``; the others are loaded."""
    have = model.state_dict()
    missing = set(have) - set(state)
    unexpected = set(state) - set(have)
    mismatched = {k for k in set(have) & set(state) if tuple(have[k].shape) != tuple(state[k].shape)}
    _report("load_checkpoint", missing, unexpected, mismatched, strict)
    with torch.no_grad():
        for k in set(have) & set(state) - mismatched:
            have[k].copy_(state[k])


def _is_buffer(v) -> bool:
    """A per-element buffer (momentum, moments), not a 0-d count such as
    AdamW's ``step``, which stays where the optimizer keeps it."""
    return isinstance(v, torch.Tensor) and v.dim() > 0


def load_optimizer_state(model, optimizer, state: Dict[str, Any], strict: bool = False) -> None:
    """Restore ``optimizer_state``'s output by parameter name: each
    parameter's buffers (on the parameter's device), the step count and the
    update count the schedule reads."""
    names = _named_params(model, optimizer)
    by_name = {names[id(p)]: p for p in optimizer.params}
    saved = state["state"]
    missing = set(by_name) - set(saved)
    unexpected = set(saved) - set(by_name)
    mismatched = {n for n in set(by_name) & set(saved) for v in saved[n].values()
                  if _is_buffer(v) and tuple(v.shape) != tuple(by_name[n].shape)}
    _report("optimizer state", missing, unexpected, mismatched, strict)
    per_param = optimizer.torch_optimizer.state
    for n in set(by_name) & set(saved) - mismatched:
        p = by_name[n]
        per_param[p] = {k: v.to(p.device) if _is_buffer(v) else v for k, v in saved[n].items()}
    optimizer.steps = int(state["steps"])
    optimizer.count = int(state["count"])


def load_checkpoint(model, filename: str, strict: bool = False, optimizer=None) -> Dict[str, Any]:
    """Load a checkpoint directory saved by ``save_checkpoint`` into
    ``model`` (and ``optimizer``'s state, where given and saved); returns
    its meta. ``torch://`` and ``modelzoo://`` sources are not ported yet."""
    if "://" in filename:
        raise NotImplementedError(f"checkpoint source {filename!r}: importing torch or model-zoo "
                                  "weights waits for the port's models/torch_import.py")
    payload = load_checkpoint_file(filename)
    load_model_state(model, payload["model"], strict=strict)
    if optimizer is not None:
        if "optimizer" not in payload:
            raise ValueError(f"{filename} holds no optimizer state")
        load_optimizer_state(model, optimizer, payload["optimizer"], strict=strict)
    return payload["meta"]
