"""Checkpoint save and load, in torch's format.

Counterpart of ``torch_detection_tpu/engine/checkpoint.py``. A checkpoint is
a directory: ``model.pt`` (the model's ``state_dict``), ``optimizer.pt``
(the optimizer's state keyed by parameter name, its step and update counts),
``ema.pt`` where the optimizer keeps an EMA of the parameters (each average
by parameter name) and ``meta.json`` (epoch, step, ``batches_done`` of a
mid-epoch save, time).
Loading reports missing and unexpected keys by name, and the optimizer's
state is restored by parameter name, never by position. ``torch://`` loads
a torchvision or mmdetection ``.pth`` through ``models/torch_import.py``;
``modelzoo://<arch>``, ``http(s)://`` and ``file://`` sources are fetched
into a cache directory once and loaded from there.

A model sharded by FSDP saves its whole, unsharded state, in the format of
a one-process checkpoint (every rank gathers, rank 0 writes), and loads a
whole state into each rank's shards. In a group of several ranks only rank
0 writes.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from ..models.torch_import import detector_key_rules, load_torch_checkpoint, load_torch_weights
from ..parallel.distributed import is_main
from ..parallel.mesh import copy_full_, full_tensor, shard_like

logger = logging.getLogger(__name__)

MODEL_FILE, OPTIMIZER_FILE, META_FILE = "model.pt", "optimizer.pt", "meta.json"
EMA_FILE = "ema.pt"


def _named_params(model, optimizer) -> Dict[int, str]:
    """id(parameter) -> name, for the optimizer's parameters."""
    names = {id(p): n for n, p in model.named_parameters()}
    missing = [i for i, p in enumerate(optimizer.params) if id(p) not in names]
    if missing:
        raise ValueError(f"optimizer parameters {missing} are not the model's")
    return names


def optimizer_state(model, optimizer) -> Dict[str, Any]:
    """The optimizer's state keyed by the model's parameter names, each
    sharded buffer whole (every rank must call it under FSDP)."""
    names = _named_params(model, optimizer)
    per_param = optimizer.torch_optimizer.state
    return {
        "state": {names[id(p)]: {k: full_tensor(v) if isinstance(v, torch.Tensor) else v
                                 for k, v in per_param[p].items()}
                  for p in optimizer.params if p in per_param},
        "steps": optimizer.steps,
        "count": optimizer.count,
    }


def save_checkpoint(path: str, model, optimizer=None, meta: Optional[Dict] = None,
                    with_ema: bool = True) -> None:
    """Write the model's ``state_dict``, the optimizer's state (if given),
    its EMA (if it keeps one and ``with_ema``) and ``meta`` (with the time)
    into the directory ``path``. The files are written under temporary
    names and renamed, so a checkpoint that exists is whole. In a group of
    several ranks only rank 0 writes; under FSDP every rank must call it,
    since the shards are gathered first."""
    payloads = [(MODEL_FILE, {k: full_tensor(v) for k, v in model.state_dict().items()})]
    if optimizer is not None:
        payloads.append((OPTIMIZER_FILE, optimizer_state(model, optimizer)))
        if with_ema and optimizer.ema is not None:
            payloads.append((EMA_FILE, optimizer.ema.state_dict()))
    if not is_main():
        return
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(path, exist_ok=True)
    meta = dict(meta or {})
    meta.setdefault("time", time.asctime())
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
    """{'model': state_dict, 'optimizer': state or absent, 'ema': averages
    or absent, 'meta': dict}."""
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
    ema = os.path.join(path, EMA_FILE)
    if os.path.exists(ema):
        payload["ema"] = torch.load(ema, map_location="cpu", weights_only=True)
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
        for k in sorted(set(have) & set(state) - mismatched):
            copy_full_(have[k], state[k])


def _is_buffer(v) -> bool:
    """A per-element buffer (momentum, moments), not a 0-d count such as
    AdamW's ``step``, which stays where the optimizer keeps it."""
    return isinstance(v, torch.Tensor) and v.dim() > 0


def load_optimizer_state(model, optimizer, state: Dict[str, Any], strict: bool = False) -> None:
    """Restore ``optimizer_state``'s output by parameter name: each
    parameter's buffers (on the parameter's device, sharded as the
    parameter), the step count and the update count the schedule reads."""
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
        per_param[p] = {k: shard_like(v, p) if _is_buffer(v) else v for k, v in saved[n].items()}
    optimizer.steps = int(state["steps"])
    optimizer.count = int(state["count"])


# ``modelzoo://<arch>`` aliases: torchvision's ImageNet weights, as the
# reference resolves them, for the backbones the importer has tables for
MODELZOO_URLS = {
    "resnet18": "https://download.pytorch.org/models/resnet18-5c106cde.pth",
    "resnet34": "https://download.pytorch.org/models/resnet34-333f7ec4.pth",
    "resnet50": "https://download.pytorch.org/models/resnet50-19c8e357.pth",
    "resnet101": "https://download.pytorch.org/models/resnet101-5d3b4d8f.pth",
    "resnet152": "https://download.pytorch.org/models/resnet152-b121ed2d.pth",
    "resnext50_32x4d": "https://download.pytorch.org/models/resnext50_32x4d-7cdf4587.pth",
    "resnext101_32x8d": "https://download.pytorch.org/models/resnext101_32x8d-8ba56ff5.pth",
    "vgg16": "https://download.pytorch.org/models/vgg16-397923af.pth",
    "mobilenet_v2": "https://download.pytorch.org/models/mobilenet_v2-b0353104.pth",
}


def default_cache_dir() -> str:
    return os.path.join(os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache")),
                        "torch_detection_tpu", "checkpoints")


def resolve_checkpoint_source(filename: str, cache_dir: Optional[str] = None) -> str:
    """A checkpoint source -> what ``load_checkpoint`` reads:

    * ``modelzoo://<arch>`` -> its torchvision URL (``MODELZOO_URLS``), then
      as a URL;
    * ``http(s)://`` and ``file://`` -> a copy in ``cache_dir`` (default
      ``~/.cache/torch_detection_tpu/checkpoints``), fetched once by its
      file name and reused; a ``.pth``/``.pt`` comes back as ``torch://``;
    * ``torch://`` and local paths pass through.

    A fetch that is not cached and cannot reach its host raises the
    ``URLError``."""
    if filename.startswith("modelzoo://"):
        arch = filename[len("modelzoo://"):]
        if arch not in MODELZOO_URLS:
            raise KeyError(f"unknown modelzoo alias {arch!r}; known: {sorted(MODELZOO_URLS)}")
        filename = MODELZOO_URLS[arch]
    if filename.startswith(("http://", "https://", "file://")):
        from urllib.parse import urlparse
        from urllib.request import urlretrieve

        cache_dir = cache_dir or default_cache_dir()
        os.makedirs(cache_dir, exist_ok=True)
        local = os.path.join(cache_dir, os.path.basename(urlparse(filename).path) or "checkpoint")
        if not os.path.exists(local):
            logger.info("fetching %s -> %s", filename, local)
            urlretrieve(filename, local + ".part")
            os.replace(local + ".part", local)
        return "torch://" + local if local.endswith((".pth", ".pt")) else local
    return filename


def load_checkpoint(model, filename: str, strict: bool = False, optimizer=None,
                    cache_dir: Optional[str] = None) -> Dict[str, Any]:
    """Load weights into ``model`` and return the checkpoint's meta.

    * ``torch://<file.pth>`` imports a torch state dict through the rules
      ``detector_key_rules`` picks for the model and the file: a backbone's
      state dict into a detector's ``backbone.``, a whole mmdetection
      detector's through its table, a ResNet's into a ResNet; the meta names
      the source and the port keys loaded;
    * ``modelzoo://``, ``http(s)://`` and ``file://`` resolve first
      (``resolve_checkpoint_source``);
    * anything else is a directory saved by ``save_checkpoint``, with the
      optimizer's state too where ``optimizer`` is given, and its EMA where
      the optimizer keeps one: restored from ``ema.pt``, or started from
      the loaded parameters when the checkpoint has none (as the
      reference's resume of an EMA run from a checkpoint without one).

    Missing and unexpected keys are logged by name, or raised when
    ``strict``."""
    filename = resolve_checkpoint_source(filename, cache_dir=cache_dir)
    if filename.startswith("torch://"):
        state = load_torch_checkpoint(filename[len("torch://"):])
        loaded = load_torch_weights(model, state, detector_key_rules(model, state), strict=strict)
        return {"source": filename, "loaded": loaded}
    payload = load_checkpoint_file(filename)
    load_model_state(model, payload["model"], strict=strict)
    if optimizer is not None:
        if "optimizer" not in payload:
            raise ValueError(f"{filename} holds no optimizer state")
        load_optimizer_state(model, optimizer, payload["optimizer"], strict=strict)
        if optimizer.ema is not None:
            if "ema" in payload:
                optimizer.ema.load_state_dict(payload["ema"])
            else:
                logger.info("%s holds no EMA: the EMA starts from its parameters", filename)
                optimizer.ema.reset()
    return payload["meta"]
