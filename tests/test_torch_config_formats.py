"""Config files in json and yaml: the port's ``file_handler`` (pkl, json and
yaml), ``Config.fromfile`` of every format with ``_base_`` across formats,
``Config.dump``, and the data tier and the CLIs on a config that holds
lists where the ``.py`` file held tuples.

- The reference's ``tests/test_utils.py`` cases on the port's
  ``file_handler``: the round trip of each format, file objects, a bad
  format, ``fromfile`` of a yaml file.
- Each of the 24 configs under ``configs/``, one case each: the JAX
  package's ``Config.dump`` to json and yaml, read by the port's
  ``fromfile``, equals the JAX ``fromfile`` of the same file and the
  ``.py`` file's tree as plain dicts; the port's ``Config.dump`` to every
  format reads back through the JAX ``fromfile``; ``build_detection_cfg``
  of a yaml-loaded config equals the ``.py``'s.
- The first training batch and the first val sample from ``.py``, json and
  yaml configs are the same bit for bit, on the PNG fixture.
- ``tools.train`` on the CPU from a json child of a ``.py`` config's yaml
  dump, and ``tools.test`` (on one image) of its checkpoint from the yaml
  dump; the five CLIs' help names the formats.
- Without PyYAML a yaml file raises an ``ImportError`` that names it.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_data import write_png_coco
from test_torch_tools import _write_config
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch.builder import build_detection_cfg, build_train_loader
from torch_detection_tpu_torch.data import get_datasets
from torch_detection_tpu_torch.data.container import DataContainer
from torch_detection_tpu_torch.tools import dump_proposals as dump_cli
from torch_detection_tpu_torch.tools import export as export_cli
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli
from torch_detection_tpu_torch.tools import visualize as visualize_cli
from torch_detection_tpu_torch.utils import Config, dump, load
from torch_detection_tpu_torch.utils.config import _to_plain

CONFIGS = Path(__file__).resolve().parent.parent / "configs"
NAMES = sorted(p.stem for p in CONFIGS.glob("*.py"))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_there_are_24_configs():
    assert len(NAMES) == 24


# ------------------------------------------------ the reference's file handler cases
@pytest.mark.parametrize("ext", ["pkl", "json", "yaml", "yml"])
def test_file_handler_roundtrip(tmp_path, ext):
    obj = {"a": 1, "b": [1, 2, 3], "c": "x"}
    path = tmp_path / f"f.{ext}"
    dump(obj, str(path))
    assert load(str(path)) == obj
    assert load(path) == obj


@pytest.mark.parametrize("fmt", ["json", "yaml"])
def test_file_handler_file_objects(tmp_path, fmt):
    path = tmp_path / "f.txt"
    with open(path, "w") as f:
        dump({"k": 1}, f, file_format=fmt)
    with open(path) as f:
        assert load(f, file_format=fmt) == {"k": 1}


def test_file_handler_bad_format(tmp_path):
    with pytest.raises(ValueError, match="xyz"):
        load(str(tmp_path / "f.xyz"))
    with pytest.raises(ValueError, match="xyz"):
        Config.fromfile(tmp_path / "f.xyz")


def test_fromfile_yaml(tmp_path):
    (tmp_path / "c.yaml").write_text("a: 1\nb:\n  c: 2\n")
    cfg = Config.fromfile(tmp_path / "c.yaml")
    assert cfg.a == 1 and cfg.b.c == 2


def test_yaml_reads_safely(tmp_path):
    (tmp_path / "c.yaml").write_text("a: !!python/tuple [1, 2]\n")
    import yaml

    with pytest.raises(yaml.YAMLError):
        Config.fromfile(tmp_path / "c.yaml")


@pytest.mark.parametrize("suffix", ["yaml", "yml"])
def test_missing_pyyaml_raises_by_name(tmp_path, monkeypatch, suffix):
    path = tmp_path / f"c.{suffix}"
    path.write_text("a: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match=f"PyYAML.*c.{suffix}|c.{suffix}.*PyYAML"):
        Config.fromfile(path)
    with pytest.raises(ImportError, match="PyYAML"):
        dump({"a": 1}, str(tmp_path / f"d.{suffix}"))
    assert Config.fromfile(CONFIGS / "faster_rcnn_r50_fpn_coco.py").model.type == \
        "TwoStageDetector"


# ------------------------------------------------------------- inheritance across formats
def test_base_chain_across_formats_and_delete(tmp_path):
    (tmp_path / "base.py").write_text(
        "lr = 0.1\nmodel = dict(type='ResNet', depth=50, out_indices=(0, 1))\n"
        "data = dict(train=dict(size=(1333, 800), flip=0.5))\n")
    (tmp_path / "mid.yaml").write_text(
        "_base_: base.py\nmodel:\n  depth: 101\ndata:\n  train:\n    _delete_: true\n"
        "    size: [640, 480]\n")
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "child.json").write_text(json.dumps(
        {"_base_": ["../mid.yaml"], "lr": 0.02, "model": {"frozen": 1}}))
    (tmp_path / "sub" / "leaf.pkl").write_bytes(b"")
    dump({"_base_": "child.json", "extra": (1, 2)}, str(tmp_path / "sub" / "leaf.pkl"))
    cfg = Config.fromfile(tmp_path / "sub" / "child.json")
    assert cfg == {"lr": 0.02,
                   "model": {"type": "ResNet", "depth": 101, "out_indices": (0, 1), "frozen": 1},
                   "data": {"train": {"size": [640, 480]}}}
    assert cfg.model.depth == 101 and "_base_" not in cfg
    leaf = Config.fromfile(tmp_path / "sub" / "leaf.pkl")
    assert leaf.extra == (1, 2) and leaf.data.train.size == [640, 480]
    assert leaf == JaxConfig.fromfile(tmp_path / "sub" / "leaf.pkl")
    assert cfg == JaxConfig.fromfile(tmp_path / "sub" / "child.json")


# --------------------------------------------------------------- the 24 configs
@pytest.mark.parametrize("name", NAMES)
def test_config_round_trips_with_the_jax_package(tmp_path, name):
    py = Config.fromfile(CONFIGS / f"{name}.py")
    plain = _to_plain(py)
    for fmt in ("json", "yaml"):
        jax_dump = tmp_path / f"jax.{fmt}"
        JaxConfig.fromfile(CONFIGS / f"{name}.py").dump(str(jax_dump))
        got = Config.fromfile(jax_dump)
        assert got == JaxConfig.fromfile(jax_dump) and got == plain, fmt
    for fmt in ("json", "yaml", "yml", "pkl"):
        path = tmp_path / f"port.{fmt}"
        py.dump(path)
        assert JaxConfig.fromfile(path) == plain, fmt
    loaded = Config.fromfile(tmp_path / "port.yaml")
    assert build_detection_cfg(loaded.detection) == build_detection_cfg(py.detection)


# ------------------------------------------------------- the data tier and the CLIs
def _tiny_config(root: Path, coco: dict) -> Path:
    """``test_torch_tools.py``'s tiny Faster R-CNN config, with two training
    scales and flips, written as ``.py``."""
    path = Path(_write_config(root / "tiny.py", coco, val_interval_epochs=0))
    path.write_text(path.read_text() + (
        "data['train'].update(img_expected_sizes=[(64, 48), (56, 40)], flip_ratio=0.5)\n"))
    return path


@pytest.fixture(scope="module")
def formats(tmp_path_factory):
    """The tiny config as ``.py``, its yaml dump, and a json child of the
    yaml with its own ``log_interval``: three paths to one config."""
    root = tmp_path_factory.mktemp("formats")
    py = _tiny_config(root, write_png_coco(root / "coco"))
    Config.fromfile(py).dump(root / "tiny.yaml")
    (root / "child.json").write_text(json.dumps({"_base_": "tiny.yaml",
                                                 "runtime": {"log_interval": 1}}))
    return {"py": py, "yaml": root / "tiny.yaml", "json": root / "child.json"}


def _same(got, want, what: str) -> None:
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, what
        assert np.array_equal(got, want, equal_nan=True), what
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            _same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, DataContainer):
        assert isinstance(got, DataContainer), what
        assert (got.stack, got.cpu_only) == (want.stack, want.cpu_only), what
        _same(got.data, want.data, f"{what}.data")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{what}[{i}]")
    else:
        assert type(got) is type(want) and got == want, what


def test_first_batch_is_the_same_from_every_format(formats):
    cfgs = {fmt: Config.fromfile(path) for fmt, path in formats.items()}
    assert isinstance(cfgs["yaml"].data.train.img_expected_sizes[0], list)
    batches, samples = {}, {}
    for fmt, cfg in cfgs.items():
        loader = build_train_loader(cfg)
        loader.set_epoch(1)
        batches[fmt] = next(iter(loader))
        samples[fmt] = get_datasets(dict(cfg.data.val))[0]
    assert batches["py"]["image"].shape[0] == 2
    for fmt in ("yaml", "json"):
        _same(batches[fmt], batches["py"], f"{fmt} batch")
        _same(samples[fmt], samples["py"], f"{fmt} val sample")


def test_train_and_test_clis_from_every_format(formats, tmp_path):
    """``tools.train`` from the json child (whose ``_base_`` is the yaml dump
    of the ``.py`` config) takes its steps, and ``tools.test`` of its
    checkpoint runs from the yaml dump. (The first batch and the config
    trees are held equal above; on the card ``chip_smoke.py`` holds the
    formats' first losses and ``tools.test`` detections equal at full
    width.)"""
    trainer = train_cli.main([str(formats["json"]), "--epochs", "1", "--work-dir",
                              str(tmp_path / "json"), "--device", "cpu"])
    losses = [r["loss"] for r in trainer.history if "loss" in r]
    assert len(losses) == 2 and all(np.isfinite(losses))
    metrics = test_cli.main([str(formats["yaml"]), str(tmp_path / "json" / "epoch_1"),
                             "--max-images", "1", "--device", "cpu"])
    assert len(metrics) == 12 and all(np.isfinite(list(metrics.values())))


@pytest.mark.parametrize("cli", [train_cli, test_cli, export_cli, dump_cli, visualize_cli],
                         ids=["train", "test", "export", "dump_proposals", "visualize"])
def test_cli_help_names_the_config_formats(cli, capsys):
    with pytest.raises(SystemExit) as done:
        cli.main(["--help"])
    assert done.value.code == 0
    assert "config (.py, .json, .yaml, .yml)" in " ".join(capsys.readouterr().out.split())
