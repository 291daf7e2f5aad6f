"""The layer support of the SSD and YOLOv3 slices, the VGG trunks and their
importer tables, against the JAX package's and torch's.

* ``layers``: every activation of the reference's table (LeakyReLU's slope
  0.1), ``ConvModule`` with dilation and an explicit bias, flax's SAME
  max-pool on odd sizes, the nearest 2x upsample;
* ``VGG`` against the reference's on converted weights (``from_jax_variables``
  with ``strict=True``), plain and with FrozenBN;
* ``vgg_key_rules`` and ``ssd_vgg_key_rules``: seeded state dicts in
  torchvision's layout (``torch_refs.TorchVGG``) and in the port's SSDVGG
  layout (``torch_refs.TorchSSDVGG``) through the port's importer, equal to
  the reference importer's result carried by ``from_jax_variables``, and the
  port models against the torch models; a torchvision VGG16 into an SSD300
  detector sets its 13 trunk convs (26 tensors) and drops ``classifier.*``;
* ``tools.train --pretrained file://`` of a torchvision VGG16 ``.pth`` on
  SSD300 (2 classes, float32, b2 on its 300 x 300 canvas, two steps on the
  JPEG COCO fixture), reporting 26 tensors set, then ``tools.test``.

Tolerances: activations 1e-6 of max(1, |x|); the convs, pools and upsample
1e-5 relative to max(1, max |want|) (pools and upsample exactly); the trunks
1e-4 relative to each output's largest value (float32 through up to 13
convs summed in other orders); the converted state dicts exactly.
"""

import logging
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import torch_refs
from data_fixtures import make_coco
from test_torch_engine import METRICS
from torch_detection_tpu.models import layers as jax_layers
from torch_detection_tpu.models.backbones import SSDVGG as JaxSSDVGG
from torch_detection_tpu.models.backbones import VGG as JaxVGG
from torch_detection_tpu.models import torch_import as jax_import
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.models import from_jax_variables, layers
from torch_detection_tpu_torch.models.backbones import SSDVGG, VGG
from torch_detection_tpu_torch.models.torch_import import (
    convert_state_dict,
    detector_key_rules,
    load_torch_weights,
    ssd_vgg_key_rules,
    vgg_key_rules,
)
from torch_detection_tpu_torch.tools import test as test_cli
from torch_detection_tpu_torch.tools import train as train_cli
from torch_detection_tpu_torch.utils.config import Config

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def seeded_variables(shapes, rng):
    """A flax variable tree of ``shapes`` (``jax.eval_shape``'s) filled from
    ``rng``: kernels normal of variance 2 / fan_in (ReLU's gain, so deep
    trunks keep their scale), biases normal(0, 0.1), FrozenBN's scale, bias,
    mean and var drawn as ``test_torch_model._randomise_frozen_bn`` draws
    them, L2Norm's ``scale`` uniform in [10, 30]."""

    def fill(path, s):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(s.shape[:-1]))
            return rng.normal(0, math.sqrt(2.0 / fan_in), s.shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.5, s.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if name == "scale":
            l2 = any(getattr(p, "key", None) == "l2_norm" for p in path)
            return rng.uniform(*((10, 30) if l2 else (0.5, 1.5)), s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def near(got, want, limit, what=""):
    """``got`` within ``limit`` of max(1, max |want|)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, atol=limit * scale, rtol=0, err_msg=what)


def rel_close(got, want, limit, what=""):
    """``got`` within ``limit`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, atol=limit * float(np.abs(want).max()),
                               rtol=0, err_msg=what)


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("act", ["relu", "relu6", "leaky_relu", "gelu", "silu", "sigmoid"])
def test_activation_matches_flax(rng, act):
    x = rng.normal(0, 4, (3, 5, 7, 6)).astype(np.float32)
    x[0, 0, 0, :3] = [0.0, 6.0, -1.0]
    want = jax_layers.build_act(act)(jnp.asarray(x))
    got = layers.build_act(act)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    if act == "leaky_relu":  # Darknet's slope, not torch's default 0.01
        np.testing.assert_array_equal(got[0, 0, 0, 2].numpy(), np.float32(-1.0) * np.float32(0.1))


@pytest.mark.parametrize("kernel,stride,pad,dilation,use_bias,norm,act", [
    (3, 1, 6, 6, True, None, "relu"),  # SSD's conv6
    (4, 1, 1, 1, True, None, "relu"),  # SSD512's conv12_2
    (3, 2, 1, 1, None, dict(type="FrozenBN"), "leaky_relu"),  # Darknet's down convs
    (1, 1, 0, 1, True, dict(type="FrozenBN"), None),  # a bias before a norm
])
def test_conv_module_matches_flax(rng, kernel, stride, pad, dilation, use_bias, norm, act):
    x = rng.normal(size=(2, 17, 19, 5)).astype(np.float32)
    jax_conv = jax_layers.ConvModule(7, kernel, stride=stride, padding=pad, dilation=dilation,
                                     use_bias=use_bias, norm_cfg=norm, act=act)
    shapes = jax.eval_shape(jax_conv.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = seeded_variables(shapes, rng)
    want = jax_conv.apply(variables, jnp.asarray(x))
    conv = layers.ConvModule(5, 7, kernel, stride=stride, padding=pad, dilation=dilation,
                             use_bias=use_bias, norm_cfg=norm, act=act)
    conv.load_state_dict(from_jax_variables(variables, conv), strict=True)
    assert (conv.conv.bias is not None) == (use_bias if use_bias is not None else norm is None)
    with torch.no_grad():
        got = nhwc(conv(nchw(x)))
    assert got.shape == want.shape
    near(got, want, 1e-5)


@pytest.mark.parametrize("h,w,window,stride", [(75, 75, 2, 2), (19, 19, 3, 1), (7, 10, 2, 2),
                                               (9, 5, 3, 2), (6, 6, 2, 2), (1, 3, 3, 1)])
def test_max_pool_same_matches_flax(rng, h, w, window, stride):
    """flax's SAME: ceil(size / stride) outputs, the smaller half of the
    padding before, -inf fill (the values are all negative, so a 0 fill
    would show)."""
    x = -np.abs(rng.normal(size=(2, h, w, 3))).astype(np.float32) - 1.0
    want = fnn.max_pool(jnp.asarray(x), (window, window), (stride, stride), padding="SAME")
    got = layers.max_pool_same(nchw(x).contiguous(memory_format=torch.channels_last), window,
                               stride)
    assert got.shape[2:] == (math.ceil(h / stride), math.ceil(w / stride))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_resize_nearest_2x_matches_the_reference(rng):
    x = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    t = nchw(x).contiguous(memory_format=torch.channels_last)
    got = layers.resize_nearest_2x(t)
    want = jax_layers.resize_nearest_2x(jnp.asarray(x))
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))
    assert got.is_contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------- VGG


@pytest.mark.parametrize("kwargs", [
    dict(depth=16),
    dict(depth=11, norm_cfg=dict(type="FrozenBN"), strides=(1, 2, 1, 1, 1),
         dilations=(1, 1, 1, 2, 2), out_indices=(1, 3, 4), with_final_maxpool=False),
], ids=["vgg16", "vgg11_bn_dilated"])
def test_vgg_matches_the_reference(rng, kwargs):
    """Stage widths 64/128/256/512/512, the ``layer{s}_{j}`` names, every
    output; the parameter counts equal ``jax.eval_shape``'s."""
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32)
    jax_vgg = JaxVGG(**kwargs)
    shapes = jax.eval_shape(jax_vgg.init, jax.random.PRNGKey(0), jnp.asarray(x))
    variables = seeded_variables(shapes, rng)
    want = jax.jit(jax_vgg.apply)(variables, jnp.asarray(x))
    vgg = VGG(**kwargs, device="cpu").to(memory_format=torch.channels_last)
    vgg.load_state_dict(from_jax_variables(variables, vgg), strict=True)
    assert sum(p.numel() for p in vgg.parameters()) == sum(
        int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert len(got) == len(want) == len(kwargs.get("out_indices", range(5)))
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape
        rel_close(g.numpy(), w, 1e-4)


def test_vgg_frozen_stages_stop_the_gradient():
    vgg = VGG(depth=11, frozen_stages=2, device="cpu")
    frozen = [p for n, p in vgg.named_parameters() if n[:6] in ("layer1", "layer2")]
    assert frozen and not any(p.requires_grad for p in frozen)
    assert all(p.requires_grad for n, p in vgg.named_parameters() if n[:6] == "layer3")


# ---------------------------------------------------------------- importer tables


def _reference_import(jax_module, x, state, rules):
    """The reference importer's tree for ``state`` (flax shapes from
    ``jax.eval_shape``, nothing compiled), carried by ``from_jax_variables``."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), jnp.asarray(x))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    return from_jax_variables(jax_import.load_torch_weights(zeros, state, key_rules=rules,
                                                            strict=True))


def _seeded_torch(model, seed):
    torch.manual_seed(seed)
    for p in model.parameters():  # a bias small, a weight at its own init
        if p.dim() == 1:
            with torch.no_grad():
                p.normal_(0, 0.1)
    return model.eval()


def test_vgg_key_rules_match_the_reference_and_torchvision(rng):
    tm = _seeded_torch(torch_refs.TorchVGG(16), 1)
    state = dict(tm.state_dict())
    state["classifier.0.weight"] = torch.zeros(4, 8)  # torchvision's head: dropped
    vgg = VGG(depth=16, device="cpu").to(memory_format=torch.channels_last)
    loaded = load_torch_weights(vgg, state, vgg_key_rules(16), strict=True)
    assert len(loaded) == 26 and set(loaded) == set(vgg.state_dict())
    x = rng.normal(size=(1, 64, 64, 3)).astype(np.float32) * 0.1
    want_state = _reference_import(JaxVGG(depth=16), x, state, jax_import.vgg_key_rules(16))
    for k, v in vgg.state_dict().items():
        assert torch.equal(v, want_state[k]), k
    with torch.no_grad():
        got, want = vgg(torch.from_numpy(x)), tm(nchw(x))
    for g, w in zip(got, want, strict=True):
        rel_close(g.numpy(), nhwc(w), 1e-5)


def test_ssd_vgg_key_rules_match_the_reference_and_torch(rng):
    """``l2_norm.scale`` lands on L2Norm's ``scale`` (the reference's 1-D
    leaf rule takes it through a norm's ``weight`` to the same place)."""
    tm = _seeded_torch(torch_refs.TorchSSDVGG(), 2)
    with torch.no_grad():
        tm.l2_norm.scale.uniform_(10, 30)
    state = tm.state_dict()
    trunk = SSDVGG(device="cpu").to(memory_format=torch.channels_last)
    loaded = load_torch_weights(trunk, state, ssd_vgg_key_rules(), strict=True)
    assert len(loaded) == len(state) == 47 and "l2_norm.scale" in loaded
    x = rng.normal(size=(1, 300, 300, 3)).astype(np.float32) * 0.1
    want_state = _reference_import(JaxSSDVGG(), x, state, jax_import.ssd_vgg_key_rules())
    assert set(want_state) == set(trunk.state_dict())
    for k, v in trunk.state_dict().items():
        assert torch.equal(v, want_state[k]), k
    with torch.no_grad():
        got, want = trunk(torch.from_numpy(x)), tm(nchw(x))
    assert len(got) == len(want) == 6
    for g, w in zip(got, want, strict=True):
        rel_close(g.numpy(), nhwc(w), 1e-5)


def test_torchvision_vgg16_sets_the_ssd_trunk():
    """A torchvision VGG16 state dict (no ``backbone.`` key) into an SSD300
    detector: the 13 trunk convs (26 tensors) under ``backbone.``, the
    classifier dropped, conv6 onwards and the head left as they were."""
    cfg = Config.fromfile(os.path.join(CONFIGS, "ssd300_vgg16_coco.py"))
    model = build_detector(cfg.model, "float32", device="cpu")
    state = dict(_seeded_torch(torch_refs.TorchVGG(16), 3).state_dict())
    state["classifier.6.bias"] = torch.zeros(1000)
    rules = detector_key_rules(model, state)
    converted, unexpected = convert_state_dict(model, state, rules)
    assert unexpected == [] and len(converted) == 26
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_torch_weights(model, state, rules)
    assert len(loaded) == 26 and all(k.startswith("backbone.layer") for k in loaded)
    assert torch.equal(model.backbone.layer5_2.conv.weight, state["features.28.weight"])
    assert torch.equal(model.backbone.layer1_0.conv.bias, state["features.0.bias"])
    for k, v in model.state_dict().items():
        if k not in loaded:
            assert torch.equal(v, before[k]), k


def test_modelzoo_vgg16_alias_points_at_torchvision():
    from torch_detection_tpu.engine.checkpoint import MODELZOO_URLS as JAX_URLS
    from torch_detection_tpu_torch.engine.checkpoint import MODELZOO_URLS

    assert MODELZOO_URLS["vgg16"] == JAX_URLS["vgg16"]


# ---------------------------------------------------------------- the CLI


def test_train_cli_imports_a_torchvision_vgg16_into_ssd300(tmp_path, monkeypatch, caplog):
    """``tools.train --pretrained file://vgg16.pth`` on SSD300 (2 classes,
    float32, b2 on its 300 x 300 canvas): the file is copied into the cache
    and its 26 trunk tensors set; two steps (the landscape and the portrait
    image each fill a batch of their aspect group); then ``tools.test`` on
    ``epoch_1``."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    ann_file, img_dir = make_coco(str(tmp_path / "coco"), with_mask=False)
    config = tmp_path / "ssd.py"
    base = os.path.abspath(os.path.join(CONFIGS, "ssd300_vgg16_coco.py"))
    config.write_text(f"""_base_ = {base!r}
model = dict(head=dict(num_classes=2))
detection = dict(num_classes=2, max_detections=8)
data = dict(
    train=dict(ann_file={ann_file!r}, img_prefix={img_dir!r}),
    val=dict(ann_file={ann_file!r}, img_prefix={img_dir!r}),
    sample_per_replica=2, max_gts=8,
)
schedule = dict(warmup_steps=2)
runtime = dict(compute_dtype="float32", log_interval=1)
""")
    state = dict(_seeded_torch(torch_refs.TorchVGG(16), 4).state_dict())
    state["classifier.0.weight"] = torch.zeros(4, 8)
    pth = tmp_path / "vgg16.pth"
    torch.save(state, str(pth))
    with caplog.at_level(logging.INFO):
        trainer = train_cli.main([str(config), "--epochs", "1", "--work-dir",
                                  str(tmp_path / "work"), "--pretrained", f"file://{pth}",
                                  "--device", "cpu"])
    assert any("loaded 26 tensors" in r.getMessage() and "26 of the backbone's 47" in r.getMessage()
               for r in caplog.records)
    assert (tmp_path / "cache" / "torch_detection_tpu" / "checkpoints" / "vgg16.pth").exists()
    assert trainer.optimizer.steps == 2
    metrics = test_cli.main([str(config), str(tmp_path / "work" / "epoch_1"), "--batch", "2",
                             "--device", "cpu"])
    assert set(metrics) == set(METRICS) and all(math.isfinite(v) for v in metrics.values())
