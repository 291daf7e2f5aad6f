"""The backbone zoo against the JAX package's, on the CPU in float32.

* ``layers``: ``channel_shuffle`` and ``channel_split`` bit for bit (the
  reference's channel order on NHWC's last axis), ``avg_pool_torch`` and
  ``SELayer`` to 1e-6, ``ConvModule`` with grouped and depthwise convs to
  1e-5;
* ``ResNeXt`` (32x4d), ``SEResNet``, ``SEResNeXt`` (depth 50),
  ``MobileNet`` (1.0), ``MobileNetV2`` (with its last conv), ``ShuffleNet``
  (3 groups) and ``ShuffleNetV2`` (1.0x) at their published widths on a
  64 x 96 image, on the reference's seeded variables carried by
  ``from_jax_variables`` with ``strict=True``: every output within 1e-4 of
  its largest value; ``frozen_stages`` leaves without a gradient exactly
  the parameters whose gradient the reference's stop-gradient zeroes;
* the importer: torchvision-named MobileNetV2 and ResNeXt-50 state dicts
  through the port's importer equal the reference's import carried into the
  port, and the port models give the torch models' outputs to 1e-5; a
  torchvision MobileNetV2 sets the 255 backbone tensors of the MobileNetV2
  RetinaNet.

The three RetinaNet configs these backbones and PAFPN serve are held whole
in ``test_torch_light_retinanet.py`` and ``test_torch_pafpn.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_refs
from test_torch_torch_import import _assert_equal_states, _both_imports, _zeros_like_init
from test_torch_vgg import nchw, near, rel_close, seeded_variables
from torch_detection_tpu.engine.checkpoint import MODELZOO_URLS as JAX_URLS
from torch_detection_tpu.models import backbones as jax_backbones
from torch_detection_tpu.models import layers as jax_layers
from torch_detection_tpu.models import torch_import as jax_import
from torch_detection_tpu_torch.builder import build_detector
from torch_detection_tpu_torch.engine.checkpoint import MODELZOO_URLS
from torch_detection_tpu_torch.models import backbones, from_jax_variables, layers
from torch_detection_tpu_torch.models.torch_import import (
    RESNET_KEY_RULES,
    backbone_key_rules,
    detector_key_rules,
    load_torch_weights,
    mobilenetv2_key_rules,
)
from torch_detection_tpu_torch.utils.config import Config
from torch_detection_tpu_torch.utils.registry import BACKBONES

CONFIGS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "configs")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def carried(jax_module, port_module, rng, *args, damp_residuals=False):
    """Seeded variables for ``jax_module`` (``jax.eval_shape``'s tree, nothing
    compiled) loaded into ``port_module`` with ``strict=True``. With
    ``damp_residuals`` the FrozenBN scale that ends each ResNet bottleneck's
    branch (``block3``) is cut to a fifth, so that 16 blocks of seeded
    weights keep their features' scale, as a trained ResNet does."""
    shapes = jax.eval_shape(jax_module.init, jax.random.PRNGKey(0), *args)
    variables = seeded_variables(shapes, rng)
    if damp_residuals:
        def damp(path, v):
            keys = [getattr(p, "key", "") for p in path]
            return v * np.float32(0.2) if keys[-3:] == ["block3", "norm", "scale"] else v
        variables = jax.tree_util.tree_map_with_path(damp, variables)
    port_module.load_state_dict(from_jax_variables(variables, port_module), strict=True)
    return variables


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("groups", [2, 3, 4])
def test_channel_shuffle_is_the_references_order(rng, groups):
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    want = jax_layers.channel_shuffle(jnp.asarray(x), groups)
    got = layers.channel_shuffle(nchw(x).contiguous(memory_format=torch.channels_last), groups)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


@pytest.mark.parametrize("sections", [2, 4])
def test_channel_split_is_the_references(rng, sections):
    x = rng.normal(size=(2, 5, 7, 12)).astype(np.float32)
    want = jax_layers.channel_split(jnp.asarray(x), sections)
    got = layers.channel_split(nchw(x), sections)
    assert len(got) == len(want) == sections
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.permute(0, 2, 3, 1).numpy(), np.asarray(w))


@pytest.mark.parametrize("window,stride,padding", [(3, 2, 1), (3, 1, 1), (2, 2, 0)])
def test_avg_pool_counts_the_padding_as_the_reference(rng, window, stride, padding):
    x = rng.normal(size=(2, 9, 11, 6)).astype(np.float32)
    want = jax_layers.avg_pool_torch(jnp.asarray(x), window, stride, padding)
    got = layers.avg_pool_torch(nchw(x), window, stride, padding)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("channels,reduction", [(32, 16), (12, 16)], ids=["hidden2", "hidden1"])
def test_se_layer_matches_flax(rng, channels, reduction):
    """``fc1``/``fc2`` are flax's ``Dense`` kernels transposed; at 12
    channels the hidden width is held at 1."""
    x = rng.normal(size=(2, 5, 6, channels)).astype(np.float32)
    jax_se = jax_layers.SELayer(channels, reduction)
    se = layers.SELayer(channels, reduction, device="cpu")
    variables = carried(jax_se, se, rng, jnp.asarray(x))
    assert se.fc1.weight.shape == (max(channels // reduction, 1), channels)
    want = jax_se.apply(variables, jnp.asarray(x))
    got = se(nchw(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cin,cout,groups,stride", [(8, 12, 4, 1), (12, 12, 12, 2)],
                         ids=["grouped", "depthwise"])
def test_grouped_conv_module_matches_flax(rng, cin, cout, groups, stride):
    """(kh, kw, cin / g, cout) kernels map to (cout, cin / g, kh, kw) by the
    converter's HWIO -> OIHW rule."""
    x = rng.normal(size=(2, 9, 11, cin)).astype(np.float32)
    kw = dict(stride=stride, padding=1, groups=groups, norm_cfg={"type": "FrozenBN"}, act="relu6")
    jax_conv = jax_layers.ConvModule(cout, 3, **kw)
    conv = layers.ConvModule(cin, cout, 3, **kw, device="cpu")
    variables = carried(jax_conv, conv, rng, jnp.asarray(x))
    assert conv.conv.weight.shape == (cout, cin // groups, 3, 3)
    want = jax_conv.apply(variables, jnp.asarray(x))
    near(conv(nchw(x)).permute(0, 2, 3, 1).detach().numpy(), np.asarray(want), 1e-5)


# ---------------------------------------------------------------- backbones

PUBLISHED = {
    "ResNeXt": dict(depth=50),  # 32x4d
    "SEResNet": dict(depth=50),
    "SEResNeXt": dict(depth=50),
    "MobileNet": dict(width_multi=1.0),
    "MobileNetV2": dict(with_last_conv=True),
    "ShuffleNet": dict(groups=3),
    "ShuffleNetV2": dict(width_mult=1.0),
}


@pytest.mark.parametrize("name", list(PUBLISHED))
def test_backbone_matches_the_reference_at_its_published_width(rng, name):
    x = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    jax_net = getattr(jax_backbones, name)(**PUBLISHED[name])
    net = BACKBONES.build(dict(PUBLISHED[name], type=name), device="cpu").eval()
    variables = carried(jax_net, net, rng, jnp.asarray(x))
    want = jax.jit(jax_net.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = net(torch.from_numpy(x))
    assert len(got) == len(want) == len(net.out_channels)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.shape[-1] == net.out_channels[i], (i, g.shape, w.shape)
        rel_close(g.numpy(), np.asarray(w), 1e-4, f"{name} output {i}")


FROZEN = [
    ("SEResNeXt", dict(depth=50, num_stages=2, out_indices=(0, 1), frozen_stages=1)),  # SE too
    ("MobileNet", dict(width_multi=0.25, num_stages=3, out_indices=(1, 2), frozen_stages=2)),
    # the last conv sits after the stop-gradient, so it trains
    ("MobileNetV2", dict(num_stages=3, out_indices=(0, 2), frozen_stages=3, with_last_conv=True)),
    ("ShuffleNet", dict(groups=1, num_stages=2, out_indices=(0, 1), frozen_stages=1)),
    ("ShuffleNetV2", dict(width_mult=0.5, num_stages=2, out_indices=(0, 1), frozen_stages=1)),
    # conv5 sits before it, and freezes with the last stage
    ("ShuffleNetV2", dict(width_mult=0.5, num_stages=2, out_indices=(1,), frozen_stages=2)),
]


@pytest.mark.parametrize("name,kwargs", FROZEN,
                         ids=[f"{n}-{k['frozen_stages']}" for n, k in FROZEN])
def test_frozen_stages_are_the_references_stop_gradient(rng, name, kwargs):
    x = rng.normal(size=(2, 32, 32, 3)).astype(np.float32)
    jax_net = getattr(jax_backbones, name)(**kwargs)
    net = BACKBONES.build(dict(kwargs, type=name), device="cpu").train()
    variables = carried(jax_net, net, rng, jnp.asarray(x))

    def loss(params):
        outs = jax_net.apply({"params": params, **{k: v for k, v in variables.items()
                                                   if k != "params"}}, jnp.asarray(x))
        return sum(jnp.mean(o ** 2) for o in outs)

    grads = from_jax_variables({"params": jax.jit(jax.grad(loss))(variables["params"])}, net)
    stopped = {n for n, g in grads.items() if not g.any()}
    frozen = {n for n, p in net.named_parameters() if not p.requires_grad}
    assert frozen and frozen == stopped
    if len(frozen) < len(grads):
        sum(o.pow(2).mean() for o in net(torch.from_numpy(x))).backward()
    for n, p in net.named_parameters():
        assert (p.grad is None) == (n in frozen), n


# ---------------------------------------------------------------- importer


def _torch_mobilenet_v2():
    torch.manual_seed(7)
    return torch_refs.TorchMobileNetV2(), backbones.MobileNetV2(out_indices=(2, 4, 6), device="cpu"), \
        jax_backbones.MobileNetV2(out_indices=(2, 4, 6)), \
        jax_import.mobilenetv2_key_rules(with_last_conv=False), (1, 64, 96, 3)


def _torch_resnext50():
    torch.manual_seed(8)
    return torch_refs.torch_resnext50_32x4d(), backbones.ResNeXt(depth=50, device="cpu"), \
        jax_backbones.ResNeXt(depth=50), jax_import.RESNET_KEY_RULES, (1, 64, 64, 3)


@pytest.mark.parametrize("make", [_torch_mobilenet_v2, _torch_resnext50],
                         ids=["mobilenet_v2", "resnext50_32x4d"])
def test_torchvision_import_equals_the_references(make):
    tmodel, net, jax_net, jax_rules, shape = make()
    torch_refs.randomize_bn_stats(tmodel, seed=7)
    tmodel.eval()
    state = tmodel.state_dict()
    rules = backbone_key_rules(net, state)
    assert rules == (mobilenetv2_key_rules(False) if isinstance(net, backbones.MobileNetV2)
                     else list(RESNET_KEY_RULES))
    x = np.random.default_rng(8).normal(0, 1, shape).astype(np.float32)
    variables = _zeros_like_init(jax_net, jnp.asarray(x))
    got, want, loaded = _both_imports(net, variables, state, rules, jax_rules)
    _assert_equal_states(got, want)
    assert sorted(loaded) == sorted(net.state_dict())
    with torch.no_grad():
        outs = net.eval()(torch.from_numpy(x))
        refs = tmodel(nchw(x))
    for g, w in zip(outs, refs, strict=True):
        near(g.numpy(), w.permute(0, 2, 3, 1).numpy(), 1e-5)


@pytest.mark.parametrize("prefix", ["", "backbone."], ids=["backbone_only", "whole_detector"])
def test_a_torchvision_mobilenet_v2_sets_the_retinanet_backbone(prefix):
    """A torchvision MobileNetV2 state dict into the MobileNetV2 RetinaNet,
    alone (anchored under ``backbone.``) or as a whole detector's
    ``backbone.*`` keys (the detector's table takes the backbone's): every
    one of its 255 tensors set (51 convs and their FrozenBN's four),
    ``features.18`` and ``classifier.*`` dropped; the alias names the
    reference's URL."""
    cfg = Config.fromfile(os.path.join(CONFIGS, "retinanet_mobilenetv2_fpn_coco.py"))
    model = build_detector(cfg.model, "float32", device="cpu", seed=0)
    torch.manual_seed(9)
    state = dict(torch_refs.TorchMobileNetV2().state_dict(),
                 **{"classifier.1.weight": torch.zeros(4, 1280), "classifier.1.bias": torch.zeros(4)})
    state = {prefix + k: v for k, v in state.items()}
    loaded = load_torch_weights(model, state, detector_key_rules(model, state))
    backbone = [k for k in model.state_dict() if k.startswith("backbone.")]
    assert sorted(loaded) == sorted(backbone) and len(loaded) == 255
    torch.testing.assert_close(model.backbone.layer7_0.project.conv.weight,
                               state[prefix + "features.17.conv.2.weight"], rtol=0, atol=0)
    assert MODELZOO_URLS["mobilenet_v2"] == JAX_URLS["mobilenet_v2"]
