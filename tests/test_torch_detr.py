"""The port's DETR against the JAX package's: flax's attention with and
without a key mask, the sine encoding over padding, each encoder and decoder
layer, the whole forward, the decode, the weights' conversion, the config
and a full-width build.

The detector is ``tests/test_detr.py``'s ``tiny_detr`` with the config's
frozen stem and stage 1: ResNet-18 C5, d_model 32, 4 heads, 2 + 2 layers,
FFN 64, 8 queries, 3 classes, on a 64 x 96 canvas, batch 2, the second image
48 x 64 inside it (so the key mask drops cells), with randomised FrozenBN,
LayerNorms and class biases. Both sides run in float32 on the CPU, the port
on the JAX variables converted by ``from_jax_variables`` and loaded with
``strict=True``.

Tolerances: the blocks, layers and logits atol = rtol = 1e-4 (float32 sums
in another order), the encoding 1e-5, the boxes (sigmoids) 1e-5, the
decode's indices, labels and validity exactly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from test_torch_model import _randomise_frozen_bn
from torch_detection_tpu import builder as jax_builder
from torch_detection_tpu.models.detectors import DETR as JaxDETR
from torch_detection_tpu.models.detectors import DETRConfig as JaxDETRConfig
from torch_detection_tpu.models.detectors import decode_detr as jax_decode
from torch_detection_tpu.models.detectors.detr import _DecoderLayer, _EncoderLayer
from torch_detection_tpu.models.detectors.detr import (
    sine_position_encoding as jax_sine_position_encoding,
)
from torch_detection_tpu.utils.config import Config as JaxConfig
from torch_detection_tpu_torch import builder
from torch_detection_tpu_torch.engine import make_inference_fn
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.detectors import DETR, DETRConfig, decode_detr
from torch_detection_tpu_torch.models.detectors.detr import (
    DecoderLayer,
    EncoderLayer,
    sine_position_encoding,
)
from torch_detection_tpu_torch.models.layers import MultiHeadDotProductAttention
from torch_detection_tpu_torch.utils.config import Config

CONFIG = Path(__file__).resolve().parent.parent / "configs" / "detr_r50_coco.py"
MODEL = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(3,), frozen_stages=1,
                  norm_cfg=dict(type="FrozenBN")),
    num_classes=3, d_model=32, nhead=4, num_encoder_layers=2, num_decoder_layers=2,
    dim_feedforward=64, num_queries=8,
)
DET = dict(num_classes=3, num_queries=8, max_detections=10)
TOL = dict(atol=1e-4, rtol=1e-4)
F32 = dict(dtype=torch.float32, param_dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as ``test_torch_train.py``: the test workers
    share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def randomise(variables, rng):
    """FrozenBN statistics, every LayerNorm's scale and bias and the class
    biases drawn from ``rng``: flax's inits would leave the conversion of
    each untested."""
    variables = _randomise_frozen_bn(variables, rng)

    def walk(tree):
        for key, value in tree.items():
            if isinstance(value, dict):
                if set(value) == {"scale", "bias"} and "norm" in key:
                    n = value["scale"].shape
                    value["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
                    value["bias"] = rng.normal(0, 0.2, n).astype(np.float32)
                elif key == "class_embed":
                    value["bias"] = rng.normal(0, 0.5, value["bias"].shape).astype(np.float32)
                else:
                    walk(value)

    walk(variables["params"])
    return variables


def batch(rng):
    """Two images on a 64 x 96 canvas, the second 48 x 64 with zeros outside,
    with 3 and 2 gts of 4 slots; labels 1-based."""
    image = rng.normal(size=(2, 64, 96, 3)).astype(np.float32)
    image[1, 48:] = 0.0
    image[1, :, 64:] = 0.0
    gt_boxes = np.array([[[4, 6, 30, 28], [20, 10, 80, 50], [40, 40, 55, 62], [0, 0, 0, 0]],
                         [[2, 2, 20, 30], [30, 8, 60, 40], [0, 0, 0, 0], [0, 0, 0, 0]]],
                        np.float32)
    return dict(
        image=image, gt_boxes=gt_boxes,
        gt_labels=np.array([[1, 3, 2, 0], [2, 2, 0, 0]], np.int32),
        gt_valid=np.array([[True, True, True, False], [True, True, False, False]]),
        img_shape=np.array([[64, 96], [48, 64]], np.float32),
    )


def make_port(variables):
    """The port's tiny DETR in float32 on the CPU on the JAX ``variables``."""
    model = DETR(**MODEL, device="cpu")
    model.load_state_dict(from_jax_variables(variables, model), strict=True)
    return model.to(memory_format=torch.channels_last)


@pytest.fixture(scope="module")
def detr():
    """The reference's tiny DETR on randomised weights, its outputs on the
    padded batch and on the same images without ``img_shapes``."""
    rng = np.random.default_rng(0)
    jax_model = JaxDETR(**MODEL)
    b = batch(rng)
    variables = randomise(jax.jit(jax_model.init)(jax.random.PRNGKey(0),
                                                  jnp.asarray(b["image"])), rng)
    apply = jax.jit(jax_model.apply)
    padded = apply(variables, jnp.asarray(b["image"]), jnp.asarray(b["img_shape"]))
    full = apply(variables, jnp.asarray(b["image"]))
    return dict(variables=variables, batch=b, outputs={
        "padded": tuple(np.asarray(t) for t in padded),
        "canvas": tuple(np.asarray(t) for t in full)})


def _flax_attention_case(name, rng):
    """(inputs of the flax module's call, the port's call's inputs) for one
    way of calling the attention."""
    q = rng.normal(size=(2, 8, 32)).astype(np.float32)
    kv = rng.normal(size=(2, 12, 32)).astype(np.float32)
    v = rng.normal(size=(2, 12, 32)).astype(np.float32)
    key_mask = np.ones((2, 1, 1, 12), bool)
    key_mask[1, ..., 7:] = False
    full_mask = rng.uniform(size=(2, 4, 8, 12)) < 0.7
    full_mask[..., 0] = True  # every query keeps a key
    return {
        "self": ((q, q, q), None, (q,)),
        "cross": ((q, kv, v), None, (q, kv, v)),
        "cross_key_mask": ((q, kv, v), key_mask, (q, kv, v)),
        "cross_full_mask": ((q, kv, v), full_mask, (q, kv, v)),
        "key_defaults_to_query": ((q, q, q), None, (q, None, None)),
    }[name]


@pytest.mark.parametrize("name", ["self", "cross", "cross_key_mask", "cross_full_mask",
                                  "key_defaults_to_query"])
def test_attention_matches_flax(name):
    """``attn(x)`` as Sparse R-CNN calls it, and ``attn(q, k, v, mask)``
    against flax's module with a key mask broadcast over heads and queries
    and a full (B, heads, q, k) mask."""
    rng = np.random.default_rng(1)
    flax_inputs, mask, port_inputs = _flax_attention_case(name, rng)
    flax_mod = fnn.MultiHeadDotProductAttention(num_heads=4, qkv_features=32)
    variables = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.1, v.shape)).astype(np.float32),
        flax_mod.init(jax.random.PRNGKey(1), *flax_inputs))
    port = MultiHeadDotProductAttention(32, 4)
    port.load_state_dict(from_jax_variables(variables, port), strict=True)
    want = flax_mod.apply(variables, *flax_inputs, mask=None if mask is None else jnp.asarray(mask))
    args = [None if a is None else torch.from_numpy(a) for a in port_inputs]
    with torch.no_grad():
        got = port(*args, mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_masked_keys_take_no_weight():
    """A masked key's value does not reach any output, whatever it holds."""
    rng = np.random.default_rng(2)
    attn = MultiHeadDotProductAttention(32, 4)
    q, kv = (torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in ((2, 8, 32),
                                                                              (2, 12, 32)))
    mask = torch.ones((2, 1, 1, 12), dtype=torch.bool)
    mask[..., 9:] = False
    other = kv.clone()
    other[:, 9:] = 1e4
    with torch.no_grad():
        np.testing.assert_array_equal(attn(q, kv, kv, mask).numpy(),
                                      attn(q, other, other, mask).numpy())


@pytest.mark.parametrize("d_model", [32, 256])
def test_sine_encoding_matches_over_padding(d_model):
    """Images padded on the bottom, the right, both and neither."""
    valid = np.zeros((4, 7, 9), np.float32)
    valid[0] = 1.0
    valid[1, :5] = 1.0
    valid[2, :, :4] = 1.0
    valid[3, :3, :6] = 1.0
    want = np.asarray(jax_sine_position_encoding(jnp.asarray(valid), d_model))
    got = sine_position_encoding(torch.from_numpy(valid), d_model).numpy()
    assert got.dtype == np.float32 and got.shape == (4, 7, 9, d_model)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def _layer_case(kind, rng):
    """(flax layer, its inputs, the port layer, the port's inputs)."""
    src = rng.normal(size=(2, 12, 32)).astype(np.float32)
    pos = rng.normal(size=(2, 12, 32)).astype(np.float32)
    tgt = rng.normal(size=(2, 8, 32)).astype(np.float32)
    qpos = rng.normal(size=(2, 8, 32)).astype(np.float32)
    mask = np.ones((2, 1, 1, 12), bool)
    mask[1, ..., 5:] = False
    if kind == "encoder":
        return (_EncoderLayer(32, 4, 64), (src, pos, mask), EncoderLayer(32, 4, 64, **F32),
                (src, pos, mask))
    return (_DecoderLayer(32, 4, 64), (tgt, qpos, src, pos, mask), DecoderLayer(32, 4, 64, **F32),
            (tgt, qpos, src, pos, mask))


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_matches_flax(kind):
    rng = np.random.default_rng(3)
    flax_mod, inputs, port, port_inputs = _layer_case(kind, rng)
    variables = jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + rng.normal(0, 0.1, v.shape)).astype(np.float32),
        flax_mod.init(jax.random.PRNGKey(2), *inputs))
    port.load_state_dict(from_jax_variables(variables, port), strict=True)
    want = flax_mod.apply(variables, *inputs)
    with torch.no_grad():
        got = port(*(torch.from_numpy(a) for a in port_inputs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_state_dict_is_the_flax_tree(detr):
    """Every parameter and statistic converts (``strict=True``): the
    attentions' rank-3 kernels into ``HeadsLinear``s, ``query_embed`` as the
    (Q, d) parameter it is."""
    variables = detr["variables"]
    model = make_port(variables)
    state = from_jax_variables(variables, model)
    assert set(state) == set(model.state_dict())
    params = variables["params"]
    np.testing.assert_array_equal(state["query_embed"].numpy(), params["query_embed"])
    k = np.asarray(params["decoder1"]["cross_attn"]["key"]["kernel"])  # (32, 4, 8)
    np.testing.assert_array_equal(state["decoder1.cross_attn.key.weight"].numpy(),
                                  k.reshape(32, 32).T)
    out = np.asarray(params["encoder0"]["self_attn"]["out"]["kernel"])  # (4, 8, 32)
    np.testing.assert_array_equal(state["encoder0.self_attn.out.weight"].numpy(),
                                  out.reshape(32, 32).T)
    np.testing.assert_array_equal(state["input_proj.weight"].numpy(),
                                  np.asarray(params["input_proj"]["kernel"]).T)
    assert model.query_embed.dtype == torch.float32


@pytest.mark.parametrize("shapes", ["padded", "canvas"])
def test_forward_matches(detr, shapes):
    """Every decoder layer's logits and boxes, with the key mask of the
    padded image and with every cell valid (no ``img_shapes``)."""
    model = make_port(detr["variables"]).eval()
    b = detr["batch"]
    img_shape = torch.from_numpy(b["img_shape"]) if shapes == "padded" else None
    with torch.no_grad():
        cls, box = model(torch.from_numpy(b["image"]), img_shape)
    want_cls, want_box = detr["outputs"][shapes]
    assert cls.shape == (2, 2, 8, 4) and box.shape == (2, 2, 8, 4)
    assert cls.dtype == box.dtype == torch.float32
    np.testing.assert_allclose(cls.numpy(), want_cls, **TOL)
    np.testing.assert_allclose(box.numpy(), want_box, atol=1e-5, rtol=1e-5)


def test_padding_changes_the_padded_image_only(detr):
    """The batch exercises the key mask that ``test_forward_matches`` holds
    the port to: with ``img_shapes`` the padded second image's outputs move,
    the full first image's do not."""
    pad, full = detr["outputs"]["padded"], detr["outputs"]["canvas"]
    np.testing.assert_array_equal(pad[0][:, 0], full[0][:, 0])
    assert np.abs(pad[0][:, 1] - full[0][:, 1]).max() > 1e-3


@pytest.mark.parametrize("case", ["factors_b", "factors_b4", "no_shapes"])
def test_decode_matches(detr, case):
    """Both decoders on the reference's outputs, with ties among the last
    layer's logits (the top-k gives them to the lower index); (B,) and
    (B, 4) scale factors, and no ``img_shapes`` (boxes left normalised)."""
    cls, box = (t.copy() for t in detr["outputs"]["padded"])
    cls[-1, 0, 5] = cls[-1, 0, 2]  # query 5 ties query 2 on every class
    shapes = detr["batch"]["img_shape"]
    factors = {"factors_b": np.array([1.0, 2.0], np.float32),
               "factors_b4": np.array([[1.0, 2.0, 1.0, 2.0], [0.5, 0.5, 0.25, 0.25]], np.float32),
               "no_shapes": None}[case]
    if case == "no_shapes":
        shapes = None
    cfg = DETRConfig(**DET)
    want = jax_decode(JaxDETRConfig(**DET), jnp.asarray(cls), jnp.asarray(box),
                      None if shapes is None else jnp.asarray(shapes),
                      None if factors is None else jnp.asarray(factors))
    got = decode_detr(cfg, torch.from_numpy(cls), torch.from_numpy(box),
                      None if shapes is None else torch.from_numpy(shapes),
                      None if factors is None else torch.from_numpy(factors))
    for field in ("labels", "valid", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-6)
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-4, rtol=1e-6)
    assert got.boxes.shape == (2, DET["max_detections"], 4)


def test_inference_fn_is_forward_and_decode(detr):
    """``make_inference_fn`` on a DETR config: the forward on ``img_shape``'s
    key mask and the decode, as the reference's ``infer``."""
    model = make_port(detr["variables"]).eval()
    b = detr["batch"]
    infer = make_inference_fn(model, DETRConfig(**DET))
    got = infer(torch.from_numpy(b["image"]), torch.from_numpy(b["img_shape"]),
                torch.tensor([1.0, 2.0]))
    cls, box = detr["outputs"]["padded"]
    want = jax_decode(JaxDETRConfig(**DET), jnp.asarray(cls), jnp.asarray(box),
                      jnp.asarray(b["img_shape"]), jnp.asarray([1.0, 2.0]))
    for field in ("labels", "valid", "indices"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), atol=1e-3)


def test_detection_cfg_matches_reference():
    cfg = builder.build_detection_cfg(Config.fromfile(CONFIG).detection)
    want = jax_builder.build_detection_cfg(JaxConfig.fromfile(CONFIG).detection)
    assert type(cfg) is DETRConfig
    for field in ("num_classes", "num_queries", "cls_weight", "bbox_weight", "giou_weight",
                  "eos_coef", "aux_loss", "score_thr", "max_detections"):
        assert getattr(cfg, field) == getattr(want, field), field


def test_full_width_detr_answers_on_cpu():
    """The config's detector at full width (R50 C5, d_model 256, 8 heads,
    6 + 6 layers, FFN 2048, 100 queries, 80 classes): the JAX model's
    parameter count (by ``jax.eval_shape`` of its init), float32 where the
    reference computes in float32 in the bf16 serving build, and an answer
    through ``make_inference_fn`` on a padded image."""
    cfg = Config.fromfile(CONFIG)
    jax_model = jax_builder.build_detector(JaxConfig.fromfile(CONFIG).model, "bfloat16")
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0),
                                                   jnp.zeros((1, 64, 64, 3))))["params"]
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(shapes))
    model = builder.build_detector(cfg.model, "bfloat16", device="cpu", seed=0)
    assert sum(p.numel() for p in model.parameters()) == want == 41_575_061
    float32 = {n for n, p in model.named_parameters() if p.dtype == torch.float32}
    assert {"query_embed", "class_embed.weight", "bbox_out.bias", "decoder_norm.scale",
            "encoder5.norm2.bias"} <= float32
    assert model.decoder3.cross_attn.value.weight.dtype == model.input_proj.weight.dtype \
        == torch.bfloat16
    assert float(model.query_embed.detach().std()) == pytest.approx(1.0, rel=0.05)
    assert not torch.equal(model.encoder0.ffn.fc1.weight, model.encoder1.ffn.fc1.weight)
    infer = make_inference_fn(model, builder.build_detection_cfg(cfg.detection))
    image = torch.randn((1, 96, 128, 3), generator=torch.Generator().manual_seed(0))
    res = infer(image, torch.tensor([[64.0, 96.0]]), torch.tensor([2.0]))
    assert res.boxes.shape == (1, 100, 4) and bool(res.valid.all())
    assert torch.isfinite(res.boxes).all() and float(res.boxes.max()) <= 95.0 / 2.0
    assert int(res.indices.max()) < 100 and int(res.labels.max()) < 80
