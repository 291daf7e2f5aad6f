"""The port's torch importer against the JAX package's, on the CPU in float32.

Seeded torch models with torchvision's and mmdetection's key names (the
``torch_refs`` ResNets, RetinaNet and Faster R-CNN, and a mask head defined
here) with randomised BatchNorm statistics are imported both ways: the
port's ``load_torch_weights`` into the port model, and the reference's into
a flax tree, which ``from_jax_variables`` then carries into the port. The
two state dicts must be equal tensor for tensor, except the mask head's
transposed conv, which the reference leaves mirrored (R6). The port model
on the imported weights must give the torch model's outputs to 1e-5.
"""

import logging
import os

import jax
import numpy as np
import pytest
import torch
from torch import nn

import torch_refs
from test_torch_detr import MODEL as DETR_MODEL
from torch_detection_tpu.engine import load_checkpoint as jax_load_checkpoint
from torch_detection_tpu.models.backbones import ResNet as JaxResNet
from torch_detection_tpu.models.detectors import SingleStageDetector as JaxSingleStageDetector
from torch_detection_tpu.models.detectors import TwoStageDetector as JaxTwoStageDetector
from torch_detection_tpu.models.heads.mask_head import FCNMaskHead as JaxFCNMaskHead
from torch_detection_tpu.models import torch_import as jax_import
from torch_detection_tpu_torch.engine import checkpoint
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models import torch_import
from torch_detection_tpu_torch.models.backbones import ResNet
from torch_detection_tpu_torch.models.detectors import DETR, SingleStageDetector, TwoStageDetector
from torch_detection_tpu_torch.models.heads import FCNMaskHead

NUM_CLASSES = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _zeros_like_init(jax_model, *args, **kwargs):
    """A flax variable tree of zeros with the model's shapes, from its
    abstract init (nothing is compiled)."""
    shapes = jax.eval_shape(lambda: jax_model.init(jax.random.PRNGKey(0), *args, **kwargs))
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)


def _numpy_state(state_dict):
    return {k: v.detach().numpy() for k, v in state_dict.items()}


def _both_imports(port_model, variables, state_dict, port_rules, jax_rules):
    """The port's import, and the reference's carried into the port."""
    port_model.load_state_dict({k: torch.zeros_like(v) for k, v in port_model.state_dict().items()})
    loaded = torch_import.load_torch_weights(port_model, state_dict, port_rules)
    got = {k: v.clone() for k, v in port_model.state_dict().items()}
    ref = jax_import.load_torch_weights(variables, _numpy_state(state_dict), jax_rules)
    want = from_jax_variables(ref, port_model)
    assert sorted(got) == sorted(want)
    return got, want, loaded


def _assert_equal_states(got, want, flipped=()):
    for k in got:
        w = torch.flip(want[k], (2, 3)) if k in flipped else want[k]
        assert got[k].dtype == torch.float32 and torch.equal(got[k], w), k


def _nchw(x):
    return torch.from_numpy(x.transpose(0, 3, 1, 2))


def _close(got, want, name):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), atol=1e-5, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("depth,stages", [(18, 4), (50, 2)], ids=["resnet18", "resnet50_2_stages"])
def test_resnet_import_equals_the_reference_and_torch(depth, stages):
    torch.manual_seed(depth)
    tmodel = torch_refs.torch_resnet18() if depth == 18 else torch_refs.torch_resnet50()
    torch_refs.randomize_bn_stats(tmodel, seed=depth)
    tmodel.eval()
    state = tmodel.state_dict()
    x = np.random.default_rng(depth).normal(size=(1, 64, 96, 3)).astype(np.float32)
    outs = tuple(range(stages))
    net = ResNet(depth=depth, num_stages=stages, out_indices=outs, device="cpu")
    variables = _zeros_like_init(JaxResNet(depth=depth, num_stages=stages, out_indices=outs), x)
    got, want, loaded = _both_imports(net, variables, state, torch_import.RESNET_KEY_RULES,
                                      jax_import.RESNET_KEY_RULES)
    _assert_equal_states(got, want)
    assert sorted(loaded) == sorted(net.state_dict())  # every tensor of the port's
    with torch.no_grad():
        got_feats = net(torch.from_numpy(x))
        want_feats = tmodel(_nchw(x))[:stages]
    for i, (g, w) in enumerate(zip(got_feats, want_feats)):
        _close(g.permute(0, 3, 1, 2), w, f"c{i + 2}")


@pytest.fixture(scope="module")
def retina():
    torch.manual_seed(0)
    tmodel = torch_refs.TorchRetinaNet(depth=18, feat_channels=16, num_classes=NUM_CLASSES,
                                       stacked_convs=2, num_anchors=9)
    torch_refs.randomize_bn_stats(tmodel)
    tmodel.eval()
    cfg = dict(
        backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(1, 2, 3)),
        neck=dict(type="FPN", in_channels=(128, 256, 512), out_channels=16, num_outs=5,
                  add_extra_convs=True, extra_convs_on_inputs=True, relu_before_extra_convs=True),
        head=dict(type="RetinaHead", num_classes=NUM_CLASSES, in_channels=16, feat_channels=16,
                  stacked_convs=2, num_base_anchors=9),
    )
    return tmodel, cfg


def test_retinanet_import_equals_the_reference_and_torch(retina):
    tmodel, cfg = retina
    x = np.random.default_rng(1).normal(size=(1, 64, 96, 3)).astype(np.float32)
    model = SingleStageDetector(**cfg, device="cpu")
    variables = _zeros_like_init(JaxSingleStageDetector(**cfg), x)
    got, want, loaded = _both_imports(model, variables, tmodel.state_dict(),
                                      torch_import.retinanet_key_rules(num_laterals=3),
                                      jax_import.retinanet_key_rules(num_laterals=3))
    _assert_equal_states(got, want)
    assert sorted(loaded) == sorted(model.state_dict())
    with torch.no_grad():
        cls, reg = model(torch.from_numpy(x))
        cls_t, reg_t = tmodel(_nchw(x))
    for lvl in range(5):
        _close(cls[lvl].permute(0, 3, 1, 2), cls_t[lvl], f"cls {lvl}")
        _close(reg[lvl].permute(0, 3, 1, 2), reg_t[lvl], f"reg {lvl}")


FASTER_CFG = dict(
    backbone=dict(type="ResNet", depth=18, num_stages=4, out_indices=(0, 1, 2, 3)),
    neck=dict(type="FPN", in_channels=(64, 128, 256, 512), out_channels=16, num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=16, feat_channels=16, num_base_anchors=3),
    bbox_head=dict(type="BBoxHead", num_classes=NUM_CLASSES, fc_channels=32,
                   reg_class_agnostic=True),
)


def test_faster_rcnn_import_equals_the_reference_and_torch():
    torch.manual_seed(3)
    tmodel = torch_refs.TorchFasterRCNN(depth=18, feat_channels=16, num_classes=NUM_CLASSES,
                                        roi_size=7, fc_channels=32, class_agnostic=True)
    torch_refs.randomize_bn_stats(tmodel, seed=3)
    tmodel.eval()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 64, 96, 3)).astype(np.float32)
    roi = rng.normal(size=(1, 5, 7, 7, 16)).astype(np.float32)
    jmodel = JaxTwoStageDetector(**FASTER_CFG)
    variables = _zeros_like_init(jmodel, x)
    roi_vars = _zeros_like_init(jmodel, roi, method=JaxTwoStageDetector.roi_forward)
    variables = {"params": {**variables["params"], **roi_vars["params"]},
                 "batch_stats": variables["batch_stats"]}
    model = TwoStageDetector(**FASTER_CFG, device="cpu")
    got, want, loaded = _both_imports(model, variables, tmodel.state_dict(),
                                      torch_import.faster_rcnn_key_rules(num_laterals=4),
                                      jax_import.faster_rcnn_key_rules(num_laterals=4))
    _assert_equal_states(got, want)
    assert sorted(loaded) == sorted(model.state_dict())
    with torch.no_grad():
        feats, scores, deltas = model(torch.from_numpy(x))
        feats_t, (scores_t, deltas_t) = tmodel.forward_rpn(_nchw(x))
        for lvl in range(5):
            _close(feats[lvl].permute(0, 3, 1, 2), feats_t[lvl], f"fpn {lvl}")
            _close(scores[lvl].permute(0, 3, 1, 2), scores_t[lvl], f"rpn cls {lvl}")
            _close(deltas[lvl].permute(0, 3, 1, 2), deltas_t[lvl], f"rpn reg {lvl}")
        cls, reg = model.bbox_head(torch.from_numpy(roi))
        # torch flattens each roi's (C, S, S) features
        cls_t, reg_t = tmodel.bbox_head(torch.from_numpy(roi[0].transpose(0, 3, 1, 2)).reshape(5, -1))
    _close(cls[0], cls_t, "fc_cls")
    _close(reg[0], reg_t, "fc_reg")


class _TorchMaskHead(nn.Module):
    """mmdetection's FCNMaskHead naming: ``convs.{i}.conv``, ``upsample``
    (a ``ConvTranspose2d``), ``conv_logits``."""

    def __init__(self, in_channels, conv_channels, num_convs, num_classes):
        super().__init__()
        self.convs = nn.ModuleList(
            [torch_refs.TorchConvModule(in_channels if i == 0 else conv_channels, conv_channels, 3,
                                        padding=1) for i in range(num_convs)])
        self.upsample = nn.ConvTranspose2d(conv_channels, conv_channels, 2, stride=2)
        self.conv_logits = nn.Conv2d(conv_channels, num_classes, 1)

    def forward(self, x):
        for conv in self.convs:
            x = conv(x)
        return self.conv_logits(torch.relu(self.upsample(x)))


class _PortMaskRCNNHeads(nn.Module):
    def __init__(self):
        super().__init__()
        self.mask_head = FCNMaskHead(num_classes=NUM_CLASSES, in_channels=16, conv_channels=8,
                                     num_convs=2, device="cpu")


def test_mask_head_import_equals_torch_and_the_reference_up_to_r6():
    torch.manual_seed(5)
    thead = _TorchMaskHead(16, 8, 2, NUM_CLASSES).eval()
    with torch.no_grad():
        thead.upsample.bias.normal_()
    state = {f"mask_head.{k}": v for k, v in thead.state_dict().items()}
    roi = np.random.default_rng(5).normal(size=(1, 3, 7, 7, 16)).astype(np.float32)
    heads = _PortMaskRCNNHeads()
    variables = {"params": {"mask_head": _zeros_like_init(
        JaxFCNMaskHead(num_classes=NUM_CLASSES, in_channels=16, conv_channels=8, num_convs=2),
        roi)["params"]}}
    got, want, loaded = _both_imports(heads, variables, state,
                                      torch_import.faster_rcnn_key_rules(),
                                      jax_import.faster_rcnn_key_rules())
    # R6: the reference leaves the transposed conv mirrored in flax; carried
    # into the port, it comes back flipped in space against torch's
    _assert_equal_states(got, want, flipped=("mask_head.upsample.weight",))
    assert not torch.equal(got["mask_head.upsample.weight"], want["mask_head.upsample.weight"])
    assert sorted(loaded) == sorted(heads.state_dict())
    with torch.no_grad():
        logits = heads.mask_head(torch.from_numpy(roi))[0]
        logits_t = thead(torch.from_numpy(roi[0].transpose(0, 3, 1, 2)))
    _close(logits.permute(0, 3, 1, 2), logits_t, "mask logits")


def test_fc1_takes_torch_channel_major_features():
    """fc1's input axis from (C, S, S) to (S, S, C) at S = 7."""
    fc = torch.arange(2 * 3 * 7 * 7, dtype=torch.float32).reshape(2, 3 * 49)
    model = TwoStageDetector(**dict(FASTER_CFG, bbox_head=dict(FASTER_CFG["bbox_head"],
                                                               in_channels=3, fc_channels=2)),
                             device="cpu")
    torch_import.load_torch_weights(model, {"bbox_head.shared_fcs.0.weight": fc},
                                    torch_import.faster_rcnn_key_rules())
    got = model.bbox_head.fc1.weight.reshape(2, 7, 7, 3)
    assert torch.equal(got, fc.reshape(2, 3, 7, 7).permute(0, 2, 3, 1))
    with pytest.raises(ValueError, match="C x 7 x 7"):
        torch_import.load_torch_weights(model, {"bbox_head.shared_fcs.0.weight": fc[:, :-1]},
                                        torch_import.faster_rcnn_key_rules())


def _tiny_resnet_state(seed=0):
    """A torchvision-named ResNet-18 state dict with its classifier."""
    torch.manual_seed(seed)
    state = torch_refs.torch_resnet18().state_dict()
    return dict(state, **{"fc.weight": torch.randn(10, 512), "fc.bias": torch.randn(10)})


def test_prefix_envelope_dropped_keys_and_strict(tmp_path, caplog):
    state = _tiny_resnet_state()
    assert "fc.weight" in state and "bn1.num_batches_tracked" in state
    wrapped = {"module." + k: v for k, v in state.items()}
    assert torch_import.strip_prefix(wrapped).keys() == state.keys()
    assert torch_import.strip_prefix({"module.a": 1, "b": 2}).keys() == {"module.a", "b"}
    torch.save({"state_dict": wrapped, "meta": {}}, str(tmp_path / "w.pth"))
    loaded_state = torch_import.load_torch_checkpoint(str(tmp_path / "w.pth"))
    assert loaded_state.keys() == wrapped.keys()

    net = ResNet(depth=18, num_stages=4, out_indices=(0, 1, 2, 3), device="cpu")
    converted, unexpected = torch_import.convert_state_dict(net, loaded_state)
    assert not unexpected and not any("fc" in k or "num_batches" in k for k in converted)
    assert converted["stem.norm.mean"] is not None and torch.equal(
        converted["stem.norm.scale"], state["bn1.weight"])
    loaded = torch_import.load_torch_weights(net, loaded_state, strict=True)
    assert sorted(loaded) == sorted(net.state_dict())

    state["extra.weight"] = torch.ones(1)
    del state["conv1.weight"]
    with pytest.raises(RuntimeError, match=r"missing keys .*stem\.conv\.weight.*unexpected torch "
                                           r"keys .*extra\.weight"):
        torch_import.load_torch_weights(net, state, strict=True)
    state["layer1.0.conv1.weight"] = torch.ones(1, 1, 1, 1)
    with caplog.at_level(logging.WARNING):
        torch_import.load_torch_weights(net, state)
    assert "layer1_0.block1.conv.weight (64, 64, 3, 3) vs torch (1, 1, 1, 1)" in caplog.text
    assert not torch.equal(net.layer1_0.block1.conv.weight, torch.ones(1, 1, 1, 1))


def test_resolve_checkpoint_source(tmp_path):
    src = tmp_path / "src" / "w.pth"
    src.parent.mkdir()
    torch.save(_tiny_resnet_state(), str(src))
    cache = str(tmp_path / "cache")
    got = checkpoint.resolve_checkpoint_source("file://" + str(src), cache_dir=cache)
    assert got == "torch://" + os.path.join(cache, "w.pth") and os.path.exists(got[8:])
    os.remove(src)  # reused from the cache from now on
    assert checkpoint.resolve_checkpoint_source("file://" + str(src), cache_dir=cache) == got
    # a modelzoo alias whose file is already in the cache needs no fetch
    torch.save(_tiny_resnet_state(1), os.path.join(cache, "resnet18-5c106cde.pth"))
    zoo = checkpoint.resolve_checkpoint_source("modelzoo://resnet18", cache_dir=cache)
    assert zoo == "torch://" + os.path.join(cache, "resnet18-5c106cde.pth")
    net = ResNet(depth=18, num_stages=4, out_indices=(0, 1, 2, 3), device="cpu")
    meta = checkpoint.load_checkpoint(net, "modelzoo://resnet18", cache_dir=cache)
    assert meta["source"] == zoo and sorted(meta["loaded"]) == sorted(net.state_dict())
    assert torch.equal(net.stem.conv.weight, _tiny_resnet_state(1)["conv1.weight"])
    for passthrough in ("torch://a.pth", "work_dirs/epoch_1"):
        assert checkpoint.resolve_checkpoint_source(passthrough, cache_dir=cache) == passthrough
    with pytest.raises(KeyError, match="unknown modelzoo alias 'resnet51'"):
        checkpoint.resolve_checkpoint_source("modelzoo://resnet51", cache_dir=cache)


def test_detector_weights_take_a_backbone_or_a_whole_detector(tmp_path, retina):
    """``load_checkpoint``'s ``torch://`` on a detector: a backbone's state
    dict loads every backbone tensor under ``backbone.``, a whole
    detector's loads every tensor through RetinaNet's table, the FPN's
    lateral count read from the model's own neck."""
    tmodel, cfg = retina
    model = SingleStageDetector(**cfg, device="cpu")
    backbone_pth = str(tmp_path / "r18.pth")
    torch.save({"state_dict": tmodel.backbone.state_dict()}, backbone_pth)
    meta = checkpoint.load_checkpoint(model, "torch://" + backbone_pth, strict=False)
    assert sorted(meta["loaded"]) == sorted(k for k in model.state_dict() if k.startswith("backbone."))
    detector_pth = str(tmp_path / "retina.pth")
    torch.save(tmodel.state_dict(), detector_pth)
    meta = checkpoint.load_checkpoint(model, "torch://" + detector_pth, strict=True)
    assert sorted(meta["loaded"]) == sorted(model.state_dict())
    assert torch.equal(model.head.cls_out.weight, tmodel.bbox_head.retina_cls.weight)


def test_detector_key_rules_follow_the_model():
    """A ResNet takes torchvision names at the top level; a detector
    without an FPN (DETR) takes a whole detector's backbone and reports
    the rest; a two-stage detector's FPN table starts at its neck's
    ``start_level`` and names as many laterals as the neck has."""
    resnet = ResNet(depth=18, num_stages=4, out_indices=(3,), device="cpu")
    assert torch_import.detector_key_rules(resnet, {"conv1.weight": None}) == list(
        torch_import.RESNET_KEY_RULES)
    detr = DETR(**DETR_MODEL, device="cpu")
    rules = torch_import.detector_key_rules(detr, {"backbone.conv1.weight": None})
    converted, unexpected = torch_import.convert_state_dict(
        detr, {"backbone.conv1.weight": detr.backbone.stem.conv.weight,
               "transformer.decoder.norm.weight": torch.ones(32)}, rules)
    assert list(converted) == ["backbone.stem.conv.weight"]
    assert unexpected == ["transformer.decoder.norm.weight"]
    neck = dict(FASTER_CFG["neck"], start_level=1, add_extra_convs=True)
    model = TwoStageDetector(**dict(FASTER_CFG, neck=neck), device="cpu")
    rules = torch_import.detector_key_rules(model, {"backbone.conv1.weight": None})
    converted, unexpected = torch_import.convert_state_dict(
        model, {"neck.lateral_convs.0.conv.weight": torch.zeros(1),
                "neck.fpn_convs.2.conv.bias": torch.zeros(1),
                "neck.fpn_convs.3.conv.bias": torch.zeros(1)}, rules)
    assert sorted(converted) == ["neck.extra0.conv.bias", "neck.fpn2.conv.bias",
                                 "neck.lateral1.conv.weight"]


def test_reference_pretrained_backbone_loads_nothing_pin_r9(tmp_path, retina, caplog):
    """R9: the reference's ``tools/train.py`` loads ``--pretrained`` with
    ``load_checkpoint(variables, pretrained, strict=False)`` and its default
    rules, which map a torchvision ResNet's ``conv1.weight`` to a top-level
    ``stem/conv``; a detector keeps its backbone under ``backbone/``, so
    every key comes back missing, the warning is all, and the detector
    keeps its random init. The port anchors a backbone-only state dict
    under ``backbone.`` and loads every backbone tensor."""
    tmodel, cfg = retina
    pth = str(tmp_path / "r18.pth")
    torch.save(tmodel.backbone.state_dict(), pth)
    x = np.zeros((1, 64, 96, 3), np.float32)
    jmodel = JaxSingleStageDetector(**cfg)
    variables = _zeros_like_init(jmodel, x)
    stem = variables["params"]["backbone"]["stem"]["conv"]
    stem["kernel"] = np.random.default_rng(9).normal(size=stem["kernel"].shape).astype(np.float32)
    before = stem["kernel"].copy()
    with caplog.at_level(logging.WARNING):
        after, _ = jax_load_checkpoint(variables, "torch://" + pth, strict=False)
    assert np.array_equal(np.asarray(after["params"]["backbone"]["stem"]["conv"]["kernel"]), before)
    assert "missing keys" in caplog.text and "params:backbone/stem/conv/kernel" in caplog.text
    model = SingleStageDetector(**cfg, device="cpu")
    checkpoint.load_checkpoint(model, "torch://" + pth)
    assert torch.equal(model.backbone.stem.conv.weight, tmodel.backbone.conv1.weight)
