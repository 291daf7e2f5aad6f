"""Import torchvision and mmdetection state dicts into the port's models.

Counterpart of ``torch_detection_tpu/models/torch_import.py``. Each family
has a table of key rules, (torch-key regex, port module path template[,
transform]), applied in order, the first match winning; a template of None
drops the key. The port's modules mirror the reference's flax paths, so a
template names the module and the torch leaf maps onto the module's own
tensor:

* conv, transposed-conv and linear ``weight``/``bias`` are copied as they
  are: torch's layouts are the port's. A ``ConvTranspose2d`` weight is not
  mirrored, so the port computes what torch computes (the reference's
  importer leaves a transposed conv mirrored in flax, R6);
* BatchNorm ``weight``/``bias``/``running_mean``/``running_var`` go to
  FrozenBN's ``scale``/``bias``/``mean``/``var``; ``num_batches_tracked`` and
  the classifiers (ResNet's ``fc.*``, VGG's ``classifier.*``) are dropped;
  SSD's ``l2_norm.scale`` stays L2Norm's ``scale``;
* fc1 after RoIAlign takes (C, S, S)-flattened features in torch and
  (S, S, C) in the port (``heads/bbox_head.py``), so its input axis is
  permuted, S taken from the port head's ``roi_size``.

Missing, unexpected and mis-shaped keys are reported by name, logged, or
raised under ``strict``. The MobileNetV2 table waits for its backbone.
"""

from __future__ import annotations

import logging
import re
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from .backbones.ssd_vgg import SSDVGG
from .backbones.vgg import ARCH_SETTINGS as VGG_ARCH_SETTINGS
from .backbones.vgg import VGG
from .detectors.two_stage import TwoStageDetector
from .layers import FrozenBatchNorm
from .necks.fpn import FPN

logger = logging.getLogger(__name__)

Rule = Tuple  # (pattern, template or callable or None[, transform])

# torchvision ResNet naming (the reference's resnet.py contract) -> the port's
RESNET_KEY_RULES: Sequence[Rule] = (
    (r"^conv1\.(.*)$", r"stem.conv.\1"),
    (r"^bn1\.(.*)$", r"stem.norm.\1"),
    (r"^layer(\d+)\.(\d+)\.conv(\d+)\.(.*)$", r"layer\1_\2.block\3.conv.\4"),
    (r"^layer(\d+)\.(\d+)\.bn(\d+)\.(.*)$", r"layer\1_\2.block\3.norm.\4"),
    (r"^layer(\d+)\.(\d+)\.downsample\.0\.(.*)$", r"layer\1_\2.downsample.conv.\3"),
    (r"^layer(\d+)\.(\d+)\.downsample\.1\.(.*)$", r"layer\1_\2.downsample.norm.\3"),
    (r"^layer(\d+)\.(\d+)\.se(?:_module)?\.fc1\.(.*)$", r"layer\1_\2.se.fc1.\3"),
    (r"^layer(\d+)\.(\d+)\.se(?:_module)?\.fc2\.(.*)$", r"layer\1_\2.se.fc2.\3"),
    (r"^fc\.", None),  # the classifier: not part of a detection backbone
)


def vgg_key_rules(depth: int, with_norm: bool = False) -> List[Rule]:
    """torchvision VGG naming (one ``features`` Sequential of conv, norm,
    ReLU and pool layers) -> the port's ``layer{s}_{j}.conv`` (and
    ``.norm``): the flat indices rebuilt from the depth's stage layout; the
    ``classifier.*`` is dropped. SSDVGG's 13 trunk convs take VGG16's."""
    rules: List[Rule] = []
    idx = 0
    for s, blocks in enumerate(VGG_ARCH_SETTINGS[depth]):
        for j in range(blocks):
            rules.append((rf"^features\.{idx}\.(.*)$", rf"layer{s + 1}_{j}.conv.\1"))
            idx += 1
            if with_norm:
                rules.append((rf"^features\.{idx}\.(.*)$", rf"layer{s + 1}_{j}.norm.\1"))
                idx += 1
            idx += 1  # the ReLU
        idx += 1  # the pool
    rules.append((r"^classifier\.", None))
    return rules


def ssd_vgg_key_rules() -> List[Rule]:
    """SSDVGG trunks named as the port's (``layer{s}_{j}``, ``conv6`` to
    ``conv12_2``, each a ConvModule, and ``l2_norm``): the naming of
    ``tests/torch_refs.TorchSSDVGG`` and of an SSD checkpoint converted to
    it. ``l2_norm.scale`` stays L2Norm's ``scale``."""
    return [
        (r"^(layer\d+_\d+)\.conv\.(.*)$", r"\1.conv.\2"),
        (r"^(conv\d+(?:_\d+)?)\.conv\.(.*)$", r"\1.conv.\2"),
        (r"^l2_norm\.scale$", r"l2_norm.scale"),
    ]


def _fc_after_roi(value: torch.Tensor, head: nn.Module) -> torch.Tensor:
    """A torch fc weight on (C, S, S)-flattened RoI features -> the port's
    (S, S, C) order, S the port head's ``roi_size``."""
    s = int(head.roi_size)
    out_f, in_f = value.shape
    c = in_f // (s * s)
    if c * s * s != in_f:
        raise ValueError(f"fc1 takes {in_f} features, not C x {s} x {s}")
    return value.reshape(out_f, c, s, s).permute(0, 2, 3, 1).reshape(out_f, in_f)


def prefixed_rules(rules: Sequence[Rule], torch_prefix: str, port_prefix: str) -> List[Rule]:
    """Re-anchor a rule table under a torch key prefix and a port path
    prefix (a backbone's rules inside a whole detector's state dict)."""
    out = []
    for pattern, repl, *transform in rules:
        assert pattern.startswith("^")
        new_pat = "^" + re.escape(torch_prefix) + pattern[1:]
        if repl is None:
            out.append((new_pat, None))
        elif callable(repl):
            out.append((new_pat, lambda m, r=repl: port_prefix + r(m), *transform))
        else:
            out.append((new_pat, port_prefix + repl, *transform))
    return out


def fpn_key_rules(num_laterals: int, start_level: int = 0, torch_prefix: str = "neck.",
                  port_prefix: str = "neck.") -> List[Rule]:
    """mmdetection FPN naming -> the port's: ``lateral_convs.{i}.conv`` ->
    ``lateral{start_level + i}``; ``fpn_convs.{j}.conv`` -> ``fpn{j}`` for
    j < num_laterals, else ``extra{j - num_laterals}``."""
    p = re.escape(torch_prefix)

    def _lateral(m):
        return f"{port_prefix}lateral{start_level + int(m.group(1))}.{_norm(m.group(2))}.{m.group(3)}"

    def _fpn(m):
        j = int(m.group(1))
        name = f"fpn{j}" if j < num_laterals else f"extra{j - num_laterals}"
        return f"{port_prefix}{name}.{_norm(m.group(2))}.{m.group(3)}"

    return [
        (rf"^{p}lateral_convs\.(\d+)\.(conv|bn|norm|gn)\.(.*)$", _lateral),
        (rf"^{p}fpn_convs\.(\d+)\.(conv|bn|norm|gn)\.(.*)$", _fpn),
    ]


def _norm(name: str) -> str:
    return "conv" if name == "conv" else "norm"


def retinanet_key_rules(num_laterals: int = 3, start_level: int = 0) -> List[Rule]:
    """Whole-detector rules for mmdetection RetinaNet state dicts:
    ``backbone.*`` (torchvision ResNet naming), ``neck.*`` (FPN), the
    ``bbox_head`` towers and ``retina_cls``/``retina_reg``."""
    rules = prefixed_rules(RESNET_KEY_RULES, "backbone.", "backbone.")
    rules += fpn_key_rules(num_laterals, start_level)
    rules += [
        (r"^bbox_head\.cls_convs\.(\d+)\.conv\.(.*)$", r"head.cls_conv\1.conv.\2"),
        (r"^bbox_head\.reg_convs\.(\d+)\.conv\.(.*)$", r"head.reg_conv\1.conv.\2"),
        (r"^bbox_head\.cls_convs\.(\d+)\.(?:bn|norm|gn)\.(.*)$", r"head.cls_conv\1.norm.\2"),
        (r"^bbox_head\.reg_convs\.(\d+)\.(?:bn|norm|gn)\.(.*)$", r"head.reg_conv\1.norm.\2"),
        (r"^bbox_head\.retina_cls\.(.*)$", r"head.cls_out.\1"),
        (r"^bbox_head\.retina_reg\.(.*)$", r"head.reg_out.\1"),
    ]
    return rules


def faster_rcnn_key_rules(num_laterals: int = 4, start_level: int = 0) -> List[Rule]:
    """Whole-detector rules for mmdetection Faster and Mask R-CNN state
    dicts: ``rpn_head.rpn_{conv,cls,reg}``, the shared-2fc ``bbox_head``
    (fc1's input permuted) with ``fc_cls``/``fc_reg``, and the mask head's
    ``convs.{i}.conv``, ``upsample`` and ``conv_logits``."""
    rules = prefixed_rules(RESNET_KEY_RULES, "backbone.", "backbone.")
    rules += fpn_key_rules(num_laterals, start_level)
    rules += [
        (r"^rpn_head\.rpn_conv\.(.*)$", r"rpn.rpn_conv.\1"),
        (r"^rpn_head\.rpn_cls\.(.*)$", r"rpn.rpn_cls.\1"),
        (r"^rpn_head\.rpn_reg\.(.*)$", r"rpn.rpn_reg.\1"),
        (r"^bbox_head\.shared_fcs\.0\.(.*)$", r"bbox_head.fc1.\1", _fc_after_roi),
        (r"^bbox_head\.shared_fcs\.1\.(.*)$", r"bbox_head.fc2.\1"),
        (r"^bbox_head\.fc_cls\.(.*)$", r"bbox_head.cls.\1"),
        (r"^bbox_head\.fc_reg\.(.*)$", r"bbox_head.reg.\1"),
        (r"^mask_head\.convs\.(\d+)\.conv\.(.*)$", r"mask_head.conv\1.\2"),
        (r"^mask_head\.upsample\.(.*)$", r"mask_head.upsample.\1"),
        (r"^mask_head\.conv_logits\.(.*)$", r"mask_head.logits.\1"),
    ]
    return rules


def strip_prefix(state_dict: Mapping[str, torch.Tensor], prefix: str = "module.") -> Dict[str, torch.Tensor]:
    """Drop a (Distributed)DataParallel prefix if every key carries it."""
    keys = list(state_dict)
    if keys and all(k.startswith(prefix) for k in keys):
        return {k[len(prefix):]: v for k, v in state_dict.items()}
    return dict(state_dict)


_NORM_LEAVES = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}
_PARAM_LEAVES = {"weight": "weight", "bias": "bias"}


def _port_leaf(module: Optional[nn.Module], leaf: str, path: str) -> Optional[str]:
    """The port tensor a torch leaf loads into, None to drop it."""
    if leaf == "num_batches_tracked":
        return None
    if isinstance(module, FrozenBatchNorm):
        table = _NORM_LEAVES
    elif isinstance(module, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
        table = _PARAM_LEAVES
    else:
        return leaf  # a module's own tensor (L2Norm's scale), or none: reported as unexpected
    if leaf not in table:
        raise ValueError(f"no port tensor for the torch leaf {leaf!r} at {path!r} "
                         f"({type(module).__name__})")
    return table[leaf]


def convert_state_dict(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                       key_rules: Sequence[Rule] = RESNET_KEY_RULES) -> Tuple[Dict[str, torch.Tensor], List[str]]:
    """A torch state dict -> (the port's keys and tensors for ``model``,
    the torch keys no rule matched). The ``module.`` prefix is stripped."""
    modules = dict(model.named_modules())
    out: Dict[str, torch.Tensor] = {}
    unexpected: List[str] = []
    for key, value in strip_prefix(state_dict).items():
        for pattern, repl, *transform in key_rules:
            m = re.match(pattern, key)
            if m:
                break
        else:
            unexpected.append(key)
            continue
        if repl is None:
            continue
        mapped = repl(m) if callable(repl) else m.expand(repl)
        path, leaf = mapped.rsplit(".", 1)
        module = modules.get(path)
        port_leaf = _port_leaf(module, leaf, path)
        if port_leaf is None:
            continue
        value = torch.as_tensor(value).detach().cpu()
        if transform and leaf == "weight" and module is not None:
            value = transform[0](value, modules[path.rsplit(".", 1)[0]])
        out[f"{path}.{port_leaf}"] = value
    return out, unexpected


def load_torch_weights(model: nn.Module, state_dict: Mapping[str, torch.Tensor],
                       key_rules: Sequence[Rule] = RESNET_KEY_RULES, strict: bool = False,
                       log: Optional[logging.Logger] = None) -> List[str]:
    """Copy a torch state dict into ``model`` through ``key_rules``, each
    tensor into the dtype and device of the port's. Missing, unexpected and
    mis-shaped keys are logged (raised when ``strict``); the others load.
    Returns the port keys it loaded."""
    log = log or logger
    converted, unexpected = convert_state_dict(model, state_dict, key_rules)
    have = model.state_dict()
    missing = sorted(set(have) - set(converted))
    extra = sorted(set(converted) - set(have))
    mismatched = sorted(f"{k} {tuple(have[k].shape)} vs torch {tuple(v.shape)}"
                        for k, v in converted.items() if k in have and v.shape != have[k].shape)
    loaded = sorted(k for k, v in converted.items() if k in have and v.shape == have[k].shape)
    problems = []
    if missing:
        problems.append(f"missing keys (kept as they were): {missing}")
    if unexpected or extra:
        problems.append(f"unexpected torch keys (ignored): {sorted(unexpected + extra)}")
    if mismatched:
        problems.append(f"shape mismatches (kept as they were): {mismatched}")
    if problems:
        msg = "torch import: " + "; ".join(problems)
        if strict:
            raise RuntimeError(msg)
        log.warning(msg)
    with torch.no_grad():
        for k in loaded:
            have[k].copy_(converted[k])
    return loaded


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A ``.pth``/``.pt`` file -> its state dict, the ``{'state_dict': ...}``
    envelope unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: torch.as_tensor(v) for k, v in obj.items()}


def backbone_key_rules(backbone: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> List[Rule]:
    """The table of ``backbone``'s own keys (unprefixed): torchvision VGG
    naming for a ``VGG``, and for an ``SSDVGG`` too where the state dict
    has ``features.`` keys (its 13 trunk convs), else the port's SSDVGG
    naming; torchvision ResNet naming for any other."""
    if isinstance(backbone, VGG):
        return vgg_key_rules(backbone.depth)
    if isinstance(backbone, SSDVGG):
        keys = [k.split(".", 1)[-1] if k.startswith("backbone.") else k
                for k in strip_prefix(state_dict)]
        if any(k.startswith("features.") for k in keys):
            return vgg_key_rules(16)
        return ssd_vgg_key_rules()
    return list(RESNET_KEY_RULES)


def detector_key_rules(model: nn.Module, state_dict: Mapping[str, torch.Tensor]) -> List[Rule]:
    """The rules for ``state_dict`` loaded into ``model``:

    * a model with no ``backbone`` (a ResNet or VGG itself): its own naming
      at the top level (``backbone_key_rules``);
    * a state dict with no ``backbone.`` key: a backbone's
      (``backbone_key_rules`` of the detector's backbone: a torchvision
      VGG16 into SSD's trunk), anchored under the detector's ``backbone.``;
    * else a whole detector's: the backbone's table under ``backbone.``, and
      where the model has an FPN its table, with the lateral count and start
      level read from the FPN module, and the two-stage heads' table for a
      ``TwoStageDetector``, else RetinaNet's. Keys no table maps are
      reported as unexpected."""
    backbone = getattr(model, "backbone", None)
    if not isinstance(backbone, nn.Module):
        return backbone_key_rules(model, state_dict)
    rules = backbone_key_rules(backbone, state_dict)
    if not any(k.startswith("backbone.") for k in strip_prefix(state_dict)):
        return prefixed_rules(rules, "", "backbone.")
    neck = getattr(model, "neck", None)
    if not isinstance(neck, FPN):
        return prefixed_rules(rules, "backbone.", "backbone.")
    table = faster_rcnn_key_rules if isinstance(model, TwoStageDetector) else retinanet_key_rules
    return table(num_laterals=len(neck.used), start_level=neck.used[0])
