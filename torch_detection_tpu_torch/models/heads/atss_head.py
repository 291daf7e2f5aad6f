"""ATSS and PAA heads: FCOS's module tree, read downstream as anchor deltas.

Counterpart of ``torch_detection_tpu/models/heads/atss_head.py``: the same
parameter tree as ``FCOSHead`` (GN towers, ``scales``, a centerness
branch); the regression output is one anchor's deltas
(``models/detectors/atss.py``). ``PAAHead`` is the same tree, its third
output read as the IoU prediction (``models/detectors/paa.py``).
"""

from __future__ import annotations

from ...utils.registry import HEADS
from .fcos_head import FCOSHead


@HEADS.register_module
class ATSSHead(FCOSHead):
    """FCOSHead's tree and outputs; the delta decode is ``decode_atss``'s."""


@HEADS.register_module
class PAAHead(ATSSHead):
    """ATSSHead's tree and outputs; the third is PAA's IoU logit."""
