"""The other single-stage families' serving export against the JAX package's.

SSD300 (the full SSDVGG trunk: it has no width knob), YOLOv3, YOLOX,
CenterNet, GFL and PAA (its score voting), each through
``test_torch_export.check_family``: the loaded artifact bit for bit against
the live module, and against the reference's jitted ``make_serving_fn``
within the port's inference tolerances (that file's docstring). Torch runs
on one thread.
"""

import pytest

from test_torch_export import _one_torch_thread, check_family  # noqa: F401

SINGLE = ("ssd", "yolo", "yolox", "centernet", "gfl", "paa")


@pytest.mark.parametrize("name", SINGLE)
def test_export_round_trip_equals_live_and_the_reference(name):
    check_family(name)
