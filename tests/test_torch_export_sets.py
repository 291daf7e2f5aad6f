"""Cascade R-CNN, Sparse R-CNN, DETR and SOLOv2 serving export against the JAX package's.

Each through ``test_torch_export.check_family``: the loaded artifact bit
for bit against the live module, and against the reference's jitted
``make_serving_fn`` within the port's inference tolerances (that file's
docstring). Cascade R-CNN's three stages and Sparse R-CNN's two reach the
RoIAlign op once a stage inside the exported graph; DETR's decode has no
NMS; SOLOv2's Matrix NMS and ``mask_probs``. Torch runs on one thread.
"""

import pytest

from test_torch_export import _one_torch_thread, check_family  # noqa: F401

SETS = ("cascade_rcnn", "sparse_rcnn", "detr", "solov2")


@pytest.mark.parametrize("name", SETS)
def test_export_round_trip_equals_live_and_the_reference(name):
    check_family(name)
