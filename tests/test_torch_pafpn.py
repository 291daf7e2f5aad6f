"""``PAFPN`` and the RetinaNet PAFPN-R50 config against the JAX package's, on
the CPU in float32.

* ``PAFPN`` at narrow widths (inputs of 8, 16 and 32 channels, 16 out) on
  the reference's seeded variables (``strict=True``): the extra levels by
  subsampling, by convs on the input C5 with a ReLU between them, by convs
  on the aggregated last level, and from a later start level; every level
  within 1e-5 of its largest value;
* ``configs/retinanet_pafpn_r50_coco.py`` built whole through
  ``builder.build_detector`` (40 329 012 parameters, the JAX builder's
  count) on the s2d wire of a 128 x 128 canvas, as
  ``test_torch_light_retinanet.check_config`` holds the light configs, but
  each gradient within 1e-3 in the relative norm of its difference (50
  layers of float32 flip a few ReLU decisions); its stem and first stage
  frozen where the reference stops the gradient.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_backbone_zoo import carried
from test_torch_light_retinanet import check_config
from test_torch_vgg import nchw, rel_close
from torch_detection_tpu.models.necks import PAFPN as JaxPAFPN
from torch_detection_tpu_torch.models.necks import FPN, PAFPN
from torch_detection_tpu_torch.utils.registry import NECKS


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the test workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


CASES = {
    "subsampled": dict(num_outs=5),
    "convs_on_inputs": dict(num_outs=5, add_extra_convs=True, extra_convs_on_inputs=True,
                            relu_before_extra_convs=True),
    "convs_on_outputs": dict(num_outs=5, add_extra_convs=True, extra_convs_on_inputs=False),
    "from_level_1": dict(num_outs=4, start_level=1, add_extra_convs=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_pafpn_matches_the_reference(rng, case):
    kw = dict(in_channels=(8, 16, 32), out_channels=16, **CASES[case])
    inputs = [rng.normal(size=(2, 16 // 2**i, 24 // 2**i, 8 * 2**i)).astype(np.float32)
              for i in range(3)]
    jax_neck = JaxPAFPN(**kw)
    neck = NECKS.build(dict(kw, type="PAFPN"), device="cpu")
    assert isinstance(neck, PAFPN) and isinstance(neck, FPN)
    variables = carried(jax_neck, neck, rng, [jnp.asarray(x) for x in inputs])
    used = len(range(kw.get("start_level", 0), 3))
    assert sorted(n for n in neck.state_dict() if n.startswith("pa_")) == sorted(
        f"{kind}{i}.conv.{leaf}" for kind in ("pa_down", "pa_out") for i in range(1, used)
        for leaf in ("weight", "bias"))
    want = jax_neck.apply(variables, [jnp.asarray(x) for x in inputs])
    with torch.no_grad():
        got = neck([nchw(x).permute(0, 2, 3, 1) for x in inputs])
    assert len(got) == len(want) == kw["num_outs"]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (i, g.shape, w.shape)
        rel_close(g.numpy(), np.asarray(w), 1e-5, f"level {i}")


def test_pafpn_r50_config_builds_and_trains_as_the_reference():
    # through 50 layers float32's rounding flips a few ReLU decisions within
    # it of zero, each moving the gradients below it (conv_precision.py):
    # the gradients are held in the relative norm of their difference
    model, _ = check_config("retinanet_pafpn_r50_coco", 40_329_012, seed=13,
                            grad_norm_limit=1e-3)
    assert type(model.neck) is PAFPN and model.neck.in_channels == (512, 1024, 2048)
    frozen = {n.split(".")[1] for n, p in model.named_parameters() if not p.requires_grad}
    assert frozen == {"stem", "layer1_0", "layer1_1", "layer1_2"}
