"""The dense families' serving export against the JAX package's.

RetinaNet (greedy NMS and Soft-NMS), FreeAnchor, FCOS, ATSS and FoveaBox,
each through ``test_torch_export.check_family``: the loaded
artifact bit for bit against the live module, and against the reference's
jitted ``make_serving_fn`` within the port's inference tolerances (that
file's docstring). The GN towers run at batch 1 on a 64 x 64 canvas, so P7
is 1 x 1 and each of GroupNorm's 32 groups holds one value; the test
below holds that case to flax. Torch runs on one thread.
"""

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_export import _one_torch_thread, check_family  # noqa: F401
from torch_detection_tpu_torch.models import from_jax_variables
from torch_detection_tpu_torch.models.layers import GroupNorm

DENSE = ("retina", "retina_soft_nms", "free_anchor", "fcos", "atss", "fovea")


@pytest.mark.parametrize("name", DENSE)
def test_export_round_trip_equals_live_and_the_reference(name):
    check_family(name)


def test_group_norm_of_one_value_a_group_matches_flax():
    """Batch 1, one channel a group and a 1 x 1 map: flax normalizes each
    value to 0, so its output is the bias (``F.group_norm`` would refuse
    the input). Torch's kernel folds the normalization into ``x * a + b``
    with ``a = scale / sqrt(eps)`` (about 316 here) and ``b = bias - mean *
    a``, so ``x * a`` and ``mean * a`` round apart: within 1e-4 of flax's
    for values of order 1 (a float32 ulp of 316)."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1, 1, 1, 32)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 32).astype(np.float32)
    bias = rng.normal(0, 0.2, 32).astype(np.float32)
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-5).apply(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(want).ravel(), bias)
    norm = GroupNorm(32, num_groups=32)
    norm.load_state_dict(from_jax_variables({"params": {"scale": scale, "bias": bias}}))
    got = norm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4, rtol=0)
