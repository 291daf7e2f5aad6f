"""The port's ``ops/gmm.py::gmm_em_1d`` against the JAX package's.

Both sides take the same seeded float32 slates; the port runs every slate
of a (B, G, C) batch at once, the reference one slate at a time (as its
``vmap`` does). Tolerance: the responsibilities, log-likelihoods, means,
variances and weights to 1e-5 of max(1, |want|). Cases: two clusters, one
valid sample, none, identical values (the ``reg_covar`` floor), 3e38
sentinels in the padded slots, and a (B, G) batch that mixes them.
"""

import jax
import numpy as np
import pytest
import torch

from torch_detection_tpu.ops.gmm import gmm_em_1d as jax_gmm_em_1d
from torch_detection_tpu_torch.ops.gmm import gmm_em_1d

FIELDS = ("resp", "log_prob", "means", "variances", "weights")


def close(got, want, what):
    want = np.asarray(want, np.float64)
    scale = np.maximum(1.0, np.abs(want))
    err = np.abs(np.asarray(got, np.float64) - want) / scale
    assert err.max() <= 1e-5, f"{what}: {err.max()}"


def slate(case: str, rng, c: int = 18):
    """One (C,) slate of ``case`` and its validity."""
    valid = np.ones(c, bool)
    valid[-4:] = False
    x = rng.normal(0.5, 0.2, c).astype(np.float32)
    if case == "bimodal":
        x[7:] = rng.normal(3.0, 0.6, c - 7)
    elif case == "one_valid":
        valid[:] = False
        valid[3] = True
    elif case == "none_valid":
        valid[:] = False
    elif case == "identical":
        x[:] = 1.25
    elif case == "sentinels":
        x[7:] = rng.normal(2.0, 0.3, c - 7)
        x[~valid] = 3e38
    return x.astype(np.float32), valid


def reference(x, valid):
    run = jax.jit(jax_gmm_em_1d)
    return [run(xi, vi) for xi, vi in zip(x, valid)]


CASES = ("bimodal", "one_valid", "none_valid", "identical", "sentinels")


@pytest.mark.parametrize("case", CASES)
def test_gmm_matches_the_reference(rng, case):
    x, valid = slate(case, rng)
    got = gmm_em_1d(torch.from_numpy(x), torch.from_numpy(valid))
    want = reference(x[None], valid[None])[0]
    for field in FIELDS:
        assert np.isfinite(getattr(got, field).numpy()).all(), field
        close(getattr(got, field).numpy(), getattr(want, field), f"{case} {field}")
    assert not got.resp[torch.from_numpy(~valid)].any()  # invalid rows carry nothing
    if case == "identical":
        np.testing.assert_allclose(got.variances.numpy(), 1e-6, rtol=1e-3)  # the floor


def test_gmm_batched_over_images_and_gts_matches(rng):
    """A (B, G, C) batch of every case at once, and a few iteration counts."""
    b, g = 2, len(CASES) + 1
    pairs = [slate(CASES[(i + j) % len(CASES)], rng) for i in range(b) for j in range(g)]
    x = np.stack([p[0] for p in pairs]).reshape(b, g, -1)
    valid = np.stack([p[1] for p in pairs]).reshape(b, g, -1)
    for n_iter in (1, 25):
        got = gmm_em_1d(torch.from_numpy(x), torch.from_numpy(valid), n_iter=n_iter)
        run = jax.jit(lambda xi, vi: jax_gmm_em_1d(xi, vi, n_iter=n_iter))
        want = [run(xi, vi) for xi, vi in zip(x.reshape(b * g, -1), valid.reshape(b * g, -1))]
        for field in FIELDS:
            stacked = np.stack([np.asarray(getattr(w, field)) for w in want])
            got_field = getattr(got, field).numpy()
            assert got_field.shape[:2] == (b, g)
            close(got_field.reshape(stacked.shape), stacked, f"n_iter {n_iter} {field}")
