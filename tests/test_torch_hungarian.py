"""The port's linear sum assignment against the JAX package's and scipy's.

The plain version (the CPU path of ``batched_linear_sum_assignment``) must
give the JAX function's ``col4row`` exactly, ties included, and scipy's
optimal total cost. Costs are float32 from a NumPy seed. The kernel
``csrc/hungarian.cu`` runs only on the card; ``chip_smoke.py`` holds it to
this plain version bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from torch_detection_tpu.ops.hungarian import batched_linear_sum_assignment as jax_batched
from torch_detection_tpu.ops.hungarian import linear_sum_assignment as jax_lsa
from torch_detection_tpu_torch.ops import hungarian
from torch_detection_tpu_torch.ops.hungarian import batched_linear_sum_assignment


def _jax(cost, valid=None):
    if valid is None:
        return np.asarray(jax.jit(jax_lsa)(jnp.asarray(cost)))
    return np.asarray(jax.jit(jax_lsa)(jnp.asarray(cost), jnp.asarray(valid)))


def _port(cost, valid=None):
    valid = None if valid is None else torch.from_numpy(valid)[None]
    return batched_linear_sum_assignment(torch.from_numpy(cost)[None], valid)[0].numpy()


def _total(cost, col4row):
    rows = np.flatnonzero(col4row >= 0)
    return float(cost[rows, col4row[rows]].astype(np.float64).sum())


def _scipy_total(cost):
    rows, cols = scipy_lsa(cost)
    return float(cost[rows, cols].astype(np.float64).sum())


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 7), (20, 100), (100, 100)])
def test_plain_matches_jax_and_scipy(shape):
    rng = np.random.default_rng(sum(shape))
    for _ in range(2):
        cost = (rng.normal(size=shape) * 10).astype(np.float32)
        got = _port(cost)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, _jax(cost))
        assert len(set(got.tolist())) == shape[0]
        assert _total(cost, got) == pytest.approx(_scipy_total(cost), abs=1e-3)


def test_row_valid_masks_leave_valid_rows_optimal():
    rng = np.random.default_rng(2)
    cost = rng.normal(size=(12, 20)).astype(np.float32)
    valid = rng.random(12) < 0.5
    got = _port(cost, valid)
    np.testing.assert_array_equal(got, _jax(cost, valid))
    assert (got[~valid] == -1).all() and (got[valid] >= 0).all()
    assert _total(cost, got) == pytest.approx(_scipy_total(cost[valid]), abs=1e-4)
    # what the invalid rows hold does not move the valid rows' matching
    other = cost.copy()
    other[~valid] = rng.normal(size=other[~valid].shape) * 1e3
    np.testing.assert_array_equal(_port(other, valid), got)


@pytest.mark.parametrize("levels", [2, 5])
def test_integer_ties_match_jax_exactly(levels):
    """Costs of a few integer values tie everywhere: the assignment is the
    JAX function's, tie for tie (lowest index first in every argmin)."""
    rng = np.random.default_rng(levels)
    cost = rng.integers(0, levels, size=(30, 40)).astype(np.float32)
    valid = np.arange(30) < 23
    got = _port(cost, valid)
    np.testing.assert_array_equal(got, _jax(cost, valid))
    assert _total(cost, got) == _scipy_total(cost[valid])


def test_nan_and_inf_entries_count_as_big_costs():
    rng = np.random.default_rng(4)
    cost = rng.normal(size=(6, 9)).astype(np.float32)
    cost[1, 3], cost[2, 5], cost[4, 0], cost[0, 0] = np.nan, np.inf, -np.inf, np.nan
    valid = np.array([True, True, False, True, True, True])
    got = _port(cost, valid)
    np.testing.assert_array_equal(got, _jax(cost, valid))
    assert got[4] == 0  # -inf counts as -1e9: that pair wins
    cleaned = np.nan_to_num(cost, nan=1e9, posinf=1e9, neginf=-1e9)
    assert _total(cleaned, got) == pytest.approx(_scipy_total(cleaned[valid]), rel=1e-6)


def test_batched_form_matches_the_vmapped_reference():
    """A training step's problems in small: stages x images, each with its
    own count of valid gts."""
    rng = np.random.default_rng(5)
    cost = rng.normal(size=(6, 10, 16)).astype(np.float32)
    valid = np.arange(10)[None] < rng.integers(1, 11, size=(6, 1))
    got = batched_linear_sum_assignment(torch.from_numpy(cost), torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jax.jit(jax_batched)(jnp.asarray(cost), jnp.asarray(valid))))
    unmasked = batched_linear_sum_assignment(torch.from_numpy(cost)).numpy()
    np.testing.assert_array_equal(unmasked, np.asarray(jax.jit(jax_batched)(jnp.asarray(cost))))


def test_cpu_tensors_take_the_plain_version_and_no_launch():
    launches = hungarian.batched_linear_sum_assignment_cuda.launches
    cost = torch.randn((2, 3, 4), generator=torch.Generator().manual_seed(0))
    got = batched_linear_sum_assignment(cost)
    assert torch.equal(got, hungarian.linear_sum_assignment_plain(cost))
    assert hungarian.batched_linear_sum_assignment_cuda.launches == launches


@pytest.mark.parametrize("cost,match", [
    (torch.zeros((1, 3, 4)), "CUDA"),  # the kernel's wrapper takes no CPU tensor
    (torch.zeros((1, 5, 4)), "rows <= columns"),
    (torch.zeros((3, 4)), r"\(P, G, Q\)"),
])
def test_kernel_wrapper_refuses_what_it_does_not_take(cost, match):
    with pytest.raises(ValueError, match=match):
        hungarian.batched_linear_sum_assignment_cuda(cost)
