"""The port's plain RoIAlign against the JAX package's RoIAlign paths.

Inputs come from a numpy seed and go through both sides in float32. The
port is exact for every roi, so it is held to the gather oracle
(``impl="gather"``) everywhere, and to the fused path (``impl="fused"``,
and ``impl="pallas"``, which falls back to it off the TPU) for the rois
inside that path's contract: a roi spans at most 39 cells at its level.
Tolerance atol=2e-5, rtol=1e-5, as the JAX package's own fused-vs-gather
test: the sums run in another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_detection_tpu.ops.roi_align import batched_multilevel_roi_align as jax_roi_align
from torch_detection_tpu.ops.roi_align import map_rois_to_levels as jax_map_levels
from torch_detection_tpu_torch.ops import roi_align as port

STRIDES = (4, 8, 16, 32)
TOL = dict(atol=2e-5, rtol=1e-5)


def _feats(rng, b=2, h=64, w=96, c=8):
    return [rng.normal(size=(b, h // 2**i, w // 2**i, c)).astype(np.float32) for i in range(4)]


def _rois_in_contract(rng, b=2, r=24):
    xy = rng.uniform(0, 180, (b, r, 2)).astype(np.float32)
    w = rng.uniform(8, 200, (b, r, 1)).astype(np.float32)
    aspect = rng.uniform(0.5, 2.0, (b, r, 1)).astype(np.float32)
    return np.concatenate([xy, xy + np.concatenate([w, w * aspect], -1)], -1)


def _rois_all(rng, b=2):
    rois = _rois_in_contract(rng, b, 16)
    extra = np.array(
        [
            [0, 0, 0, 0],  # padded proposal: all-zero box
            [0, 0, 0, 0],
            [0, 0, 55, 55],  # the level boundaries of the router test
            [0, 0, 111, 111],
            [0, 0, 223, 223],
            [0, 0, 447, 447],
            [0, 0, 1000, 1000],
            [2, 10, 380, 40],  # aspect > 4:1, outside the fused contract
            [30, 1, 50, 255],
            [-20, -30, 400, 290],  # crosses every border
        ],
        np.float32,
    )
    return np.concatenate([rois, np.broadcast_to(extra, (b, *extra.shape))], axis=1)


def _port(feats, rois, **kw):
    out = port.batched_multilevel_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(np.ascontiguousarray(rois)),
        STRIDES, **kw,
    )
    return out.numpy()


def _jax(feats, rois, impl, **kw):
    out = jax_roi_align([jnp.asarray(f) for f in feats], jnp.asarray(rois), STRIDES, impl=impl, **kw)
    return np.asarray(out)


def test_matches_gather_oracle_for_every_roi(rng):
    feats, rois = _feats(rng), _rois_all(rng)
    np.testing.assert_allclose(_port(feats, rois), _jax(feats, rois, "gather"), **TOL)


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_matches_fused_path_inside_contract(rng, impl):
    feats, rois = _feats(rng), _rois_in_contract(rng)
    np.testing.assert_allclose(_port(feats, rois), _jax(feats, rois, impl), **TOL)


def test_outside_contract_port_stays_exact(rng):
    """A 4:1 roi spans more than 39 cells of its level: the fused path clamps
    to its window and differs from the oracle; the port keeps the oracle."""
    feats = _feats(rng, h=128, w=256)
    rois = np.array([[[0, 0, 700, 100]]] * 2, np.float32)
    want = _jax(feats, rois, "gather")
    assert np.abs(_jax(feats, rois, "fused") - want).max() > 1e-3
    np.testing.assert_allclose(_port(feats, rois), want, **TOL)


@pytest.mark.parametrize("out_size,ratio", [(7, 2), (4, 1), (14, 2), (5, 3)])
def test_out_size_and_sampling_ratio(rng, out_size, ratio):
    feats, rois = _feats(rng, c=5), _rois_all(rng)
    kw = dict(out_size=out_size, sampling_ratio=ratio)
    np.testing.assert_allclose(_port(feats, rois, **kw), _jax(feats, rois, "gather", **kw), **TOL)


def test_level_router_matches():
    rois = np.array(
        [[0, 0, 55, 55], [0, 0, 111, 111], [0, 0, 223, 223], [0, 0, 447, 447],
         [0, 0, 1000, 1000], [0, 0, 0, 0], [5, 5, 4, 4], [0, 0, 54.9, 56.1]],
        np.float32,
    )
    got = port.map_rois_to_levels(torch.from_numpy(rois), 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_map_levels(jnp.asarray(rois), 4)))
    assert got.tolist()[:5] == [0, 1, 2, 3, 3]


def test_bf16_features_keep_their_dtype(rng):
    feats, rois = _feats(rng), _rois_in_contract(rng)
    out = port.batched_multilevel_roi_align(
        [torch.from_numpy(f).bfloat16() for f in feats], torch.from_numpy(rois), STRIDES
    )
    assert out.dtype == torch.bfloat16 and out.shape == (2, 24, 7, 7, 8)


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    feats, rois = _feats(rng), _rois_in_contract(rng)
    with pytest.raises(ValueError, match="CUDA"):
        port.multilevel_roi_align_cuda(
            [torch.from_numpy(f) for f in feats], torch.from_numpy(rois), STRIDES
        )
    assert port.multilevel_roi_align_cuda.launches == 0
