"""The port's RoIAlign backward against autograd and the JAX package's VJPs.

Inputs and cotangents come from a numpy seed and go through both sides in
float32. The plain backward (the explicit scatter-add) is held to
``torch.autograd.grad`` through the plain forward, and to ``jax.vjp`` of the
JAX ``batched_multilevel_roi_align``: of the gather oracle (``impl="gather"``)
for every roi, and of the fused path (``impl="fused"``, the path the
reference's custom VJP takes off the TPU) for the rois inside its window
contract. Rois fall on all four levels; some are padded all-zero boxes.
Tolerance atol=1e-5: the same products summed in another order. The
cotangent has a standard deviation of 0.1, so that the sums stay near 1 in
the border cells where the clamp piles up the samples of rois that cross
the image's edge.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_detection_tpu.ops.roi_align import batched_multilevel_roi_align as jax_roi_align
from torch_detection_tpu_torch.ops import roi_align as port

STRIDES = (4, 8, 16, 32)
TOL = dict(atol=1e-5, rtol=0)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread for torch in this module: the test workers share
    the cores, and at these sizes threads contend more than they help."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _feats(rng, b=2, h=64, w=96, c=6):
    return [rng.normal(size=(b, h // 2**i, w // 2**i, c)).astype(np.float32) for i in range(4)]


def _rois(rng, b=2, in_contract=False):
    """Rois on each of the four levels (sizes 8-100, 115-220, 230-440 and
    460-700 px), two padded all-zero boxes an image, and, unless
    ``in_contract``, boxes outside the fused path's 39-cell window."""
    parts = []
    for lo, hi in ((8, 100), (115, 220), (230, 440), (460, 700)):
        xy = rng.uniform(-20, 300, (b, 5, 2))
        size = rng.uniform(lo, hi, (b, 5, 1))
        aspect = rng.uniform(0.6, 1.6, (b, 5, 1))
        wh = np.concatenate([size * np.sqrt(aspect), size / np.sqrt(aspect)], -1)
        parts.append(np.concatenate([xy, xy + wh], -1))
    parts.append(np.zeros((b, 2, 4)))
    if not in_contract:
        parts.append(np.broadcast_to(np.array([[2, 10, 380, 40], [30, 1, 50, 255]]), (b, 2, 4)))
    return np.concatenate(parts, axis=1).astype(np.float32)


def _levels(rois):
    return port.map_rois_to_levels(torch.from_numpy(rois), len(STRIDES))


def _plain_backward(feats, rois, g, **kw):
    grads = port.multilevel_roi_align_backward(
        torch.from_numpy(g), torch.from_numpy(rois), _levels(rois),
        [f.shape[1:3] for f in feats], STRIDES, **kw,
    )
    return [x.numpy() for x in grads]


def _jax_vjp(feats, rois, g, impl, **kw):
    fn = lambda fs: jax_roi_align(fs, jnp.asarray(rois), STRIDES, impl=impl, **kw)  # noqa: E731
    _, vjp = jax.vjp(fn, [jnp.asarray(f) for f in feats])
    (grads,) = vjp(jnp.asarray(g))
    return [np.asarray(x) for x in grads]


def _cotangent(rng, rois, c=6, out_size=7):
    return (0.1 * rng.normal(size=(*rois.shape[:2], out_size, out_size, c))).astype(np.float32)


def test_rois_cover_every_level(rng):
    levels = _levels(_rois(rng)).numpy()
    assert set(levels.ravel()) == {0, 1, 2, 3}


@pytest.mark.parametrize("out_size,ratio", [(7, 2), (14, 2), (4, 1), (5, 3)])
def test_plain_backward_equals_autograd_of_plain_forward(rng, out_size, ratio):
    feats, rois = _feats(rng), _rois(rng)
    g = _cotangent(rng, rois, out_size=out_size)
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    out = port.multilevel_roi_align(leaves, torch.from_numpy(rois), _levels(rois), STRIDES,
                                    out_size, ratio)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(g), materialize_grads=True)
    got = _plain_backward(feats, rois, g, out_size=out_size, sampling_ratio=ratio)
    for a, b in zip(got, want, strict=True):
        np.testing.assert_allclose(a, b.numpy(), **TOL)


def test_plain_backward_matches_jax_gather_vjp_for_every_roi(rng):
    feats, rois = _feats(rng), _rois(rng)
    g = _cotangent(rng, rois)
    for a, b in zip(_plain_backward(feats, rois, g), _jax_vjp(feats, rois, g, "gather"), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


def test_plain_backward_matches_jax_fused_vjp_inside_contract(rng):
    feats, rois = _feats(rng), _rois(rng, in_contract=True)
    g = _cotangent(rng, rois)
    for a, b in zip(_plain_backward(feats, rois, g), _jax_vjp(feats, rois, g, "fused"), strict=True):
        np.testing.assert_allclose(a, b, **TOL)


def test_function_backward_is_the_plain_backward_and_rois_get_no_gradient(rng):
    feats, rois = _feats(rng), _rois(rng)
    g = _cotangent(rng, rois)
    leaves = [torch.from_numpy(f).requires_grad_() for f in feats]
    boxes = torch.from_numpy(rois).requires_grad_()
    out = port.batched_multilevel_roi_align(leaves, boxes, STRIDES)
    out.backward(torch.from_numpy(g))
    assert boxes.grad is None
    for leaf, want in zip(leaves, _plain_backward(feats, rois, g), strict=True):
        np.testing.assert_array_equal(leaf.grad.numpy(), want)


def test_backward_keeps_the_cotangent_dtype(rng):
    feats, rois = _feats(rng), _rois(rng)
    g = torch.from_numpy(_cotangent(rng, rois)).bfloat16()
    grads = port.multilevel_roi_align_backward(
        g, torch.from_numpy(rois), _levels(rois), [f.shape[1:3] for f in feats], STRIDES)
    assert [x.dtype for x in grads] == [torch.bfloat16] * 4
    assert [tuple(x.shape) for x in grads] == [f.shape for f in feats]


def test_backward_cuda_wrapper_refuses_cpu_tensors(rng):
    feats, rois = _feats(rng), _rois(rng)
    with pytest.raises(ValueError, match="CUDA"):
        port.multilevel_roi_align_backward_cuda(
            torch.from_numpy(_cotangent(rng, rois)), torch.from_numpy(rois), _levels(rois),
            [f.shape[1:3] for f in feats], STRIDES,
        )
    assert port.multilevel_roi_align_backward_cuda.launches == 0
