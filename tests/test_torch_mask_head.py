"""The port's mask head, mask targets, mask loss and paste against the JAX
package's, on the CPU in float32.

Tolerances: the head's logits atol 1e-5 (the convolutions sum in another
order); the window geometry exactly; the mask targets' values before their
0.5 threshold within one bf16 ulp, and the targets equal except where the
reference's value lies within 1/128 of 0.5; the loss rtol 1e-6; the pasted
masks equal.

The reference's ``mask_targets_for_rois`` returns thresholded targets only:
``_reference_means`` evaluates its jaxpr up to the comparison with 0.5 to
read the values before the threshold. It evaluates it op by op, each bf16
operation rounded as the reference writes it; under ``jax.jit`` XLA on the
CPU may keep excess precision in the bf16 pyramid, which moves the values
off the ones the reference's code spells out.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from torch_detection_tpu.models.heads.mask_head import FCNMaskHead as JaxFCNMaskHead
from torch_detection_tpu.models.heads.mask_head import mask_loss as jax_mask_loss
from torch_detection_tpu.models.heads.mask_head import mask_targets_for_rois as jax_mask_targets
from torch_detection_tpu.models.heads.mask_head import paste_masks as jax_paste_masks
from torch_detection_tpu.ops.roi_align import _window_geometry as jax_window_geometry
from torch_detection_tpu_torch.models import from_jax_variables, init_weights
from torch_detection_tpu_torch.models.heads import (
    FCNMaskHead,
    mask_loss,
    mask_targets_for_rois,
    paste_masks,
)
from torch_detection_tpu_torch.models.heads.mask_head import mask_target_means
from torch_detection_tpu_torch.ops.roi_align import map_rois_to_levels, window_geometry


def test_fcn_mask_head_matches(rng):
    """Two 3x3 convs, the 2x2 stride-2 transposed conv and the 1x1 logits
    on converted weights; the transposed conv's bias and kernel randomised
    so that every term counts."""
    x = rng.normal(size=(2, 5, 7, 7, 16)).astype(np.float32)
    jax_head = JaxFCNMaskHead(num_classes=3, in_channels=16, conv_channels=8, num_convs=2)
    variables = jax.tree_util.tree_map(np.asarray, jax_head.init(jax.random.PRNGKey(0), x))
    variables["params"]["upsample"]["bias"] = rng.normal(size=8).astype(np.float32)
    want = np.asarray(jax_head.apply(variables, x))
    head = FCNMaskHead(num_classes=3, in_channels=16, conv_channels=8, num_convs=2, device="cpu")
    head.load_state_dict(from_jax_variables(variables, head), strict=True)
    with torch.no_grad():
        got = head.to(memory_format=torch.channels_last)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 5, 14, 14, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


class _Upsample(jnn.Module):
    """A flax ``ConvTranspose`` under the name the converter reads."""

    @jnn.compact
    def __call__(self, x):
        return jnn.ConvTranspose(4, (2, 2), strides=(2, 2), name="upsample")(x)


def test_transposed_conv_converts_with_the_kernel_flipped(rng):
    x = rng.normal(size=(3, 5, 6, 2)).astype(np.float32)
    module = _Upsample()
    variables = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(1), x))
    want = np.asarray(module.apply(variables, x))
    conv = torch.nn.ConvTranspose2d(2, 4, 2, stride=2)
    state = from_jax_variables(variables, torch.nn.ModuleDict({"upsample": conv}))
    kernel = variables["params"]["upsample"]["kernel"]
    assert state["upsample.weight"].shape == (2, 4, 2, 2)
    np.testing.assert_array_equal(state["upsample.weight"].numpy(),
                                  kernel[::-1, ::-1].transpose(2, 3, 0, 1))

    def run(weight):
        conv.load_state_dict({"weight": weight, "bias": state["upsample.bias"]})
        with torch.no_grad():
            return conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(run(state["upsample.weight"]), want, atol=1e-6, rtol=0)
    unflipped = run(torch.from_numpy(np.ascontiguousarray(kernel.transpose(2, 3, 0, 1))))
    assert np.abs(unflipped - want).max() > 0.1  # the flip matters


@pytest.mark.parametrize("module", [None, torch.nn.Conv2d(2, 4, 2), torch.nn.Linear(2, 4)])
def test_kernel_layout_follows_the_port_module(rng, module):
    """A flax kernel loads in the layout of the module at its path: a rank-4
    kernel into no module, a plain conv or a dense layer is refused, so a
    transposed conv can never load unflipped."""
    x = rng.normal(size=(1, 3, 3, 2)).astype(np.float32)
    variables = jax.tree_util.tree_map(np.asarray, _Upsample().init(jax.random.PRNGKey(2), x))
    model = torch.nn.ModuleDict({} if module is None else {"upsample": module})
    if isinstance(module, torch.nn.Conv2d):  # a conv takes the kernel, unflipped
        kernel = variables["params"]["upsample"]["kernel"]
        np.testing.assert_array_equal(from_jax_variables(variables, model)["upsample.weight"],
                                      kernel.transpose(3, 2, 0, 1))
        return
    with pytest.raises(ValueError, match="upsample"):
        from_jax_variables(variables, model)


def test_reference_torch_importer_mirrors_transposed_convs_pins_r6(rng):
    """R6: the reference's torch importer turns a ``ConvTranspose2d`` weight
    into a flax kernel by a transpose alone, so flax applies it mirrored; it
    needs the flip that ``from_jax_variables`` undoes."""
    from torch_detection_tpu.models.torch_import import _classify_leaf

    x = rng.normal(size=(2, 4, 5, 2)).astype(np.float32)
    conv = torch.nn.ConvTranspose2d(2, 4, 2, stride=2, bias=False)
    with torch.no_grad():
        want = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    _, _, kernel = _classify_leaf("upsample", "weight", conv.weight.detach().numpy())
    module = jnn.ConvTranspose(4, (2, 2), strides=(2, 2), use_bias=False)
    imported = np.asarray(module.apply({"params": {"kernel": kernel}}, x))
    flipped = np.asarray(module.apply({"params": {"kernel": kernel[::-1, ::-1]}}, x))
    np.testing.assert_allclose(flipped, want, atol=1e-6, rtol=0)
    assert np.abs(imported - want).max() > 0.1


def test_transposed_conv_init_takes_flax_fan_in():
    """fan_in = in * kh * kw, as flax's lecun_normal on a (kh, kw, in, out)
    kernel; a zero bias."""
    conv = torch.nn.ConvTranspose2d(128, 32, 2, stride=2)
    init_weights(conv, torch.Generator().manual_seed(0))
    kernel = jnn.ConvTranspose(32, (2, 2), strides=(2, 2)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 128)))["params"]["kernel"]
    got, want = float(conv.weight.detach().std()), float(np.asarray(kernel).std())
    np.testing.assert_allclose(got, want, rtol=0.03)
    np.testing.assert_allclose(want, (1 / 512) ** 0.5, rtol=0.03)
    assert not conv.bias.any()


def _reference_means(masks, rois, matched, mask_size):
    """The reference's values before ``>= 0.5`` for one image."""
    closed = jax.make_jaxpr(lambda m, r, g: jax_mask_targets(m, r, g, mask_size))(
        masks, rois, matched)
    (compare,) = [e for e in closed.jaxpr.eqns if e.primitive.name == "ge"]
    jaxpr = closed.jaxpr.replace(outvars=[compare.invars[0]])
    return np.asarray(jax.core.eval_jaxpr(jaxpr, closed.consts, masks, rois, matched)[0])


def _masks(rng, b, g, h, w):
    """Filled ellipses with a few flipped pixels, so that the pyramid's means
    take many values."""
    yy, xx = np.mgrid[:h, :w]
    masks = np.zeros((b, g, h, w), np.uint8)
    for i in range(b):
        for k in range(g):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry, rx = rng.uniform(4, max(h, w) / 2, 2)
            masks[i, k] = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    return masks ^ (rng.uniform(size=masks.shape) < 0.05).astype(np.uint8)


def _boxes(xy, wh):
    return np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)


def _target_case(rng, case):
    """(masks (2, 3, H, W), rois (2, R, 4), matched (2, R), mask_size). The
    first three cases share their shapes, so the reference's operations
    compile once for them."""
    r, h, w, m = 24, 520, 600, 14
    if case == "levels":  # 2 ** k * 20 px routes to level k at mask size 14
        side = np.repeat(20.0 * 2.0 ** np.arange(6), 4)[None, :, None]
        side = side * rng.uniform(1, 1.3, (2, r, 1))
        xy = rng.uniform(0, 1, (2, r, 2)) * np.maximum([w, h] - side, 0)
        rois = _boxes(xy, np.broadcast_to(side, (2, r, 2)))
    elif case == "aspect":  # aspect 5:1 to 20:1, the window clamps the samples
        long, short = rng.uniform(150, 500, (2, r, 1)), rng.uniform(12, 30, (2, r, 1))
        wh = np.where(rng.uniform(size=(2, r, 1)) < 0.5, np.concatenate([long, short], -1),
                      np.concatenate([short, long], -1))
        rois = _boxes(rng.uniform(0, 1, (2, r, 2)) * ([w, h] - wh), wh)
    elif case == "border":  # on, across and beyond the raster's edges
        wh = rng.uniform(10, 300, (2, r, 2))
        xy = rng.choice([-30.0, 0.0, 1.0], (2, r, 2)) * rng.uniform(0, 1, (2, r, 2))
        far = rng.uniform(size=(2, r, 1)) < 0.5
        xy = np.where(far, [w, h] - wh + rng.choice([-1.0, 0.0, 20.0], (2, r, 2)), xy)
        rois = _boxes(xy, wh)
    else:  # the default mask size 28 on a 90 x 100 raster, under crop 112: padded
        h, w, m = 90, 100, 28
        wh = 4.0 * 25.0 ** rng.uniform(0, 1, (2, r, 2))
        rois = _boxes(rng.uniform(0, 1, (2, r, 2)) * ([w, h] - wh + 10) - 5, wh)
    return _masks(rng, 2, 3, h, w), rois, rng.integers(0, 3, (2, r)).astype(np.int32), m


@pytest.mark.parametrize("case", ["levels", "aspect", "border", "small_raster"])
def test_mask_targets_match(rng, case):
    masks, rois, matched, m = _target_case(rng, case)
    args = [torch.from_numpy(a) for a in (masks, rois, matched)]
    got = mask_target_means(*args, m).numpy()
    targets = mask_targets_for_rois(*args, m).numpy()
    levels = map_rois_to_levels(args[1], 6, float(m)).numpy()
    if case == "levels":
        assert set(levels.ravel()) == set(range(6))
    for i in range(2):
        want = _reference_means(masks[i], rois[i], matched[i], m)
        ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 2.0**-126)))) * 2.0**-7
        np.testing.assert_array_less(np.abs(got[i] - want), ulp + 1e-30, err_msg=f"image {i}")
        near = np.abs(want - 0.5) < 1 / 128
        np.testing.assert_array_equal(targets[i][~near], (want >= 0.5)[~near])
        assert 0.05 < want.mean() < 0.95 or case == "small_raster"


@pytest.mark.parametrize("mask_size", [14, 28])
def test_window_geometry_matches(rng, mask_size):
    """The copy of ``_window_geometry`` over every kind of roi above."""
    rois = np.concatenate([_target_case(rng, c)[1].reshape(-1, 4)
                           for c in ("levels", "aspect", "border", "small_raster")])
    shapes = [(520, 600), (260, 300), (130, 150), (65, 75), (33, 38), (17, 19)]
    kw = dict(strides=[1, 2, 4, 8, 16, 32], out_size=mask_size, sampling_ratio=2,
              finest_scale=float(mask_size), crop=4 * mask_size)
    got = window_geometry(shapes, torch.from_numpy(rois), **kw)
    want = jax_window_geometry(shapes, jnp.asarray(rois), **kw)  # op by op, as written
    assert (got[0], got[1]) == (list(want[0]), want[1])
    assert (len(set(map_rois_to_levels(torch.from_numpy(rois), 6, float(mask_size)).tolist()))
            >= 5)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_mask_loss_matches(rng):
    logits = (2 * rng.normal(size=(2, 6, 8, 8, 3))).astype(np.float32)
    targets = (rng.uniform(size=(2, 6, 8, 8)) < 0.4).astype(np.float32)
    labels = rng.integers(0, 4, (2, 6)).astype(np.int32)
    pos = labels > 0
    got = mask_loss(*(torch.from_numpy(a) for a in (logits, targets, labels, pos)))
    want = jax_mask_loss(*(jnp.asarray(a) for a in (logits, targets, labels, pos)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=0)


def test_paste_masks_matches(rng):
    probs = rng.uniform(size=(6, 14, 14)).astype(np.float32)
    boxes = np.array([[3.2, 4.7, 30.1, 22.9], [0, 0, 49, 39], [-6, 10, 12.5, 55],
                      [20.3, 20.3, 20.6, 21.0], [40, 5, 70, 20], [0, 0, 0, 0]], np.float32)
    got = paste_masks(torch.from_numpy(probs), torch.from_numpy(boxes), (40, 50)).numpy()
    want = np.asarray(jax.jit(lambda p, b: jax_paste_masks(p, b, (40, 50)))(probs, boxes))
    assert got.shape == (6, 40, 50) and got.any()
    np.testing.assert_array_equal(got, want)
