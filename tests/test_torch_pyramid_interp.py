"""Port parity: pyramids, Scharr gradients and bilinear sampling.

Tolerances: the pyramid is a 5-tap weighted sum per axis (the reference
evaluates it as a matmul, the port as shifted adds), so values in [0, 1]
agree to float32 round-off, 1e-6.  Patch sampling is the same formula on
the same integer tile and agrees to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.data.synthetic import _smooth_noise_2d
from ros_stereo_slam_tpu.ops import interp as jint
from ros_stereo_slam_tpu.ops import pyramid as jpyr
from ros_stereo_slam_tpu_torch.ops import interp as tint
from ros_stereo_slam_tpu_torch.ops import pyramid as tpyr


def _img(shape=(95, 131), seed=0):
    return _smooth_noise_2d(shape, np.random.default_rng(seed), octaves=5,
                            base_period=24)


@pytest.mark.parametrize("shape", [(376, 1241), (95, 131), (64, 64)])
def test_build_pyramid_sizes_and_values(shape):
    img = _img(shape)
    tp = tpyr.build_pyramid(torch.from_numpy(img), 4)
    jp = jpyr.build_pyramid(jnp.asarray(img), 4)
    h, w = shape
    for lvl, (t, j) in enumerate(zip(tp, jp)):
        assert tuple(t.shape) == (h, w), (lvl, t.shape)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
        h, w = (h + 1) // 2, (w + 1) // 2  # odd sizes round up


def test_scharr_gradients():
    img = _img()
    for t, j in zip(tpyr.scharr_gradients(torch.from_numpy(img)),
                    jpyr.scharr_gradients(jnp.asarray(img))):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)


def _patch_clamped(img, center, size):
    """numpy statement of the port's rule: the (size+1)^2 tile starts at
    floor(center - half) clamped to [0, dim - (size+1)]; the bilinear
    fraction comes from the unclamped floor."""
    H, W = img.shape
    x0, y0 = center[0] - (size - 1) / 2, center[1] - (size - 1) / 2
    xi, yi = np.floor(x0), np.floor(y0)
    fx, fy = x0 - xi, y0 - yi
    xs = int(np.clip(xi, 0, W - (size + 1)))
    ys = int(np.clip(yi, 0, H - (size + 1)))
    p = img[ys:ys + size + 1, xs:xs + size + 1].astype(np.float64)
    top = p[:-1, :-1] * (1 - fx) + p[:-1, 1:] * fx
    bot = p[1:, :-1] * (1 - fx) + p[1:, 1:] * fx
    return top * (1 - fy) + bot * fy


@pytest.mark.parametrize("size", [15, 21])
def test_extract_patches_with_border_clamp(size):
    """Centers inside the image, with starts at the top/left border (start
    0..2) and past the bottom/right border (start clamped to dim - size - 1,
    fraction from the unclamped floor): equal to the JAX function."""
    img = _img()
    H, W = img.shape
    h = (size - 1) / 2
    rng = np.random.default_rng(1)
    inner = np.stack([rng.uniform(12, W - 12, 40), rng.uniform(12, H - 12, 40)], 1)
    edge = np.array([
        [h + 0.3, h + 0.7], [h + 2.25, H / 2], [W / 2, h + 1.5],
        [W - 1.2, H - 0.6], [W - 4.75, H / 3], [W / 3, H - 5.5],
        [W + 3.7, H + 2.2], [W - h + 0.3, h + 0.9], [h, H - h - 0.5],
    ])
    centers = np.concatenate([inner, edge]).astype(np.float32)
    t = tint.extract_patches(torch.from_numpy(img), torch.from_numpy(centers), size)
    j = jax.vmap(lambda c: jint.extract_patch(jnp.asarray(img), c, size))(
        jnp.asarray(centers))
    assert tuple(t.shape) == (len(centers), size, size)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    for c, tp in zip(centers, t.numpy()):
        np.testing.assert_allclose(tp, _patch_clamped(img, c, size), atol=1e-6)
    np.testing.assert_allclose(
        tint.extract_patch(torch.from_numpy(img), torch.from_numpy(centers[-1]), size).numpy(),
        np.asarray(j[-1]), atol=1e-6)


def test_extract_patches_negative_start_clamps_to_zero():
    """A tile starting above or left of the image clamps its start to 0.

    The JAX function differs here: ``lax.dynamic_slice`` first wraps a
    negative start by the dimension (``allow_negative_indices=True``) and
    only then clamps, so it reads from the opposite border (a fault of the
    reference, listed in ROADMAP.md queue 3).  The port keeps the clamp the
    Pallas LK kernel applies (``lk_pallas._select_tile``)."""
    img = _img()
    H, W = img.shape
    size = 15
    centers = np.array([[0.3, 0.7], [3.25, H / 2], [W / 2, 2.5], [-6.3, 10.1],
                        [W / 3, -30.0]], np.float32)
    t = tint.extract_patches(torch.from_numpy(img), torch.from_numpy(centers), size)
    for c, tp in zip(centers, t.numpy()):
        np.testing.assert_allclose(tp, _patch_clamped(img, c, size), atol=1e-6)
    j = np.asarray(jax.vmap(lambda c: jint.extract_patch(jnp.asarray(img), c, size))(
        jnp.asarray(centers)))
    assert np.abs(j[0] - t.numpy()[0]).max() > 0.01  # the wrap reads elsewhere


def test_bilinear_at_and_in_bounds():
    img = _img()
    H, W = img.shape
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-5, W + 5, 200), rng.uniform(-5, H + 5, 200)], 1)
    pts = pts.astype(np.float32)
    np.testing.assert_allclose(
        tint.bilinear_at(torch.from_numpy(img), torch.from_numpy(pts)).numpy(),
        np.asarray(jint.bilinear_at(jnp.asarray(img), jnp.asarray(pts))), atol=1e-6)
    for margin in (0.0, 8.0, 11.5):
        np.testing.assert_array_equal(
            tint.in_bounds(torch.from_numpy(pts), H, W, margin).numpy(),
            np.asarray(jint.in_bounds(jnp.asarray(pts), H, W, margin)))
