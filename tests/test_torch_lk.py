"""Port parity: LK tracking (the plain version of kernel K1, and the route).

The plain ``_track_level`` is held against the JAX jnp oracle
(``lk._track_level``) and against the Pallas kernel run in interpret mode
with f32 selects, set up as tests/test_lk_pallas.py does.  Tolerances:
- vs the jnp oracle: 2e-3 px, 1e-3 residual.  Same formulas; float32
  sums in another order can flip a masked eps-step (|delta| ~ eps = 0.01)
  on a point at the threshold, which moves it by < eps/4 in practice.
- vs the Pallas kernel: 5e-3 px and 1e-2 residual, the bounds of the JAX
  package's own kernel-vs-oracle test.
- Freeze-polish (``walk_iters < iters``), on points >= 30 px inside (H6):
  the same bounds against the Pallas kernel (interpret mode, f32 selects)
  and against the jnp oracle.  At the borders, against the jnp oracle only
  (the Pallas kernel differentiates the sampled patch, H6): points within
  9 px of the right and bottom borders, where the polish anchor clamps to
  W - S - 3 / H - S - 3 and the clamped sample moves points that the walk
  had settled; the top and left borders are left out, since the jnp route
  wraps a window that starts above or left of the image (F1).

The CUDA kernel itself is compared with the plain version on the card by
tests/test_torch_cuda.py (marked ``cuda``, skipped without a GPU) and by
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.data.synthetic import _smooth_noise_2d
from ros_stereo_slam_tpu.ops import lk as jlk
from ros_stereo_slam_tpu.ops import lk_pallas
from ros_stereo_slam_tpu.ops import pyramid as jpyr
from ros_stereo_slam_tpu_torch.ops import lk as tlk
from ros_stereo_slam_tpu_torch.ops import lk_cuda
from ros_stereo_slam_tpu_torch.ops import pyramid as tpyr


def _setup(seed=0, n=64, shape=(192, 256), shift=(-2, 3)):
    rng = np.random.default_rng(seed)
    img = _smooth_noise_2d(shape, rng, octaves=5, base_period=24)
    cur = np.roll(img, shift, axis=(0, 1)).astype(np.float32)
    pts = np.stack(
        [rng.uniform(30, shape[1] - 30, n), rng.uniform(30, shape[0] - 30, n)],
        axis=1,
    ).astype(np.float32)
    return img, cur, pts


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("window,iters", [(15, 6), (15, 10), (21, 8)])
def test_plain_level_matches_jnp_oracle(window, iters):
    img, cur, pts = _setup(seed=window + iters)
    guess = pts + np.random.default_rng(1).uniform(-1, 1, pts.shape).astype(np.float32)
    params_j = jlk.LKParams(window=window, iters=iters, walk_iters=iters)
    params_t = tlk.LKParams(window=window, iters=iters, walk_iters=iters)
    jg, jr, jok = jlk._track_level(*map(jnp.asarray, (img, cur, pts, guess)), params_j)
    tg, tr, tok = tlk._track_level(*_t(img, cur, pts, guess), params_t)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3)
    # and the flow is right: the image moved by (+3, -2)
    flow = tg.numpy() - pts
    assert np.median(np.abs(flow - np.array([3.0, -2.0]))) < 0.05


def test_plain_level_matches_pallas_interpret():
    img, cur, pts = _setup()
    params_j = jlk.LKParams(window=15, iters=6, select_dtype="f32")
    params_t = tlk.LKParams(window=15, iters=6)
    g0 = jnp.asarray(pts)
    pg, pr, pok = lk_pallas.track_level(
        jnp.asarray(img), jnp.asarray(cur), g0, g0, params_j, interpret=True)
    tg, tr, tok = tlk._track_level(*_t(img, cur, pts, pts), params_t)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(pok))
    np.testing.assert_allclose(tg.numpy(), np.asarray(pg), atol=5e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(pr), atol=1e-2)


@pytest.mark.parametrize("seeded", [False, True])
def test_multilevel_track_matches_jax(seeded):
    img, cur, pts = _setup(seed=3, n=96, shape=(188, 310), shift=(4, -9))
    flow = (np.tile([[-8.0, 3.0]], (len(pts), 1)).astype(np.float32) if seeded
            else None)
    params_j = jlk.LKParams(window=15, levels=3, iters=10)
    params_t = tlk.LKParams(window=15, levels=3, iters=10)
    jr = jlk.track(tuple(jpyr.build_pyramid(jnp.asarray(img), 3)),
                   tuple(jpyr.build_pyramid(jnp.asarray(cur), 3)),
                   jnp.asarray(pts), None if flow is None else jnp.asarray(flow),
                   params_j)
    tr = tlk.track(tuple(tpyr.build_pyramid(torch.from_numpy(img), 3)),
                   tuple(tpyr.build_pyramid(torch.from_numpy(cur), 3)),
                   torch.from_numpy(pts), None if flow is None else torch.from_numpy(flow),
                   params_t)
    np.testing.assert_array_equal(tr.valid.numpy(), np.asarray(jr.valid))
    np.testing.assert_allclose(tr.points.numpy(), np.asarray(jr.points), atol=2e-3)
    np.testing.assert_allclose(tr.residual.numpy(), np.asarray(jr.residual), atol=1e-3)
    ok = tr.valid.numpy()
    assert ok.sum() > 0.9 * len(pts)
    err = np.abs(tr.points.numpy()[ok] - pts[ok] - np.array([-9.0, 4.0]))
    assert np.median(err) < 0.05


def test_track_images_clamps_levels():
    assert tlk.max_levels_for((376, 1241), tlk.LKParams(window=15)) == \
        jlk.max_levels_for((376, 1241), jlk.LKParams(window=15))
    img, cur, pts = _setup(seed=5, n=16, shape=(72, 96))
    r = tlk.track_images(*_t(img, cur, pts), params=tlk.LKParams(window=15))
    j = jlk.track_images(jnp.asarray(img), jnp.asarray(cur), jnp.asarray(pts),
                         params=jlk.LKParams(window=15))
    np.testing.assert_array_equal(r.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(r.points.numpy(), np.asarray(j.points), atol=2e-3)


def test_route_cpu_takes_plain_version_without_launch():
    img, cur, pts = _setup(n=8)
    params = tlk.LKParams(window=15, iters=6)
    before = lk_cuda.LAUNCHES
    a = lk_cuda.track_level(*_t(img, cur, pts, pts), params)
    b = tlk._track_level(*_t(img, cur, pts, pts), params)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert lk_cuda.LAUNCHES == before


def test_route_rejects_other_devices_and_freeze_polish():
    """Other devices raise; freeze-polish takes the plain version on the CPU
    (no launch), and negative iteration counts raise."""
    img, cur, pts = _setup(n=8)
    params = tlk.LKParams(window=15, iters=6)
    meta = [t.to("meta") for t in _t(img, cur, pts, pts)]
    with pytest.raises(ValueError, match="unsupported device"):
        lk_cuda.track_level(*meta, params)
    polish = params._replace(walk_iters=3)
    before = lk_cuda.LAUNCHES
    a = lk_cuda.track_level(*_t(img, cur, pts, pts), polish)
    b = tlk._track_level(*_t(img, cur, pts, pts), polish)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert lk_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match=">= 0"):
        lk_cuda.track_level(*_t(img, cur, pts, pts), params._replace(walk_iters=-1))


@pytest.mark.parametrize("walk,iters", [(2, 6), (3, 8)])
def test_polish_level_matches_pallas_and_jnp(walk, iters):
    img, cur, pts = _setup(seed=walk + iters)
    guess = pts + np.random.default_rng(1).uniform(-1, 1, pts.shape).astype(np.float32)
    params_j = jlk.LKParams(window=15, iters=iters, walk_iters=walk, select_dtype="f32")
    params_t = tlk.LKParams(window=15, iters=iters, walk_iters=walk)
    args_j = [jnp.asarray(a) for a in (img, cur, pts, guess)]
    pg, pr, pok = lk_pallas.track_level(*args_j, params_j, interpret=True)
    jg, jr, jok = jlk._track_level(*args_j, params_j)
    tg, tr, tok = lk_cuda.track_level(*_t(img, cur, pts, guess), params_t)
    for g, r, ok, tol in ((pg, pr, pok, (5e-3, 1e-2)), (jg, jr, jok, (2e-3, 1e-3))):
        np.testing.assert_array_equal(tok.numpy(), np.asarray(ok))
        np.testing.assert_allclose(tg.numpy(), np.asarray(g), atol=tol[0])
        np.testing.assert_allclose(tr.numpy(), np.asarray(r), atol=tol[1])
    flow = tg.numpy() - pts
    assert np.median(np.abs(flow - np.array([3.0, -2.0]))) < 0.05
    # the polish phase ran: the walk alone stops elsewhere
    wg, _, _ = tlk._track_level(*_t(img, cur, pts, guess), params_t._replace(iters=walk))
    assert np.abs(wg.numpy() - tg.numpy()).max() > 1e-3


@pytest.mark.parametrize("walk,iters", [(2, 6), (3, 8)])
def test_polish_level_matches_jnp_at_borders(walk, iters):
    """Points near the right and bottom borders: the anchor clamps and the
    clamped polish sample moves the point; the port follows the jnp route."""
    shape = (96, 128)
    rng = np.random.default_rng(21)
    img = _smooth_noise_2d(shape, rng, octaves=5, base_period=16)
    cur = np.roll(img, (1, 1), axis=(0, 1)).astype(np.float32)
    n = 24
    along = rng.uniform(20, 70, n)
    edge = rng.uniform(1.0, 9.0, n)
    pts = np.concatenate([np.stack([shape[1] - edge[:12], along[:12]], 1),
                          np.stack([along[12:] + 30, shape[0] - edge[12:]], 1)]).astype(np.float32)
    guess = (pts + rng.uniform(-0.5, 0.5, pts.shape)).astype(np.float32)
    params_j = jlk.LKParams(window=15, iters=iters, walk_iters=walk)
    params_t = tlk.LKParams(window=15, iters=iters, walk_iters=walk)
    jg, jr, jok = jlk._track_level(*map(jnp.asarray, (img, cur, pts, guess)), params_j)
    tg, tr, tok = tlk._track_level(*_t(img, cur, pts, guess), params_t)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=2e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3)
    # the anchor clamped for these points, and polish moved some of them
    half = (15 - 1) * 0.5
    wg, _, _ = tlk._track_level(*_t(img, cur, pts, guess), params_t._replace(iters=walk))
    wg = wg.numpy()
    hi = np.array([shape[1] - 15 - 3.0, shape[0] - 15 - 3.0])
    clamped = (np.floor(wg - half) - 1.0 > hi).any(1)
    assert clamped.sum() >= n // 2, clamped
    assert (np.abs(tg.numpy() - wg).max(1)[clamped] > 1e-2).any()
