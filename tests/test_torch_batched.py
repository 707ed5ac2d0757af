"""Batched lanes (B sequences per step): the port against the JAX package.

Setups of tests/test_batched.py (small_world seeds 7 and 8, B = 2, F = 6,
grid step 12, keyframe trigger at 150 PnP inliers) and
tests/test_lk_pallas.py.  Bounds:

- K1b's plain version (``lk_cuda.track_level_batch`` on CPU tensors)
  against ``lk_pallas.track_level_batch(select_dtype="f32",
  interpret=True)``: points within 5e-3 px, residuals within 1e-2, ``ok``
  equal (the bounds of tests/test_lk_pallas.py), on points >= 30 px inside
  the image (the Pallas kernel differentiates the sampled patch, the plain
  version samples gradient images: they agree away from borders, H6); the
  same with freeze-polish (walk 3 of 8 iterations).
- K2b's plain version (``orb_cuda.level_describe`` on CPU tensors, every
  corner valid) against ``orb_pallas.orb_descriptors_batch(
  select_dtype="f32", interpret=True)`` on corners >= 30 px inside
  (clear of fault F3): >= 99.5 % of bits equal, moments within 2e-3 +
  1e-5 relative (K2's tolerance: f32 sums of 709 terms in another order).
- Batched odometry against JAX ``run_sequence_batched`` from the same
  vmapped ``init_carry``: equal keyframe and tracking flags; poses within
  the bounds of tests/test_torch_slice.py (4 cm per position, 2 cm per
  frame-to-frame motion), since the RANSAC draws differ.  The same with the
  shared keyframe window (``batch_align_window=2``), which must also fire
  no inlier-triggered keyframe on an odd ``frame_idx``.
- Inside the port, lane b of ``run_sequence_batched`` against the
  single-lane ``run_sequence`` started with ``lane_keys(seed, B)[b]``:
  equal flags, inlier counts and keyframe stores, poses within 1e-5 (the
  batched and single solves may round differently in the last bits).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import KeyframeConfig as JKeyframe
from ros_stereo_slam_tpu.config import preset_odometry as j_preset
from ros_stereo_slam_tpu.data.synthetic import _smooth_noise_2d, small_world
from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.models import step_batched as jstep_batched
from ros_stereo_slam_tpu.ops import grid as jgrid
from ros_stereo_slam_tpu.ops import lk as jlk
from ros_stereo_slam_tpu.ops import lk_pallas, orb_pallas
from ros_stereo_slam_tpu_torch.config import (
    FrontendConfig, KeyframeConfig, preset_mapping, preset_odometry,
)
from ros_stereo_slam_tpu_torch.models import convert, pipeline, step, step_batched
from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda, orb_cuda

B, F = 2, 6
POS_TOL_M = 0.04
MOTION_TOL_M = 0.02
LANE_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _k1b_case():
    rng = np.random.default_rng(4)
    imgs, curs, ptss, guesses = [], [], [], []
    for b in range(B):
        img = _smooth_noise_2d((192, 256), rng, octaves=5, base_period=24)
        imgs.append(img)
        curs.append(np.roll(img, (-2 + b, 3 - 2 * b), axis=(0, 1)).astype(np.float32))
        p = np.stack([rng.uniform(30, 226, 32), rng.uniform(30, 162, 32)], 1)
        ptss.append(p.astype(np.float32))
        guesses.append((p + rng.uniform(-1, 1, p.shape)).astype(np.float32))
    return [np.stack(a) for a in (imgs, curs, ptss, guesses)]


def _k1b_against_pallas(walk):
    args = _k1b_case()
    iters = 6 if walk is None else 8
    jparams = jlk.LKParams(window=15, iters=iters, walk_iters=walk or iters, select_dtype="f32")
    jg, jr, jok = lk_pallas.track_level_batch(*(jnp.asarray(a) for a in args), jparams,
                                              interpret=True)
    before = lk_cuda.BATCH_LAUNCHES
    tg, tr, tok = lk_cuda.track_level_batch(*(torch.from_numpy(a) for a in args),
                                            lk.LKParams(window=15, iters=iters,
                                                        walk_iters=walk or iters))
    assert lk_cuda.BATCH_LAUNCHES == before  # CPU tensors: the plain version
    assert tg.shape == (B, 32, 2) and tr.shape == tok.shape == (B, 32)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-3)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-2)
    # the lanes really moved by their own shifts
    for b in range(B):
        flow = np.median(tg[b].numpy() - args[2][b], axis=0)
        np.testing.assert_allclose(flow, [3 - 2 * b, -2 + b], atol=0.05)


def test_k1b_plain_matches_pallas_batch():
    _k1b_against_pallas(None)


def test_k1b_polish_plain_matches_pallas_batch():
    _k1b_against_pallas(3)


def test_k2b_plain_matches_pallas_batch():
    rng = np.random.default_rng(6)
    nb, n = 3, 16
    imgs = np.stack([_smooth_noise_2d((192, 256), rng, octaves=4, base_period=16)
                     for _ in range(nb)])
    pts = np.stack([np.stack([rng.integers(30, 256 - 30, n), rng.integers(30, 192 - 30, n)],
                             axis=1) for _ in range(nb)]).astype(np.float32)
    js, jm = orb_pallas.orb_descriptors_batch(jnp.asarray(imgs), jnp.asarray(pts),
                                              select_dtype="f32", interpret=True)
    every = torch.ones((nb, n), dtype=torch.bool)  # every corner valid: the raw signs
    ts, tm, _ = orb_cuda.level_describe(torch.from_numpy(imgs), torch.from_numpy(pts), every)
    assert ts.shape == (nb, n, 256) and tm.shape == (nb, n, 2)
    assert (ts.numpy() == np.asarray(js)).mean() >= 0.995
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=2e-3, rtol=1e-5)
    for b in range(nb):  # each lane is the single-lane function of its own image
        s1, m1, _ = orb_cuda.level_describe(torch.from_numpy(imgs[b]), torch.from_numpy(pts[b]),
                                            every[b])
        assert torch.equal(s1, ts[b]) and torch.equal(m1, tm[b])


def _cfgs(camera):
    t = preset_odometry().replace(
        camera=camera, frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=8, min_pnp_inliers=150, map_block_points=1024))
    j = j_preset().replace(
        camera=camera, frontend=JFrontend(grid_step=12, max_points=1024),
        keyframes=JKeyframe(max_keyframes=8, min_pnp_inliers=150, map_block_points=1024))
    return t, j


@pytest.fixture(scope="module")
def lanes():
    worlds = [small_world(n_frames=F + 1, seed=7 + i) for i in range(B)]
    L = np.stack([np.stack([w.render(i)[0] for i in range(F + 1)]) for w in worlds])
    R = np.stack([np.stack([w.render(i)[1] for i in range(F + 1)]) for w in worlds])
    tcfg, jcfg = _cfgs(worlds[0].camera)
    gp, gm = pipeline._grid_for(tcfg, "cpu")
    return worlds, L, R, tcfg, jcfg, gp, gm


def _motions(T):
    T = T.astype(np.float64)
    return np.stack([np.linalg.inv(T[i - 1]) @ T[i] for i in range(1, len(T))])


@pytest.fixture(scope="module")
def jax_start(lanes):
    """JAX's grid and its vmapped ``init_carry`` of both lanes."""
    _, L, R, _, jcfg, _, _ = lanes
    pts, mask = (jnp.asarray(a) for a in jgrid.grid_points(
        jcfg.camera.height, jcfg.camera.width, jcfg.frontend.grid_step, jcfg.frontend.max_points))
    keys = jax.random.split(jax.random.PRNGKey(0), B)
    jcarry0 = jax.vmap(lambda l0, r0, k: jstep.init_carry(l0, r0, pts, mask, k, jcfg))(
        jnp.asarray(L[:, 0]), jnp.asarray(R[:, 0]), keys)
    return pts, mask, jcarry0


def _odometry_against_jax(lanes, jax_start, **kf):
    """Both packages' batched odometry from JAX's start, with the keyframe
    settings `kf` changed; returns the port's and JAX's stats."""
    worlds, L, R, tcfg, jcfg, gp, gm = lanes
    pts, mask, jcarry0 = jax_start
    tcfg = tcfg.replace(keyframes=dataclasses.replace(tcfg.keyframes, **kf))
    jcfg = jcfg.replace(keyframes=dataclasses.replace(jcfg.keyframes, **kf))
    _, jst = jax.device_get(jstep_batched.run_sequence_batched(
        jnp.asarray(L[:, 1:]), jnp.asarray(R[:, 1:]), jcarry0, pts, mask, jcfg))
    carry0 = convert.carry_from_numpy(jax.device_get(jcarry0), "cpu")
    reads = step.HOST_READS
    _, st = step_batched.run_sequence_batched(torch.from_numpy(L[:, 1:]),
                                              torch.from_numpy(R[:, 1:]), carry0, gp, gm, tcfg)
    assert step.HOST_READS - reads == 2 * F  # one rescue read, one keyframe read per frame
    assert st.T_wc.shape == (F, B, 4, 4)  # frame-major, as the reference's scan
    np.testing.assert_array_equal(st.is_keyframe.numpy(), jst.is_keyframe)
    np.testing.assert_array_equal(st.tracking_ok.numpy(), jst.tracking_ok)
    assert st.tracking_ok.all() and st.is_keyframe.any()
    for b in range(B):
        t = np.concatenate([np.eye(4, dtype=np.float32)[None], st.T_wc[:, b].numpy()])
        j = np.concatenate([np.eye(4, dtype=np.float32)[None], jst.T_wc[:, b]])
        assert np.linalg.norm(t[:, :3, 3] - j[:, :3, 3], axis=1).max() < POS_TOL_M
        dmot = np.linalg.norm(_motions(t)[:, :3, 3] - _motions(j)[:, :3, 3], axis=1)
        assert dmot.max() < MOTION_TOL_M, (b, dmot)
        gt = worlds[b].poses[F]
        assert np.linalg.norm(t[-1, :3, 3] - gt[:3, 3]) < 0.05
    return st, jst


def test_batched_odometry_matches_jax(lanes, jax_start):
    jc = jax.device_get(jax_start[2])
    carry0 = convert.carry_from_numpy(jc, "cpu")
    assert isinstance(carry0.key, tuple) and len(carry0.key) == B and carry0.frame_idx == 1
    back = convert.carry_to_numpy(carry0)  # the lane-stacked round trip
    np.testing.assert_array_equal(back.key, np.asarray(jc.key))
    np.testing.assert_array_equal(back.frame_idx, np.asarray(jc.frame_idx))
    for ours, theirs in ((back.track, jc.track), (back.keyframes, jc.keyframes)):
        for x, y in zip(ours, theirs):
            np.testing.assert_array_equal(x, np.asarray(y))
    _odometry_against_jax(lanes, jax_start)


def test_batched_align_window_matches_jax(lanes, jax_start):
    """``batch_align_window=2``: inlier-triggered keyframes wait for an even
    ``frame_idx`` (tracking failures would fire at once), as in JAX.  At a
    trigger of 200 PnP inliers both lanes fall below it on frame_idx 3 and
    the window defers their keyframe to frame_idx 4."""
    kf = dict(min_pnp_inliers=200)
    st, _ = _odometry_against_jax(lanes, jax_start, batch_align_window=2, **kf)
    frame_idx = 1 + np.arange(F)
    fired = st.is_keyframe.numpy() & st.tracking_ok.numpy()  # (F, B)
    assert not fired[frame_idx % 2 == 1].any(), fired
    assert fired[frame_idx == 4].all(), fired
    _, L, R, tcfg, _, gp, gm = lanes
    cfg = tcfg.replace(keyframes=dataclasses.replace(tcfg.keyframes, **kf))
    _, st1 = step_batched.run_sequence_batched(
        torch.from_numpy(L[:, 1:]), torch.from_numpy(R[:, 1:]),
        convert.carry_from_numpy(jax.device_get(jax_start[2]), "cpu"), gp, gm, cfg)
    assert st1.is_keyframe.numpy()[frame_idx == 3].all()  # unaligned: on frame_idx 3


@pytest.mark.parametrize("case", ["lockstep", "divergent"])
def test_lanes_match_single_lane(lanes, case):
    """Lane b of the batched run is the single-lane run with lane b's key.

    "divergent": lane 1 watches a static scene with a warm zero-motion
    prior, so on frame 1 only lane 0 (cold prior) takes the rescue and on
    its keyframe frame only lane 0 takes the keyframe branch; that pins the
    per-lane merge and the masked ring insert.
    """
    _, L, R, tcfg, _, gp, gm = lanes
    L, R = L.copy(), R.copy()
    warm = torch.tensor([False, case == "divergent"])
    if case == "divergent":
        L[1, :], R[1, :] = L[1, :1], R[1, :1]
    keys = step_batched.lane_keys(tcfg.seed, B)
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    c0 = step.init_carry_batched(Lt[:, 0], Rt[:, 0], gp, gm, keys, tcfg)
    c0 = c0._replace(dT_valid=warm)
    rescues, reads = step.RESCUES, step.HOST_READS
    cN, st = step_batched.run_sequence_batched(Lt[:, 1:], Rt[:, 1:], c0, gp, gm, tcfg)
    assert step.HOST_READS - reads == 2 * F
    n_rescue_frames = step.RESCUES - rescues
    singles = []
    for b in range(B):
        c = step.init_carry(Lt[b, 0], Rt[b, 0], gp, gm, keys[b], tcfg)
        c = c._replace(dT_valid=warm[b])
        rescues = step.RESCUES
        singles.append((*step.run_sequence(Lt[b, 1:], Rt[b, 1:], c, gp, gm, tcfg),
                        step.RESCUES - rescues))
    for b, (cs, ss, _) in enumerate(singles):
        for name in ("is_keyframe", "tracking_ok", "n_inliers", "n_tracked", "used_retry"):
            np.testing.assert_array_equal(getattr(st, name)[:, b].numpy(),
                                          getattr(ss, name).numpy(), err_msg=f"{b} {name}")
        np.testing.assert_allclose(st.T_wc[:, b].numpy(), ss.T_wc.numpy(), atol=LANE_TOL)
        kb, ks = step.KeyframeStore(*(x[b] for x in cN.keyframes)), cs.keyframes
        for name in ("frame_idx", "point_mask", "retrack", "valid", "count"):
            assert torch.equal(getattr(kb, name), getattr(ks, name)), (b, name)
        np.testing.assert_allclose(kb.poses.numpy(), ks.poses.numpy(), atol=LANE_TOL)
        pm = ks.point_mask.numpy()  # the stored landmarks (others are unused slots)
        np.testing.assert_allclose(kb.points.numpy()[pm], ks.points.numpy()[pm],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(cN.T_wc[b].numpy(), cs.T_wc.numpy(), atol=LANE_TOL)
    if case == "divergent":
        kf = st.is_keyframe.numpy()
        assert kf[:, 0].any() and not kf[:, 1].any(), kf
        assert singles[0][2] >= 1 and singles[1][2] == 0  # rescue: lane 0 only
        assert int(cN.keyframes.count[1]) == 1 < int(cN.keyframes.count[0])
        assert n_rescue_frames == singles[0][2]


@pytest.mark.parametrize("change", ["lk_seed"])
def test_unported_batched_options_raise(lanes, change):
    """The batched step needs the const-velocity seed, as the reference's."""
    _, L, R, tcfg, _, gp, gm = lanes
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    c0 = step.init_carry_batched(Lt[:, 0], Rt[:, 0], gp, gm, (1, 2), tcfg)
    cfg = tcfg.replace(frontend=dataclasses.replace(tcfg.frontend, lk_seed="none"))
    with pytest.raises(ValueError):
        step_batched.run_sequence_batched(Lt[:, 1:2], Rt[:, 1:2], c0, gp, gm, cfg)


@pytest.mark.parametrize("change", ["ba_enabled", "mapping_preset", "rgb_seq"])
def test_ported_batched_options_run(lanes, change):
    """BA, the mapping preset and RGB frames run in the batched step, each
    lane bitwise equal to its single-lane run: BA windows refined
    (finite, non-zero RMS), RGB keyframes chromatic, the mapping preset's
    gray map monochrome."""
    worlds, L, R, tcfg, _, gp, gm = lanes
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    cfg, rgb = tcfg, None
    if change == "ba_enabled":
        cfg = tcfg.replace(ba_enabled=True)
    elif change == "mapping_preset":
        cfg = preset_mapping().replace(camera=tcfg.camera, frontend=tcfg.frontend,
                                       keyframes=tcfg.keyframes)
    else:
        rgb = torch.from_numpy(np.stack([np.stack([(w.render_rgb(i) * 255 + 0.5).astype(np.uint8)
                                                   for i in range(F + 1)]) for w in worlds]))
    keys = step_batched.lane_keys(cfg.seed, B)
    c0 = step.init_carry_batched(Lt[:, 0], Rt[:, 0], gp, gm, keys, cfg,
                                 None if rgb is None else rgb[:, 0])
    cN, st = step_batched.run_sequence_batched(Lt[:, 1:], Rt[:, 1:], c0, gp, gm, cfg,
                                               None if rgb is None else rgb[:, 1:])
    assert st.tracking_ok.all() and st.is_keyframe.any()
    assert (cN.ba is not None) == (change == "ba_enabled")
    for b in range(B):
        c = step.init_carry(Lt[b, 0], Rt[b, 0], gp, gm, keys[b], cfg,
                            None if rgb is None else rgb[b, 0])
        cs, ss = step.run_sequence(Lt[b, 1:], Rt[b, 1:], c, gp, gm, cfg,
                                   None if rgb is None else rgb[b, 1:])
        for name in ss._fields:
            assert torch.equal(getattr(st, name)[:, b], getattr(ss, name)), (b, name)
        for x, y in zip(cN.keyframes, cs.keyframes):
            assert torch.equal(x[b], y)
        if cs.ba is not None:
            assert all(torch.equal(x[b], y) for x, y in zip(cN.ba, cs.ba))
    cols = cN.keyframes.colors[cN.keyframes.point_mask & cN.keyframes.valid[..., None]]
    rms = st.ba_rms.numpy()
    if change == "ba_enabled":
        assert np.isfinite(rms).all() and (rms > 0).all()
    else:
        assert (rms == 0).all()
    if change == "rgb_seq":
        assert (cols[:, 0] - cols[:, 2]).abs().mean() > 0.02
    else:
        assert torch.equal(cols[:, 0], cols[:, 1]) and torch.equal(cols[:, 0], cols[:, 2])


def test_lane_keys_and_lane_shapes():
    keys = step_batched.lane_keys(0, 3)
    assert len(set(keys)) == 3 and keys == step_batched.lane_keys(0, 3)
    assert keys != step_batched.lane_keys(1, 3)
    assert all(0 <= k < 2**64 for k in keys)
    with pytest.raises(ValueError):
        step.init_carry_batched(torch.zeros(2, 64, 64), torch.zeros(2, 64, 64),
                                torch.zeros(4, 2), torch.ones(4, dtype=torch.bool), (1,),
                                preset_odometry())


def test_entry_points_default_to_the_card(lanes):
    """Without ``device=`` the entry points go to the card; on a host
    without one they raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    _, L, R, tcfg, *_ = lanes
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.run_offline(tcfg, L[0, :2], R[0, :2])
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.StereoOdometry(tcfg)
