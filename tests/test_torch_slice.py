"""The odometry slice end to end: the port against the JAX package.

World and configuration of tests/test_pipeline.py (small_world(12, seed=5),
grid step 12, keyframe trigger at 150 PnP inliers).  The JAX reference
(run_offline on CPU) gives ATE ~0.008 m with keyframes at frames 4 and 8.

Bounds: the keyframe and tracking sequences must be identical.  The
RANSAC draws differ (the port's generators are not JAX's streams), so the
poses differ at the noise level of PnP on this half-resolution world,
where the JAX run's own per-frame position error against ground truth
reaches 3.1 cm: each frame-to-frame motion must agree within 2 cm (1.1 cm
measured), each position within 4 cm (2.0 cm measured), the ATEs within
1 cm of each other and both under 0.10 m.  Two port runs with one seed
must be bitwise equal.  The seeded track with freeze-polish
(``lk_seeded_walk_iters=3``) is held to the same bounds against the JAX
package's run of that configuration.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import KeyframeConfig as JKeyframe
from ros_stereo_slam_tpu.config import preset_odometry as j_preset
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.utils import metrics
from ros_stereo_slam_tpu_torch.config import FrontendConfig, KeyframeConfig, preset_odometry
from ros_stereo_slam_tpu_torch.models import convert, pipeline, step

POS_TOL_M = 0.04
MOTION_TOL_M = 0.02


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes, and
    torch's own thread pool on top of them oversubscribes the cores (this
    file's runs took 2-3x longer under the parallel suite)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(camera):
    t = preset_odometry().replace(
        camera=camera, frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=16, min_pnp_inliers=150,
                                 map_block_points=1024))
    j = j_preset().replace(
        camera=camera, frontend=JFrontend(grid_step=12, max_points=1024),
        keyframes=JKeyframe(max_keyframes=16, min_pnp_inliers=150,
                            map_block_points=1024))
    return t, j


@pytest.fixture(scope="module")
def runs():
    world = small_world(n_frames=12, seed=5)
    frames = [world.render(i) for i in range(world.n_frames)]
    left = np.stack([f[0] for f in frames])
    right = np.stack([f[1] for f in frames])
    tcfg, jcfg = _cfgs(world.camera)
    jres = jpipe.run_offline(jcfg, left, right)
    tres = [pipeline.run_offline(tcfg, left, right, device="cpu") for _ in range(2)]
    return world, left, right, tcfg, jcfg, jres, tres


def _assert_close_to_jax(world, tres, jres):
    np.testing.assert_array_equal(tres.is_keyframe, jres.is_keyframe)
    np.testing.assert_array_equal(tres.tracking_ok, jres.tracking_ok)
    assert tres.tracking_ok.all()
    traj = tres.trajectory
    assert traj.shape == jres.trajectory.shape == (12, 4, 4)
    dpos = np.linalg.norm(traj[:, :3, 3] - jres.trajectory[:, :3, 3], axis=1)
    assert dpos.max() < POS_TOL_M, dpos

    def motions(T):
        T = T.astype(np.float64)
        return np.stack([np.linalg.inv(T[i - 1]) @ T[i] for i in range(1, len(T))])

    dmot = np.linalg.norm(motions(traj)[:, :3, 3] - motions(jres.trajectory)[:, :3, 3],
                          axis=1)
    assert dmot.max() < MOTION_TOL_M, dmot
    ate_t = metrics.ate_rmse(traj, world.poses)
    ate_j = metrics.ate_rmse(jres.trajectory, world.poses)
    assert ate_t < 0.10 and ate_j < 0.10, (ate_t, ate_j)
    assert abs(ate_t - ate_j) < 0.01, (ate_t, ate_j)


def test_keyframes_and_tracking_identical(runs):
    *_, jres, tres = runs
    np.testing.assert_array_equal(tres[0].is_keyframe, jres.is_keyframe)
    np.testing.assert_array_equal(tres[0].tracking_ok, jres.tracking_ok)
    assert tres[0].tracking_ok.all()
    # keyframes at frames 4 and 8 (stats start at frame 1)
    assert list(np.nonzero(tres[0].is_keyframe)[0] + 1) == [4, 8]


def test_positions_and_ate_close_to_jax(runs):
    world, *_, jres, tres = runs
    _assert_close_to_jax(world, tres[0], jres)


def test_seeded_polish_matches_jax(runs):
    """``lk_seeded_walk_iters=3``: the seeded track's last iterations take
    the freeze-polish phase (K1's plain version here), in both packages."""
    import dataclasses

    world, left, right, tcfg, jcfg, _, tres = runs
    tcfg = tcfg.replace(frontend=dataclasses.replace(tcfg.frontend, lk_seeded_walk_iters=3))
    jcfg = jcfg.replace(frontend=dataclasses.replace(jcfg.frontend, lk_seeded_walk_iters=3))
    assert tcfg.frontend.lk_seeded_iters > 3
    jres = jpipe.run_offline(jcfg, left, right)
    res = pipeline.run_offline(tcfg, left, right, device="cpu", block=False)
    _assert_close_to_jax(world, res, jres)
    assert not np.array_equal(res.trajectory, tres[0].trajectory)  # the polish ran


def test_same_seed_bitwise_identical(runs):
    *_, tres = runs
    a, b = tres
    np.testing.assert_array_equal(a.trajectory, b.trajectory)
    np.testing.assert_array_equal(a.n_inliers, b.n_inliers)
    for name in a.keyframes._fields:
        assert torch.equal(getattr(a.keyframes, name), getattr(b.keyframes, name)), name


def test_streaming_driver_matches_offline(runs):
    _, left, right, tcfg, _, _, tres = runs
    odo = pipeline.StereoOdometry(tcfg, device="cpu")
    odo.initialize(left[0], right[0])
    for i in range(1, 5):
        odo.process_frame(left[i], right[i])
    np.testing.assert_array_equal(odo.trajectory_array(), tres[0].trajectory[:5])


def test_carry_from_jax_init_matches_port_init(runs):
    _, left, right, tcfg, jcfg, _, _ = runs
    gp, gm = jpipe._grid_for(jcfg)
    jcarry = jax.device_get(jstep.init_carry(
        jnp.asarray(left[0]), jnp.asarray(right[0]), gp, gm,
        jax.random.PRNGKey(jcfg.seed), jcfg))
    gpt, gmt = pipeline._grid_for(tcfg, "cpu")
    own = step.init_carry(torch.from_numpy(left[0]), torch.from_numpy(right[0]),
                          gpt, gmt, tcfg.seed, tcfg)
    conv = convert.carry_from_numpy(jcarry, "cpu")
    assert conv.frame_idx == own.frame_idx == 1
    assert len(conv.ref_pyr) == len(own.ref_pyr) == 1
    np.testing.assert_allclose(conv.ref_pyr[0].numpy(), own.ref_pyr[0].numpy(), atol=1e-6)
    np.testing.assert_array_equal(conv.track.pts2d.numpy(), own.track.pts2d.numpy())
    # The JAX jnp LK reads a coarse-level patch that starts above or left of
    # the image from the opposite border (the dynamic_slice wrap, ROADMAP
    # queue 3); the port clamps.  That can change a point's stereo match
    # only within 2^(levels-1) * (window // 2 + 1) px of the top/left border.
    m_j, m_t = conv.track.mask.numpy(), own.track.mask.numpy()
    diff = np.nonzero(m_j != m_t)[0]
    band = 2 ** (tcfg.frontend.lk_stereo_levels - 1) * (tcfg.frontend.lk_window // 2 + 1)
    pts = own.track.pts2d.numpy()[diff]
    assert len(diff) <= 2 and np.all(pts.min(axis=1) < band), (diff, pts)
    m = m_j & m_t
    # Landmarks from stereo LK: depth z = fx b / d amplifies the float32
    # disparity difference (~1e-4 px) by z / d; 1e-3 relative covers it.
    np.testing.assert_allclose(conv.track.pts3d.numpy()[m], own.track.pts3d.numpy()[m],
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(conv.track.colors.numpy(), own.track.colors.numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(conv.stereo_flow.numpy()[m], own.stereo_flow.numpy()[m],
                               atol=2e-3)
    for name in ("T_wc", "dT", "dT_valid"):
        np.testing.assert_array_equal(getattr(conv, name).numpy(),
                                      getattr(own, name).numpy())
    np.testing.assert_array_equal(conv.keyframes.point_mask.numpy()[0], m_j)
    np.testing.assert_array_equal(own.keyframes.point_mask.numpy()[0], m_t)
    for name in ("poses", "frame_idx", "retrack", "valid", "count"):
        np.testing.assert_array_equal(getattr(conv.keyframes, name).numpy(),
                                      getattr(own.keyframes, name).numpy(), err_msg=name)

    # ... and back: the round trip returns the JAX arrays unchanged.
    back = convert.carry_to_numpy(conv)
    np.testing.assert_array_equal(back.key, np.asarray(jcarry.key))
    assert back.frame_idx == jcarry.frame_idx
    for ours, theirs in ((back.track, jcarry.track), (back.keyframes, jcarry.keyframes)):
        for x, y in zip(ours, theirs):
            np.testing.assert_array_equal(x, np.asarray(y))
    for name in ("T_wc", "dT", "dT_valid", "stereo_flow"):
        np.testing.assert_array_equal(getattr(back, name), np.asarray(getattr(jcarry, name)))


@pytest.mark.parametrize("override", [
    dict(sampler="anms"), dict(stereo_matcher="orb", lk_seeded_iters=10, max_points=1152),
    dict(fmat_gate="ransac"), dict(stereo_gate="fmat"),
])
def test_frontend_choices_run_the_slice(runs, override):
    """Each frontend choice on the slice's world and configuration: every
    frame tracked, ATE under the odometry bound of 0.10 m, and the
    streaming driver gives run_offline's poses bitwise."""
    world, left, right, tcfg, *_ = runs
    import dataclasses

    cfg = tcfg.replace(frontend=dataclasses.replace(tcfg.frontend, **override))
    res = pipeline.run_offline(cfg, left, right, device="cpu")
    assert res.tracking_ok.all(), res.n_inliers
    assert metrics.ate_rmse(res.trajectory, world.poses) < 0.10
    odo = pipeline.StereoOdometry(cfg, device="cpu")
    odo.initialize(left[0], right[0])
    for i in range(1, 5):
        odo.process_frame(left[i], right[i])
    np.testing.assert_array_equal(odo.trajectory_array(), res.trajectory[:5])


def test_ba_enabled_runs_the_slice(runs):
    """``ba_enabled`` on the slice's configuration: every frame tracked, the
    post-BA RMS finite and positive on every frame, ATE within
    tests/test_ba_pipeline.py's bound of the odometry run (max(1.5x, 5 cm)),
    and the streaming driver gives run_offline's poses bitwise."""
    world, left, right, tcfg, _, _, tres = runs
    cfg = tcfg.replace(ba_enabled=True)
    res = pipeline.run_offline(cfg, left, right, device="cpu")
    assert res.tracking_ok.all()
    assert np.isfinite(res.ba_rms).all() and (res.ba_rms > 0).all(), res.ba_rms
    ate_odo = metrics.ate_rmse(tres[0].trajectory, world.poses)
    ate_ba = metrics.ate_rmse(res.trajectory, world.poses)
    assert ate_ba < max(1.5 * ate_odo, 0.05), (ate_odo, ate_ba)
    odo = pipeline.StereoOdometry(cfg, device="cpu")
    odo.initialize(left[0], right[0])
    for i in range(1, 5):
        odo.process_frame(left[i], right[i])
    np.testing.assert_array_equal(odo.trajectory_array(), res.trajectory[:5])
