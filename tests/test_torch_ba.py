"""Windowed Schur BA (config 4): the port against the JAX package.

Geometry of tests/test_ba.py (``_problem``, copied below) and of
tests/test_ba_pipeline.py (small_world(14, seed=21), grid step 12, BA
window 6, 6 iterations).  The JAX module solves its reduced system with
float32 CG at a conditioning of ~1e5-1e7; the port solves the whole
problem in float64 with a direct Cholesky factorisation.  Bounds:

- one GN step against the float64 dense oracle
  (``bundle_adjust.dense_solve_reference``, the full normal equations, no
  Schur complement): pose twists within 1e-6, landmark updates within
  1e-5 (the float32 outputs' rounding; measured 3.5e-8 and 4.6e-7).
  tests/test_ba.py holds JAX to 6e-3 and 3e-2 against its own oracle;
- the same step against JAX's ``ba_solve(iters=1)``: JAX's tolerances,
  6e-3 and 3e-2 (measured 5.5e-6 and 1.3e-5);
- the two oracles within 1e-4 (JAX builds its normal equations in
  float32; measured 3.8e-6 and 1.3e-5);
- convergence from a perturbed window: RMS below 1e-3 px and every pose
  within 1e-5 m of ground truth (tests/test_ba.py: 0.02 px, 5 mm);
- ``_ba_refine`` against JAX's, frame by frame, on the inputs of the
  port's own run (13 frames, keyframes at 5 and 11): the same accept
  decision on every frame, refined poses within 1e-5 m (measured 1.4e-6),
  the landmarks the window observes within 2e-4 of their distance from
  the camera (measured 2.5e-5), the window's observations equal, RMS
  within 1e-5 px (measured 3.4e-7); ``_ba_reset`` equal up to float32
  pose products (1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import BAConfig as JBA
from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import KeyframeConfig as JKeyframe
from ros_stereo_slam_tpu.config import preset_ba as j_preset_ba
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import bundle_adjust as jba
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.models.state import TrackState as JTrack
from ros_stereo_slam_tpu.ops import linalg as jlinalg
from ros_stereo_slam_tpu.utils import lie as jlie
from ros_stereo_slam_tpu.utils.camera import Pinhole as JPinhole
from ros_stereo_slam_tpu_torch.config import (
    BAConfig, FrontendConfig, KeyframeConfig, preset_ba, preset_odometry,
)
from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba
from ros_stereo_slam_tpu_torch.models import convert, pipeline, step, step_batched
from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh
from ros_stereo_slam_tpu_torch.utils import checkpoint, cuda_graph, lie, metrics
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

REFINE_POS_TOL_M = 1e-5
REFINE_PT_TOL = 2e-4  # relative to the landmark's distance from the camera


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(W=4, N=48, noise_px=0.3, seed=0):
    """tests/test_ba.py's wide-baseline, close-landmark window (numpy)."""
    rng = np.random.default_rng(seed)
    cam = JPinhole.from_K(np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]]))
    X = np.stack(
        [rng.uniform(-6, 6, N), rng.uniform(-3, 3, N), rng.uniform(5, 14, N)], 1
    ).astype(np.float32)
    T_cw = np.zeros((W, 4, 4), np.float32)
    for w in range(W):
        xi = np.concatenate(
            [rng.normal(0, 0.3, 3) + [1.5 * w - 2.0, 0, 0], rng.normal(0, 0.05, 3)]
        ).astype(np.float32)
        T_cw[w] = np.asarray(jlie.exp_se3(jnp.asarray(xi)))
    obs = np.zeros((W, N, 2), np.float32)
    for w in range(W):
        p = X @ T_cw[w, :3, :3].T + T_cw[w, :3, 3]
        uv = p[:, :2] / p[:, 2:3]
        obs[w] = uv * [float(cam.fx), float(cam.fy)] + [float(cam.cx), float(cam.cy)]
    obs += rng.normal(0, noise_px, obs.shape)
    tcam = Pinhole(*(float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy)))
    return cam, tcam, T_cw, X, obs.astype(np.float32), np.ones((W, N), bool)


def _t(a):
    return torch.from_numpy(np.array(a))


def _twists(T_new, T_old):
    """log(T_new T_old^-1) per pose, float64."""
    T_new, T_old = np.asarray(T_new, np.float64), np.asarray(T_old, np.float64)
    return np.stack([lie.log_se3(torch.from_numpy(a @ np.linalg.inv(b))).numpy()
                     for a, b in zip(T_new, T_old)])


def test_inv3x3_matches_jax():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    M[0] = 0.0  # singular: both divide by eps
    M[1] = np.diag([1e-12, 1e-12, 1e-12])  # |det| = 1e-36 <= eps
    got = linalg.inv3x3(torch.from_numpy(M)).numpy()
    want = np.asarray(jlinalg.inv3x3(jnp.asarray(M)))
    np.testing.assert_allclose(got[2:], want[2:], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6, atol=0)  # 1e-24 / 1e-30
    eye = np.einsum("nij,njk->nik", M[2:].astype(np.float64),
                    linalg.inv3x3(torch.from_numpy(M[2:].astype(np.float64))).numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape), atol=1e-9)


def test_gn_step_matches_dense_oracle_and_jax():
    cam, tcam, T_cw, X, obs, mask = _problem(W=3, N=12, noise_px=0.5, seed=1)
    fixed = np.array([True, False, False])
    key = jax.random.PRNGKey(0)
    dT = jax.vmap(jlie.exp_se3)(0.01 * jax.random.normal(key, (3, 6)))
    T_pert = np.asarray(jnp.einsum("wij,wjk->wik", dT, jnp.asarray(T_cw)))
    X_pert = np.asarray(jnp.asarray(X) + 0.05 * jax.random.normal(key, X.shape))
    kw = dict(damping=1e-3, huber_px=1e9)

    dp_ref, dx_ref = ba.dense_solve_reference(tcam, T_pert, X_pert, obs, mask, fixed, **kw)
    res = ba.ba_solve(tcam, _t(T_pert), _t(X_pert), _t(obs), _t(mask), _t(fixed), iters=1, **kw)
    dp = _twists(res.T_cw.numpy(), T_pert)
    dx = res.landmarks.numpy().astype(np.float64) - X_pert
    np.testing.assert_allclose(dp, dp_ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(dx, dx_ref, rtol=0, atol=1e-5)

    jres = jba.ba_solve(cam, jnp.asarray(T_pert), jnp.asarray(X_pert), jnp.asarray(obs),
                        jnp.asarray(mask), jnp.asarray(fixed), iters=1, **kw)
    np.testing.assert_allclose(dp, _twists(np.asarray(jres.T_cw), T_pert), rtol=0, atol=6e-3)
    np.testing.assert_allclose(dx, np.asarray(jres.landmarks) - X_pert, rtol=0, atol=3e-2)
    np.testing.assert_allclose(float(res.rms_before), float(jres.rms_before), rtol=1e-5)
    np.testing.assert_allclose(float(res.rms_after), float(jres.rms_after), rtol=1e-3)

    jdp, jdx = jba.dense_solve_reference(cam, jnp.asarray(T_pert), jnp.asarray(X_pert),
                                         jnp.asarray(obs), jnp.asarray(mask),
                                         jnp.asarray(fixed), **kw)
    np.testing.assert_allclose(dp_ref, np.asarray(jdp), rtol=0, atol=1e-4)
    np.testing.assert_allclose(dx_ref, np.asarray(jdx), rtol=0, atol=1e-4)


def test_ba_converges_to_ground_truth():
    _, tcam, T_cw, X, obs, mask = _problem(W=4, N=64, noise_px=0.0, seed=2)
    rng = np.random.default_rng(3)
    T_pert = T_cw.copy()
    for w in range(1, 4):
        xi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.005, 3)]).astype(np.float32)
        T_pert[w] = np.asarray(jlie.exp_se3(jnp.asarray(xi))) @ T_pert[w]
    X_pert = X + rng.normal(0, 0.2, X.shape).astype(np.float32)
    # Two fixed poses pin monocular BA's global-scale gauge.
    fixed = np.array([True, True, False, False])
    T_pert[1] = T_cw[1]
    res = ba.ba_solve(tcam, _t(T_pert), _t(X_pert), _t(obs), _t(mask), _t(fixed), iters=15,
                      damping=1e-5)
    assert float(res.rms_after) < 1e-3, float(res.rms_after)
    err = np.einsum("wij,wjk->wik", res.T_cw.numpy().astype(np.float64),
                    np.linalg.inv(T_cw.astype(np.float64)))
    assert np.linalg.norm(err[:, :3, 3], axis=1).max() < 1e-5, err[:, :3, 3]


def test_ba_huber_rejects_outlier_observations():
    _, tcam, T_cw, X, obs, mask = _problem(W=4, N=64, noise_px=0.2, seed=4)
    rng = np.random.default_rng(5)
    for _ in range(25):  # corrupt ~10% of the observations grossly
        obs[rng.integers(4), rng.integers(64)] += rng.uniform(30, 80, 2)
    X_pert = X + np.random.default_rng(6).normal(0, 0.1, X.shape).astype(np.float32)
    fixed = np.array([True, True, False, False])
    res = ba.ba_solve(tcam, _t(T_cw), _t(X_pert), _t(obs), _t(mask), _t(fixed), iters=15,
                      damping=1e-4, huber_px=2.0)
    err = np.einsum("wij,wjk->wik", res.T_cw.numpy().astype(np.float64),
                    np.linalg.inv(T_cw.astype(np.float64)))
    assert np.linalg.norm(err[2:, :3, 3], axis=1).max() < 0.05


@pytest.mark.parametrize("case", ["all_masked", "nan_observation", "rms_grows"])
def test_ba_no_op_when_diverging(case):
    """A window that cannot be refined returns its input bit for bit: no
    observation at all or a non-finite observation (JAX's does the same),
    or a step that raises the RMS (a free pose turned 1 rad away, undamped,
    no Huber: the exact GN step takes the RMS from 1,552 px to 1,986 px;
    JAX's float32 CG takes another, inexact step on this undamped system,
    which happens to lower its RMS, so that case holds the port alone)."""
    cam, tcam, T_cw, X, obs, mask = _problem(W=3, N=12, seed=7)
    fixed = np.array([True, False, False])
    kw = dict(iters=3)
    if case == "all_masked":
        mask[:] = False
    elif case == "nan_observation":
        obs[1, 3, 0] = np.nan
    else:
        fixed[1] = True
        turn = np.asarray(jlie.exp_se3(jnp.asarray([0.0, 0.0, 0.0, 0.0, 1.0, 0.0])))
        T_cw[2] = turn @ T_cw[2]
        kw = dict(iters=1, damping=0.0, huber_px=1e9)
    res = ba.ba_solve(tcam, _t(T_cw), _t(X), _t(obs), _t(mask), _t(fixed), **kw)
    assert torch.equal(res.T_cw, _t(T_cw)) and torch.equal(res.landmarks, _t(X))
    if case == "rms_grows":
        assert float(res.rms_after) == float(res.rms_before) > 1500.0
    else:
        jres = jba.ba_solve(cam, *(jnp.asarray(a) for a in (T_cw, X, obs, mask, fixed)), **kw)
        np.testing.assert_allclose(np.asarray(jres.T_cw), T_cw, atol=1e-6)
        np.testing.assert_allclose(np.asarray(jres.landmarks), X, atol=1e-6)


_KEY_CAM = Pinhole(707.0912, 707.0912, 601.8873, 183.1104)


def _key(W=9, N=768, cam=_KEY_CAM, device="cpu", obs_dtype=torch.float32, iters=10,
         damping=1e-4, huber_px=2.0):
    return cuda_graph.BA.key(dict(
        cam=cam, T_cw=torch.zeros((W, 4, 4), device=device),
        landmarks=torch.zeros((N, 3), device=device),
        obs=torch.zeros((W, N, 2), dtype=obs_dtype, device=device),
        obs_mask=torch.zeros((W, N), dtype=torch.bool, device=device),
        fixed=torch.zeros((W,), dtype=torch.bool, device=device),
        iters=iters, damping=damping, huber_px=huber_px))


@pytest.mark.parametrize("change", [
    {}, {"W": 7}, {"N": 512}, {"iters": 1}, {"damping": 0.0}, {"huber_px": 1e9},
    {"cam": _KEY_CAM._replace(fx=718.856)}, {"cam": _KEY_CAM._replace(cy=185.2157)},
    {"device": "meta"}, {"obs_dtype": torch.float64},
])
def test_graph_key_separates_every_baked_in_scalar_and_shape(change):
    """Equal inputs (fresh tensors of the same signature) share one key;
    any shape, dtype, scalar, camera or device the graph bakes in gives
    another."""
    assert (_key(**change) == _key()) == (not change)


@pytest.mark.parametrize("device,mesh,graph", [
    ("cuda", None, True),
    ("cuda", Mesh(rank=0, size=1, device=torch.device("cuda:0")), False),
    ("cpu", None, False),
    ("cpu", Mesh(rank=0, size=1, device=torch.device("cpu")), False),
])
def test_graph_engages_only_on_the_card_without_a_mesh(device, mesh, graph):
    assert cuda_graph.BA.replays_on(torch.device(device), mesh) is graph


def test_a_cpu_solve_is_eager_and_counted(monkeypatch):
    """On the CPU ``ba_solve`` runs the eager solve (bitwise) and counts
    it as a solve, its iterations and an eager solve; nothing is captured
    or replayed."""
    fam = cuda_graph.BA
    monkeypatch.setattr(fam, "graphs", {})
    _, tcam, T_cw, X, obs, mask = _problem(W=3, N=12, seed=8)
    args = (tcam, _t(T_cw), _t(X), _t(obs), _t(mask), _t(np.array([True, False, False])))
    before = (ba.SOLVES, ba.ITERATIONS, fam.eager, fam.captures, fam.replays)
    got = ba.ba_solve(*args, iters=3)
    after = (ba.SOLVES, ba.ITERATIONS, fam.eager, fam.captures, fam.replays)
    assert [a - b for a, b in zip(after, before)] == [1, 3, 1, 0, 0]
    assert not fam.graphs
    want = ba._solve(*args, iters=3, damping=1e-4, huber_px=2.0)
    for a, b in zip(got, want, strict=True):
        assert torch.equal(a, b)


def _world_cfgs(window=6, iters=6):
    world = small_world(n_frames=14, seed=21)
    kw = dict(grid_step=12, max_points=1024)
    kf = dict(max_keyframes=16, min_pnp_inliers=150, map_block_points=1024)
    bc = dict(window=window, iters=iters, damping=1e-4, huber_px=2.0)
    t = preset_ba().replace(camera=world.camera, frontend=FrontendConfig(**kw),
                            keyframes=KeyframeConfig(**kf), ba=BAConfig(**bc))
    j = j_preset_ba().replace(camera=world.camera, frontend=JFrontend(**kw),
                              keyframes=JKeyframe(**kf), ba=JBA(**bc))
    return world, t, j


@pytest.fixture(scope="module")
def ba_run():
    """The port's run_offline under preset_ba() on tests/test_ba_pipeline.py's
    world, with the inputs and outputs of every _ba_refine and _ba_reset."""
    world, tcfg, jcfg = _world_cfgs()
    frames = [world.render(i) for i in range(world.n_frames)]
    L = np.stack([f[0] for f in frames])
    R = np.stack([f[1] for f in frames])
    calls = {"refine": [], "reset": []}
    refine, reset = step._ba_refine, step._ba_reset

    def rec_refine(*args):
        out = refine(*args)
        calls["refine"].append((args[:-1], out))
        return out

    def rec_reset(*args):
        out = reset(*args)
        calls["reset"].append((args[:-1], out))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(step, "_ba_refine", rec_refine)
    mp.setattr(step, "_ba_reset", rec_reset)
    try:
        reads = step.HOST_READS
        res = pipeline.run_offline(tcfg, L, R, device="cpu")
        reads = step.HOST_READS - reads
    finally:
        mp.undo()
    odo = pipeline.run_offline(preset_odometry().replace(
        camera=tcfg.camera, frontend=tcfg.frontend, keyframes=tcfg.keyframes), L, R,
        device="cpu")
    return world, L, R, tcfg, jcfg, res, odo, calls, reads


def test_ba_pipeline_tracks_with_bounded_ate(ba_run):
    """tests/test_ba_pipeline.py's checks on the port: every frame tracked,
    ATE below max(1.5 x the odometry run's, 5 cm), a finite map; BA adds
    no host read (2 per frame, as odometry)."""
    world, L, _, _, _, res, odo, calls, reads = ba_run
    assert res.tracking_ok.all() and res.is_keyframe.any()
    ate_odo = metrics.ate_rmse(odo.trajectory, world.poses)
    ate_ba = metrics.ate_rmse(res.trajectory, world.poses)
    assert ate_ba < max(1.5 * ate_odo, 0.05), (ate_odo, ate_ba)
    pts, _ = pipeline.map_points_of(res.keyframes)
    assert len(pts) > 500 and np.isfinite(pts).all()
    assert np.isfinite(res.ba_rms).all() and (res.ba_rms > 0).all()
    assert reads == 2 * (L.shape[0] - 1)
    assert len(calls["refine"]) == L.shape[0] - 1
    assert len(calls["reset"]) == 1 + int(res.is_keyframe.sum())


def _jax_ba(st):
    return jstep.BAState(*(jnp.asarray(x[0].numpy()) for x in st))


def test_ba_refine_and_reset_match_jax_frame_by_frame(ba_run):
    *_, tcfg, jcfg, _, _, calls, _ = ba_run
    refine_j = jax.jit(jstep._ba_refine, static_argnames=("cfg",))
    for (track, r_uv, r_mask, T_wc), out in calls["reset"]:
        want = jstep._ba_reset(JTrack(*(jnp.asarray(x[0].numpy()) for x in track)),
                               jnp.asarray(r_uv[0].numpy()), jnp.asarray(r_mask[0].numpy()),
                               jnp.asarray(T_wc[0].numpy()), jnp.asarray(track.pts2d[0].numpy()),
                               jcfg)
        for name, x in zip(step.BAState._fields, out):
            np.testing.assert_allclose(x[0].numpy(), np.asarray(getattr(want, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
    n_kept = 0
    for i, ((st, track, T_wc, uv, m), (st_t, T_t, track_t, rms_t)) in enumerate(calls["refine"]):
        st_j, T_j, track_j, rms_j = jax.device_get(refine_j(
            _jax_ba(st), JTrack(*(jnp.asarray(x[0].numpy()) for x in track)),
            jnp.asarray(T_wc[0].numpy()), jnp.asarray(uv[0].numpy()),
            jnp.asarray(m[0].numpy()), jcfg))
        X_in = track.pts3d[0].numpy()
        kept_t = np.array_equal(track_t.pts3d[0].numpy(), X_in)
        kept_j = np.array_equal(np.asarray(track_j.pts3d), X_in)
        assert kept_t == kept_j, (i, float(rms_t[0]), float(rms_j))
        n_kept += kept_t
        for name in ("obs_uv", "obs_mask", "right_uv", "right_mask", "T_cw_right", "n_frames"):
            np.testing.assert_array_equal(getattr(st_t, name)[0].numpy(),
                                          np.asarray(getattr(st_j, name)), err_msg=name)
        np.testing.assert_allclose(st_t.T_cw[0].numpy(), st_j.T_cw, rtol=0,
                                   atol=REFINE_POS_TOL_M, err_msg=f"frame {i}")
        np.testing.assert_allclose(T_t[0].numpy(), T_j, rtol=0, atol=REFINE_POS_TOL_M)
        seen = st_t.obs_mask[0].numpy().any(0) | st_t.right_mask[0].numpy()
        depth = np.linalg.norm(X_in - T_wc[0, :3, 3].numpy(), axis=1)[seen]
        dX = np.linalg.norm(track_t.pts3d[0].numpy() - track_j.pts3d, axis=1)[seen]
        assert (dX <= REFINE_PT_TOL * depth).all(), (i, (dX / depth).max())
        np.testing.assert_allclose(float(rms_t[0]), float(rms_j), rtol=0, atol=1e-5)
    assert n_kept < len(calls["refine"])  # the comparison covers refined windows


def test_ba_lanes_equal_single_lane_runs():
    """Two lanes that reach keyframes on different frames (5 and 10 against
    6), each bitwise equal to its single-lane run."""
    world, tcfg, _ = _world_cfgs()
    world = small_world(n_frames=24, seed=21)
    fr = [world.render(i) for i in range(24)]
    L = torch.from_numpy(np.stack([f[0] for f in fr])).reshape(2, 12, *fr[0][0].shape)
    R = torch.from_numpy(np.stack([f[1] for f in fr])).reshape(2, 12, *fr[0][0].shape)
    gp, gm = pipeline._grid_for(tcfg, "cpu")
    keys = step_batched.lane_keys(tcfg.seed, 2)
    c0 = step.init_carry_batched(L[:, 0], R[:, 0], gp, gm, keys, tcfg)
    cN, st = step_batched.run_sequence_batched(L[:, 1:], R[:, 1:], c0, gp, gm, tcfg)
    kf = st.is_keyframe.numpy()
    assert not np.array_equal(kf[:, 0], kf[:, 1]), kf
    for b in range(2):
        c = step.init_carry(L[b, 0], R[b, 0], gp, gm, keys[b], tcfg)
        cs, ss = step.run_sequence(L[b, 1:], R[b, 1:], c, gp, gm, tcfg)
        for name in ss._fields:
            assert torch.equal(getattr(st, name)[:, b], getattr(ss, name)), (b, name)
        for part in ("track", "keyframes", "ba"):
            for x, y in zip(getattr(cN, part), getattr(cs, part)):
                assert torch.equal(x[b], y), (b, part)


def test_ba_carry_crosses_from_jax_and_back():
    """A JAX init_carry under preset_ba() becomes a port carry with its BA
    window and comes back unchanged."""
    world, tcfg, jcfg = _world_cfgs()
    left, right, _ = world.render(0)
    gp, gm = jpipe._grid_for(jcfg)
    jcarry = jax.device_get(jstep.init_carry(jnp.asarray(left), jnp.asarray(right), gp, gm,
                                             jax.random.PRNGKey(jcfg.seed), jcfg))
    conv = convert.carry_from_numpy(jcarry, "cpu")
    assert isinstance(conv.ba, step.BAState)
    assert conv.ba.n_frames.dtype == torch.int32 and int(conv.ba.n_frames) == 1
    assert conv.ba.obs_uv.shape == (tcfg.ba.window, tcfg.frontend.max_points, 2)
    back = convert.carry_to_numpy(conv)
    for name in step.BAState._fields:
        got, want = getattr(back.ba, name), np.asarray(getattr(jcarry.ba, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    # The port's own bootstrap opens the same window up to its stereo match.
    gpt, gmt = pipeline._grid_for(tcfg, "cpu")
    own = step.init_carry(torch.from_numpy(left), torch.from_numpy(right), gpt, gmt,
                          tcfg.seed, tcfg)
    for name in ("obs_uv", "T_cw", "T_cw_right", "n_frames"):
        np.testing.assert_allclose(getattr(own.ba, name).numpy(),
                                   getattr(conv.ba, name).numpy(), rtol=0, atol=1e-6)


def test_ba_carry_checkpoint_round_trip(tmp_path):
    """A carry with BA state survives utils/checkpoint bitwise, dtypes
    included (the int32 frame count); a carry without keeps ba None."""
    world, tcfg, _ = _world_cfgs()
    left, right, _ = world.render(0)
    gp, gm = pipeline._grid_for(tcfg, "cpu")
    args = (torch.from_numpy(left), torch.from_numpy(right), gp, gm, tcfg.seed)
    for cfg in (tcfg, tcfg.replace(ba_enabled=False)):
        carry = step.init_carry(*args, cfg)
        path = str(tmp_path / f"carry_{cfg.ba_enabled}.npz")
        checkpoint.save_pytree(path, {"carry": carry}, {"n": 1})
        like = step.init_carry(*args, cfg)
        like = like._replace(track=like.track._replace(pts3d=torch.zeros_like(like.track.pts3d)))
        got, meta = checkpoint.load_pytree(path, {"carry": like})
        got = got["carry"]
        assert meta == {"n": 1}
        assert (got.ba is None) == (not cfg.ba_enabled)
        assert got.key == carry.key and got.frame_idx == carry.frame_idx
        for part in ("track", "keyframes") + (("ba",) if cfg.ba_enabled else ()):
            for x, y in zip(getattr(got, part), getattr(carry, part)):
                assert x.dtype == y.dtype and torch.equal(x, y), part
    with pytest.raises(ValueError):  # a BA checkpoint does not load into a non-BA carry
        checkpoint.load_pytree(str(tmp_path / "carry_True.npz"), {"carry": like})


def test_stereo_slam_with_ba_resumes_bitwise(tmp_path):
    """StereoSLAM under preset_ba() checkpointed after frame 40 and resumed
    in a fresh object gives the uninterrupted run's poses, keyframes and
    BA window bit for bit."""
    from ros_stereo_slam_tpu_torch.models import slam

    world, tcfg, _ = _world_cfgs()
    world = small_world(n_frames=48, seed=21)
    frames = [world.render(i)[:2] for i in range(48)]
    ckpt, save_at = str(tmp_path / "ba.npz"), 40

    def start():
        s = slam.StereoSLAM(tcfg, device="cpu")
        s.initialize(*frames[0])
        return s

    full = start()
    for i in range(1, 48):
        full.process_frame(*frames[i])
        if i == save_at:
            full.save_checkpoint(ckpt)
    resumed = start()
    resumed.load_checkpoint(ckpt)
    assert resumed.frame_count == save_at + 1 and resumed._carry.ba is not None
    for i in range(save_at + 1, 48):
        resumed.process_frame(*frames[i])
    assert not full.tracking_failed and len(full.keyframe_frames) > 2
    np.testing.assert_array_equal(resumed.trajectory_array(), full.trajectory_array())
    assert resumed.keyframe_frames == full.keyframe_frames
    for part in ("keyframes", "ba", "track"):
        for x, y in zip(getattr(resumed._carry, part), getattr(full._carry, part)):
            assert torch.equal(x, y), part
