"""The port's multi-rank paths (config 5) against the JAX package.

Mirrors tests/test_parallel.py.  The port's ranks are processes in a gloo
group on the CPU (tests/torch_parallel_ranks.py, no JAX): one group of 4
ranks and one of 1 run every case once, side by side, and write their
results; the JAX package runs its counterparts on ``make_mesh(4)`` of the
8 virtual devices of tests/conftest.py, and the port's single-device calls
run here.  Bounds, those of tests/test_parallel.py: BA poses 1e-4,
landmarks 1e-3, RMS 1e-3; PGO 2e-3, and 5e-3 at F = 4608 (a sharded sum
rounds differently from one sum); the rewrite, the store round trip and
the lanes bitwise; StereoSLAM's trajectory 1e-3.  The points-sharded
odometry step (tests/test_torch_pnp.py's frames 0 -> 1 after JAX's stereo
bootstrap, 1,024 points): against the port's single call with the same
generator, counts, inliers and tracked points exact and the pose within
1e-5; on the minimal sets JAX draws, against JAX's stages (whose sharded
jit is its single call's), the bounds of
test_odometry_step_from_jax_sets_matches_jax.  At world size 1 every
sharded function is its single-device call bit for bit.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.parallel import dist_ba as jdist_ba
from ros_stereo_slam_tpu.parallel import dist_map as jdist_map
from ros_stereo_slam_tpu.parallel import dist_pgo as jdist_pgo
from ros_stereo_slam_tpu.parallel.mesh import make_mesh as j_make_mesh
from ros_stereo_slam_tpu_torch.config import PipelineConfig, PnPConfig
from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba
from ros_stereo_slam_tpu_torch.models import pose_graph as pg
from ros_stereo_slam_tpu_torch.models import slam
from ros_stereo_slam_tpu_torch.models.slam import StereoSLAM
from ros_stereo_slam_tpu_torch.models.state import TrackState
from ros_stereo_slam_tpu_torch.ops import lk as tlk
from ros_stereo_slam_tpu_torch.parallel import dist_frontend, dryrun
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

from test_ba import _problem
from test_pose_graph import _circle_trajectory, _drifted
from test_torch_pnp import _frontend_pair, _jax_bootstrap, _jax_odometry_after_lk

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "torch_parallel_ranks.py"
sys.path.insert(0, str(RANKS.parent))
import torch_parallel_ranks as ranks  # noqa: E402

D = 4
RANK_TIMEOUT_S = 300
BIG_N = 4500
ODO_KEY = 5  # the JAX key of test_odometry_step_from_jax_sets_matches_jax
ODO_ATOL = 1e-5


def _chain_inputs(n: int, F: int, drift: float, loops, L: int = 8, gt_loops=False):
    """tests/test_parallel.py's chains: n drifted poses of a closed circle in
    F slots, odometry from the drifted poses, loop edges `loops` (identity,
    or the ground-truth relative pose with `gt_loops`)."""
    gt = _circle_trajectory(n, closed=True)
    est = _drifted(gt, drift_per_step=drift)
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:n] = est
    odo_Z = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    for i in range(1, n):
        odo_Z[i] = np.linalg.inv(est[i - 1]) @ est[i]
    loop_i, loop_j = np.zeros(L, np.int32), np.zeros(L, np.int32)
    loop_Z = np.tile(np.eye(4, dtype=np.float32), (L, 1, 1))
    loop_valid = np.zeros(L, bool)
    for k, (i, j) in enumerate(loops):
        loop_i[k], loop_j[k], loop_valid[k] = i, j, True
        if gt_loops:
            loop_Z[k] = np.linalg.inv(gt[i]) @ gt[j]
    return dict(poses=poses, n=np.int64(n), odo_Z=odo_Z, loop_i=loop_i, loop_j=loop_j,
                loop_Z=loop_Z, loop_valid=loop_valid)


def _odometry_inputs() -> dict:
    """test_torch_pnp.py's frames 0 and 1 and JAX's stereo bootstrap of
    frame 0 (odo_*); the minimal sets JAX draws from ODO_KEY over the port's
    single-device LK mask, and JAX's stages on that LK output (odo_ref_*)."""
    d = _frontend_pair()
    (jstate_, _), _ = _jax_bootstrap(d, jax.random.PRNGKey(3))
    track = TrackState(*(torch.from_numpy(np.array(x)) for x in jstate_))
    tres = tlk.track(d["pyr_t"][0][0], d["pyr_t"][1][0], track.pts2d, None,
                     d["tfe"]._lk_params(d["fe"]))
    pres, n_trk, fidx, pidx = _jax_odometry_after_lk(
        d, jstate_, jnp.asarray(tres.points.numpy()), jnp.asarray(tres.valid.numpy()),
        jax.random.PRNGKey(ODO_KEY), PnPConfig())
    (l0, _), (l1, _) = d["frames"]
    z = dict(odo_left0=l0, odo_left1=l1, odo_cam=np.array(d["cam_t"], np.float64),
             odo_fidx=np.asarray(fidx).astype(np.int64), odo_pidx=np.asarray(pidx).astype(np.int64),
             odo_ref_T_cw=np.asarray(pres.T_cw), odo_ref_inliers=np.asarray(pres.inliers),
             odo_ref_n_inliers=np.asarray(pres.n_inliers), odo_ref_n_tracked=np.int64(n_trk),
             odo_ref_tracked=tres.points.numpy())
    z.update({f"odo_{k}": v.numpy() for k, v in track._asdict().items()})
    return z


def _inputs() -> dict:
    """tests/test_parallel.py's problems and the odometry step's inputs, as
    numpy arrays."""
    cam, T_cw, X, obs, mask = _problem(W=4, N=64, noise_px=0.3, seed=11)
    z = dict(ba_cam=np.array([float(v) for v in (cam.fx, cam.fy, cam.cx, cam.cy)]),
             ba_T=np.asarray(T_cw), ba_X=np.asarray(X), ba_obs=np.asarray(obs),
             ba_mask=np.asarray(mask), ba_fixed=np.array([True, True, False, False]))
    cases = {"pgo_one": _chain_inputs(48, 64, 0.03, [(47, 0)]),
             "pgo_two": _chain_inputs(48, 64, 0.03, [(47, 0), (40, 9)]),
             "pgo_big": _chain_inputs(BIG_N, 4608, 0.002,
                                      [(1500, 10), (3000, 1490), (4490, 2980)], gt_loops=True)}
    for p, c in cases.items():
        z.update({f"{p}_{k}": v for k, v in c.items()})
    rng = np.random.default_rng(23)
    K, Pn, F = 16, 64, 32
    old = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    old[:, 2, 3] = np.arange(F)
    new = old.copy()
    new[:, 0, 3] += rng.normal(0, 0.5, F).astype(np.float32)
    new[:, 2, 3] += rng.normal(0, 0.2, F).astype(np.float32)
    z.update(rw_points=rng.normal(0, 5, (K, Pn, 3)).astype(np.float32),
             rw_idx=rng.integers(0, F, (K,)).astype(np.int32), rw_old=old, rw_new=new)
    rng = np.random.default_rng(29)
    z.update(rt_points=rng.normal(0, 1, (16, 32, 3)).astype(np.float32),
             rt_valid=rng.random(16) > 0.5)
    z.update(_odometry_inputs())
    return z


def _spawn(world: int, d: Path) -> list:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    return [subprocess.Popen([sys.executable, str(RANKS), str(r), str(world), str(d)],
                             cwd=ROOT, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _wait(procs: list) -> None:
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=RANK_TIMEOUT_S)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks failed {bad}:\n" + "\n".join(x[-4000:] for x in logs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both groups' results: (inputs, [rank 0..3 results], world-size-1 results)."""
    z = _inputs()
    dirs = {w: tmp_path_factory.mktemp(f"ranks{w}") for w in (D, 1)}
    for d in dirs.values():
        np.savez(d / "inputs.npz", **z)
    procs = {w: _spawn(w, d) for w, d in dirs.items()}
    for w in (D, 1):
        _wait(procs[w])
    res = [dict(np.load(dirs[D] / f"rank{r}.npz")) for r in range(D)]
    return z, res, dict(np.load(dirs[1] / "rank0.npz")), dirs


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) >= D, "conftest must provide 8 virtual devices"
    return j_make_mesh(D)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cat(res, key):
    return np.concatenate([r[key] for r in res])


def _same_on_every_rank(res, key):
    for r in res[1:]:
        np.testing.assert_array_equal(r[key], res[0][key], err_msg=key)
    return res[0][key]


def _pgo(z, p):
    return (z[f"{p}_poses"], int(z[f"{p}_n"]), z[f"{p}_odo_Z"], z[f"{p}_loop_i"],
            z[f"{p}_loop_j"], z[f"{p}_loop_Z"], z[f"{p}_loop_valid"])


def _t_single(z, p, **kw):
    return pg.optimize(*(torch.from_numpy(np.asarray(a)) if isinstance(a, np.ndarray) else a
                         for a in _pgo(z, p)), **kw).numpy()


def _j(args):
    return tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else jnp.int32(a) for a in args)


def test_dist_ba_matches_single_and_jax(runs, jmesh):
    z, res, _, _ = runs
    cam = Pinhole(*z["ba_cam"])
    t_args = [torch.tensor(z[k]) for k in ("ba_T", "ba_X", "ba_obs", "ba_mask", "ba_fixed")]
    single = ba.ba_solve(cam, *t_args, iters=5, damping=1e-4)
    T = _same_on_every_rank(res, "ba_T_cw")
    X = _cat(res, "ba_landmarks")
    rms = float(_same_on_every_rank(res, "ba_rms_after"))
    assert res[0]["ba_landmarks"].shape == (64 // D, 3)
    np.testing.assert_allclose(T, single.T_cw.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(X, single.landmarks.numpy(), rtol=0, atol=1e-3)
    assert abs(rms - float(single.rms_after)) < 1e-3
    jcam, *_ = _problem(W=4, N=64, noise_px=0.3, seed=11)
    j = jdist_ba.ba_solve_sharded(jmesh, jcam, *(jnp.asarray(z[k]) for k in (
        "ba_T", "ba_X", "ba_obs", "ba_mask", "ba_fixed")), iters=5, damping=1e-4)
    np.testing.assert_allclose(T, np.asarray(j.T_cw), rtol=0, atol=1e-4)
    np.testing.assert_allclose(X, np.asarray(j.landmarks), rtol=0, atol=1e-3)
    assert abs(rms - float(j.rms_after)) < 1e-3


def test_dist_pgo_matches_single_and_jax(runs, jmesh):
    z, res, _, _ = runs
    out = _same_on_every_rank(res, "edge_small")
    np.testing.assert_allclose(out, _t_single(z, "pgo_one", iters=5, cg_iters=48), atol=2e-3)
    j = jdist_pgo.optimize_sharded(jmesh, *_j(_pgo(z, "pgo_one")), iters=5, cg_iters=48)
    np.testing.assert_allclose(out, np.asarray(j), atol=2e-3)


def test_dist_pgo_closes_loop(runs):
    z, res, _, _ = runs
    out = _same_on_every_rank(res, "edge_close")[:48]
    gt, est = _circle_trajectory(48, closed=True), z["pgo_one_poses"][:48]
    err_before = np.linalg.norm(est[-1, :3, 3] - gt[-1, :3, 3])
    err_after = np.linalg.norm(out[-1, :3, 3] - gt[-1, :3, 3])
    assert err_after < 0.3 * err_before + 1e-3


@pytest.mark.parametrize("case,prefix,iters,cg,atol", [
    ("chain_small", "pgo_two", 5, 48, 2e-3),
    ("chain_big", "pgo_big", 3, 32, 5e-3),
])
def test_chain_sharded_pgo_matches_single_and_jax(runs, jmesh, case, prefix, iters, cg, atol):
    z, res, _, _ = runs
    F = z[f"{prefix}_poses"].shape[0]
    n = int(z[f"{prefix}_n"])
    for r in res:  # O(F/D) per rank
        assert r[case].shape == (F // D, 4, 4)
    out = _cat(res, case)
    np.testing.assert_allclose(out[:n], _t_single(z, prefix, iters=iters, cg_iters=cg)[:n],
                               atol=atol)
    j = jdist_pgo.optimize_chain_sharded(jmesh, *_j(_pgo(z, prefix)), iters=iters, cg_iters=cg)
    np.testing.assert_allclose(out[:n], np.asarray(j)[:n], atol=atol)


def test_rewrite_points_sharded_bitwise(runs, jmesh):
    z, res, _, _ = runs
    assert res[0]["rewrite"].shape == (16 // D, 64, 3)
    out = _cat(res, "rewrite")
    want = pg.rewrite_points(*(torch.from_numpy(z[k]) for k in
                               ("rw_points", "rw_idx", "rw_old", "rw_new"))).numpy()
    np.testing.assert_array_equal(out, want)
    j = jdist_map.rewrite_points_sharded(jmesh, *(jnp.asarray(z[k]) for k in (
        "rw_points", "rw_idx", "rw_old", "rw_new")))
    np.testing.assert_allclose(out, np.asarray(j), rtol=0, atol=1e-5)


def test_sharded_keyframe_store_roundtrip(runs):
    z, res, _, _ = runs
    for r in res:
        assert r["rt_shard_points"].shape == (16 // D, 32, 3)
        assert r["rt_shard_valid"].shape == (16 // D,)
        np.testing.assert_array_equal(r["rt_points"], z["rt_points"])
        np.testing.assert_array_equal(r["rt_valid"], z["rt_valid"])
        assert int(r["rt_count"]) == 9
        assert bool(r["rt_value_error"])
    np.testing.assert_array_equal(_cat(res, "rt_shard_points"), z["rt_points"])


def test_pose_graph_optimize_routes_chain_sharded(runs):
    z, res, _, _ = runs
    assert all(bool(r["graph_path"]) for r in res)
    out = _same_on_every_rank(res, "graph_opt")
    np.testing.assert_allclose(out, _t_single(z, "pgo_two", iters=5, cg_iters=48), atol=2e-3)


def test_stereo_slam_mesh_matches_single(runs):
    """StereoSLAM(mesh=...) on small_world(8, seed=5): the trajectory of the
    single run, K/D blocks per rank, the gathered map the single run's, a
    checkpoint taken under the mesh resumed under it and loaded into one
    device."""
    _, res, _, dirs = runs
    world, frames = ranks.slam_frames()
    cfg = ranks.slam_config(world)
    single, traj = ranks._slam_run(cfg, frames, None)
    t = _same_on_every_rank(res, "slam_traj")
    np.testing.assert_allclose(t, traj, rtol=0, atol=1e-3)
    for r in res:
        assert r["slam_shard_points"].shape == (16 // D, 1024, 3)
        assert int(r["slam_count"]) == int(single.keyframes.count)
        np.testing.assert_array_equal(r["slam_resumed_traj"], t)
        for k in single.keyframes._fields:
            np.testing.assert_array_equal(r[f"slam_kf_{k}"], getattr(single.keyframes, k).numpy(),
                                          err_msg=k)
    pts, _ = single.map_points()
    assert all(int(r["slam_map_n"]) == len(pts) for r in res)
    assert (dirs[D] / "map0.ply").is_file()
    assert not any((dirs[D] / f"map{r}.ply").exists() for r in range(1, D))
    one = StereoSLAM(cfg, device="cpu")
    one.initialize(*frames[0])
    one.load_checkpoint(str(dirs[D] / "stream.npz"))
    for left, right in frames[ranks.SLAM_CKPT_AT + 1:]:
        one.process_frame(left, right)
    np.testing.assert_array_equal(one.trajectory_array(), t)


def test_stereo_slam_closure_routes_chain_sharded(runs):
    """StereoSLAM's closure-time call (graph.optimize(poses, mesh)) on an
    injected loop edge: chain-sharded, the single solve's result."""
    _, res, _, _ = runs
    assert all(bool(r["slam_closure_path"]) for r in res)
    out = _same_on_every_rank(res, "slam_closure_opt")
    world, frames = ranks.slam_frames()
    single, _ = ranks._slam_run(ranks.slam_config(world), frames, None)
    single.graph.add_loop(6, 0)
    want = single.graph.optimize(single.trajectory_dev)
    assert single.graph.last_path == "single"
    np.testing.assert_allclose(out[:8], want.numpy()[:8], rtol=0, atol=2e-3)


def test_closure_corrects_sharded_ring_that_wraps(runs):
    """corrected_carry on a ring of ranks.WRAP_K slots sharded over 4 ranks
    (and over 1): the keyframe count passes the ring's size, the frame
    lands on ranks with a block base > 0 and wraps to rank 0, and the
    gathered store and the pose are the single run's corrections with the
    same poses, bit for bit."""
    _, res, one, _ = runs
    world, frames = ranks.slam_frames()
    for group in (res, [one]):
        new = torch.from_numpy(_same_on_every_rank(group, "wrap_new"))
        old = torch.from_numpy(_same_on_every_rank(group, "wrap_old"))
        single, _ = ranks._slam_run(ranks.slam_config(world, ranks.WRAP_K), frames, None)
        np.testing.assert_array_equal(old.numpy(), single.trajectory_dev.numpy())
        count0 = int(single._carry.keyframes.count)
        carry = ranks.wrap_corrections(single, frames, new, old)
        kf = carry.keyframes
        assert count0 < ranks.WRAP_K < int(kf.count)
        for r in group:
            assert r["wrap_shard_valid"].shape == (ranks.WRAP_K // len(group),)
            assert r["wrap_shard_valid"].all()
            np.testing.assert_array_equal(r["wrap_T_wc"], carry.T_wc.numpy())
            for k in kf._fields:
                np.testing.assert_array_equal(r[f"wrap_kf_{k}"], getattr(kf, k).numpy(),
                                              err_msg=k)


def _odo_checks(res, one, prefix: str, atol: float) -> None:
    """The sharded step's results on every rank against the world-size-1
    group's single call: counts the same on every rank and equal, the
    blocks (N / D each) gathered equal, the pose within `atol`."""
    n = one[f"single_{prefix}_mask"].shape[0]
    for r in res:
        assert r[f"{prefix}_mask"].shape == (n // len(res),)
        assert r[f"{prefix}_tracked"].shape == (n // len(res), 2)
    for k in ("n_tracked", "n_inliers"):
        assert int(_same_on_every_rank(res, f"{prefix}_{k}")) == int(one[f"single_{prefix}_{k}"])
    np.testing.assert_array_equal(_cat(res, f"{prefix}_mask"), one[f"single_{prefix}_mask"])
    np.testing.assert_array_equal(_cat(res, f"{prefix}_tracked"),
                                  one[f"single_{prefix}_tracked"])
    np.testing.assert_allclose(_same_on_every_rank(res, f"{prefix}_T_cw"),
                               one[f"single_{prefix}_T_cw"], rtol=0, atol=atol)


def test_odometry_sharded_matches_single(runs):
    """odometry_step_sharded at D = 4 against the port's odometry_step
    with the same generator seed; every rank drew the same minimal sets
    (two draws: the F-gate's, then PnP's); the step made 2 all_gathers and
    3 + 2 x refine_iters all-reduces, at D = 4 and at D = 1."""
    _, res, one, _ = runs
    _odo_checks(res, one, "odo", ODO_ATOL)
    assert int(one["single_odo_n_inliers"]) > 100
    for r in res + [one]:
        assert bool(r["odo_draws_equal"]) and int(r["odo_n_sets"]) == 2
        assert bool(r["odo_recorded_same"])
        assert int(r["odo_all_gather"]) == 2 and int(r["odo_other"]) == 0
        assert int(r["odo_all_reduce"]) == 3 + 2 * PnPConfig().refine_iters


def test_odometry_sharded_from_jax_sets_matches_jax(runs):
    """odometry_from_sets_sharded at D = 4 on the minimal sets JAX draws
    over the port's LK output, against JAX's stages on that output: equal
    tracked and inlier sets and counts, pose within 1e-4 / 1e-3 m; and the
    port's single call on the same sets."""
    z, res, one, _ = runs
    _odo_checks(res, one, "odo_j", ODO_ATOL)
    np.testing.assert_array_equal(_cat(res, "odo_j_tracked"), z["odo_ref_tracked"])
    assert int(_same_on_every_rank(res, "odo_j_n_tracked")) == int(z["odo_ref_n_tracked"]) > 100
    assert int(_same_on_every_rank(res, "odo_j_n_inliers")) == int(z["odo_ref_n_inliers"])
    np.testing.assert_array_equal(_cat(res, "odo_j_mask"), z["odo_ref_inliers"])
    T, Tj = _same_on_every_rank(res, "odo_j_T_cw"), z["odo_ref_T_cw"]
    np.testing.assert_allclose(T[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(T[:3, 3], Tj[:3, 3], atol=1e-3)


def test_jax_points_sharded_odometry_is_its_single_call(runs, jmesh):
    """The reference itself: JAX's odometry_step under jax.jit with the
    points sharded over 4 devices, as __graft_entry__.dryrun_multichip's
    step 1 shards it, against the same jit unsharded.  XLA's partitioner
    sums over points in another order, so the JAX call is its single call
    only to the port-vs-JAX bounds: equal counts, at most 2 of the 1,024
    inlier flags differ (2 here: points the F-gate keeps in one call and
    drops in the other), rotation within 1e-4, translation within 1e-3 m
    (2.7e-5 and 4.4e-4 here).  The port's sharded step keeps every float32
    decision replicated and is its single call's to 1e-5 with no flag
    changed (test_odometry_sharded_matches_single)."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ros_stereo_slam_tpu.config import PipelineConfig as JPipelineConfig
    from ros_stereo_slam_tpu.config import PnPConfig as JPnPConfig
    from ros_stereo_slam_tpu.models import frontend as jfe
    from ros_stereo_slam_tpu.models.state import TrackState as JTrackState
    from ros_stereo_slam_tpu.utils.camera import Pinhole as JPinhole

    z = runs[0]
    fe = JPipelineConfig().frontend
    cam = JPinhole(*(jnp.float32(v) for v in z["odo_cam"]))

    def step(ref_img, cur_img, pts2d, pts3d, mask, key):
        ref_pyr = jfe.preprocess(ref_img, fe.lk_levels)
        cur_pyr = jfe.preprocess(cur_img, fe.lk_levels)
        track = JTrackState(pts2d=pts2d, pts3d=pts3d, colors=jnp.zeros_like(pts3d), mask=mask)
        out = jfe.odometry_step(ref_pyr, cur_pyr, track, key, cam,
                                jnp.float32(ranks.ODO_PNP_PX), fe, JPnPConfig())
        return out.T_wc, out.n_inliers, out.mask, out.n_tracked

    rep, pts_sh = NamedSharding(jmesh, P()), NamedSharding(jmesh, P("shard"))
    args = (z["odo_left0"], z["odo_left1"], z["odo_pts2d"], z["odo_pts3d"], z["odo_mask"],
            jax.random.PRNGKey(ODO_KEY))
    sharded = jax.jit(step, in_shardings=(rep, rep, pts_sh, pts_sh, pts_sh, rep),
                      out_shardings=(rep, rep, pts_sh, rep))
    got = sharded(*(jax.device_put(jnp.asarray(a), sh) for a, sh in
                    zip(args, (rep, rep, pts_sh, pts_sh, pts_sh, rep))))
    want = jax.jit(step)(*(jnp.asarray(a) for a in args))
    assert int(got[1]) == int(want[1]) > 100 and int(got[3]) == int(want[3])
    assert int((np.asarray(got[2]) != np.asarray(want[2])).sum()) <= 2
    T, Tj = np.linalg.inv(np.asarray(got[0])), np.linalg.inv(np.asarray(want[0]))
    np.testing.assert_allclose(T[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(T[:3, 3], Tj[:3, 3], atol=1e-3)


@pytest.mark.parametrize("case", ["not_a_mesh", "indivisible"])
def test_odometry_sharded_rejects(runs, case):
    """A non-Mesh raises TypeError; N = 1,024 points on 3 ranks raise
    ValueError (shard_bounds: no padding path), before any collective."""
    f = {k: torch.from_numpy(np.array(v)) for k, v in runs[0].items() if k.startswith("odo_")}
    ref, cur, track, *rest = ranks.odometry_setup(f)
    mesh, exc = ((object(), TypeError) if case == "not_a_mesh"
                 else (Mesh(rank=0, size=3, device=torch.device("cpu")), ValueError))
    with pytest.raises(exc):
        dist_frontend.odometry_step_sharded(mesh, ref, cur, track, torch.Generator(), *rest)


def test_dryrun_at_four_ranks(runs):
    """The dry run's steps on 4 ranks; its odometry step is the single
    call's (counts and inliers exact, pose within 1e-5), its lanes are the
    unsharded B-lane run's bit for bit, its BA and PGO the single-device
    calls'."""
    _, res, _, _ = runs
    dev = torch.device("cpu")
    one = dryrun.run_odometry(None, *dryrun.odometry_problem(D, dev))
    single = {f"single_dry_odo_{k}": getattr(one, k).numpy() for k in one._fields}
    _odo_checks(res, single, "dry_odo", dryrun.ODO_ATOL)
    single = ba.ba_solve(*dryrun.ba_problem(4, 64 * D, 1, dev), iters=2)
    np.testing.assert_allclose(_same_on_every_rank(res, "dry_ba_T_cw"), single.T_cw.numpy(),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(_cat(res, "dry_ba_landmarks"), single.landmarks.numpy(),
                               rtol=0, atol=1e-3)
    want = pg.optimize(*dryrun.chain_problem(16, dev), iters=2, cg_iters=16).numpy()
    for key in ("dry_pgo_edge", "dry_pgo_chain"):
        np.testing.assert_allclose(_same_on_every_rank(res, key), want, rtol=0, atol=2e-3)
    cfg, L, R = dryrun.lanes_problem(D, dev)
    _, stats = dryrun.run_lanes(cfg, L, R, range(D), D)
    np.testing.assert_array_equal(np.concatenate([r["dry_lanes_T_wc"] for r in res], axis=1),
                                  stats.T_wc.numpy())
    np.testing.assert_array_equal(np.concatenate([r["dry_lanes_is_kf"] for r in res], axis=1),
                                  stats.is_keyframe.numpy())


@pytest.mark.parametrize("key", [
    "ba_T_cw", "ba_landmarks", "ba_rms_before", "ba_rms_after", "edge_small", "edge_close",
    "chain_small", "chain_big", "rewrite", "slam_traj", "dry_ba_T_cw", "dry_ba_landmarks",
    "dry_pgo_edge", "dry_pgo_chain", "dry_lanes_T_wc",
    *(f"{p}_{k}" for p in ("odo", "odo_j", "dry_odo")
      for k in ("T_cw", "tracked", "mask", "n_tracked", "n_inliers")),
])
def test_world_size_one_is_single_bitwise(runs, key):
    _, _, one, _ = runs
    np.testing.assert_array_equal(one[key], one[f"single_{key}"])


def test_world_size_one_store_and_routes(runs):
    """At world size 1 the store is whole, the gathered map is the single
    run's, and PoseGraph.optimize takes the single path."""
    _, _, one, _ = runs
    assert one["slam_shard_points"].shape == (16, 1024, 3)
    for k in ("poses", "frame_idx", "points", "colors", "point_mask", "retrack", "valid"):
        np.testing.assert_array_equal(one[f"slam_kf_{k}"], one[f"single_slam_kf_{k}"])
    assert not bool(one["graph_path"]) and not bool(one["slam_closure_path"])


def test_mesh_type_checked():
    cfg = PipelineConfig()
    with pytest.raises(TypeError, match="Mesh"):
        slam.StereoSLAM(cfg, device="cpu", mesh=object())
    graph = pg.PoseGraph(cfg.pgo, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        graph.optimize(torch.eye(4).repeat(8, 1, 1), mesh=object())
