"""One rank of the multi-rank cases of tests/test_torch_parallel.py.

    python tests/torch_parallel_ranks.py RANK WORLD DIR

Joins a gloo group of WORLD ranks through a file store in DIR, runs every
case on ``DIR/inputs.npz`` (written by the test) through the port's
sharded functions, and writes this rank's results to ``DIR/rank<RANK>.npz``.
At world size 1 it also writes the single-device calls on the same inputs
(``single_*``), so that the test can hold the two bit for bit within one
process.  Imports torch and the port, never JAX.
"""

from __future__ import annotations

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from ros_stereo_slam_tpu_torch.config import (  # noqa: E402
    FrontendConfig, KeyframeConfig, PGOConfig, PipelineConfig, PnPConfig, preset_odometry,
)
from ros_stereo_slam_tpu_torch.data.synthetic import small_world  # noqa: E402
from ros_stereo_slam_tpu_torch.models import (  # noqa: E402
    bundle_adjust, frontend, pose_graph, slam,
)
from ros_stereo_slam_tpu_torch.models.slam import StereoSLAM  # noqa: E402
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore, TrackState  # noqa: E402
from ros_stereo_slam_tpu_torch.ops import ransac  # noqa: E402
from ros_stereo_slam_tpu_torch.parallel import (  # noqa: E402
    dist_ba, dist_frontend, dist_map, dist_pgo, dryrun,
)
from ros_stereo_slam_tpu_torch.parallel.mesh import COLLECTIVES, make_mesh, psum  # noqa: E402
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole  # noqa: E402

# (input prefix, iters, cg_iters) of each PGO case
PGO_CASES = {"edge_small": ("pgo_one", 5, 48), "edge_close": ("pgo_one", 10, 64),
             "chain_small": ("pgo_two", 5, 48), "chain_big": ("pgo_big", 3, 32)}
SLAM_FRAMES = 8
SLAM_CKPT_AT = 4
# The closure case: a ring of WRAP_K slots (one a rank at D = 4) and
# WRAP_CLOSURES corrections at the last frame, so that the keyframe count
# passes WRAP_K and the ring wraps across the ranks.
WRAP_K = 4
WRAP_CLOSURES = 3
# The points-sharded odometry step: tests/test_torch_pnp.py's frames,
# config and PnP gate; the generator's seed.
ODO_PNP_PX = 2.0
ODO_SEED = 1


def slam_config(world, max_keyframes: int = 16):
    """tests/test_parallel.py's StereoSLAM configuration."""
    return preset_odometry().replace(
        camera=world.camera,
        frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=max_keyframes, min_pnp_inliers=150,
                                 map_block_points=1024),
        pgo=PGOConfig(max_poses=64, max_loop_edges=8, iters=5, cg_iters=48),
    )


def wrap_corrections(s: StereoSLAM, frames, new_poses, old_poses):
    """WRAP_CLOSURES pose-graph corrections of `s`'s carry after its last
    frame (``slam.corrected_carry`` as a closure applies it, on this rank's
    block of the ring): each rewrites the map and re-inserts the frame."""
    carry, right = s._carry, s._frame(frames[-1][1])
    for _ in range(WRAP_CLOSURES):
        carry = slam.corrected_carry(carry, new_poses, old_poses, right, s.grid_pts,
                                     s.grid_mask, s.config, shard=s._kf_shard)
    return carry


def slam_frames():
    world = small_world(n_frames=SLAM_FRAMES, seed=5)
    return world, [world.render(i)[:2] for i in range(SLAM_FRAMES)]


def _pgo_args(z, p):
    t = {k: torch.from_numpy(z[f"{p}_{k}"]) for k in
         ("poses", "odo_Z", "loop_i", "loop_j", "loop_Z", "loop_valid")}
    return (t["poses"], int(z[f"{p}_n"]), t["odo_Z"], t["loop_i"], t["loop_j"], t["loop_Z"],
            t["loop_valid"])


def _slam_run(cfg, frames, mesh, ckpt: Path | None = None):
    s = StereoSLAM(cfg, mesh=mesh, device="cpu")
    s.initialize(*frames[0])
    traj = [np.eye(4, dtype=np.float32)]
    for i, (left, right) in enumerate(frames[1:], start=1):
        traj.append(s.process_frame(left, right).T_wc)
        if ckpt is not None and i == SLAM_CKPT_AT:
            s.save_checkpoint(str(ckpt))
    return s, np.stack(traj)


def odometry_setup(f: dict) -> tuple:
    """odometry_step's arguments but the generator, from the inputs' odo_*
    arrays (frames 0 and 1 and the JAX bootstrap's track)."""
    fe, pc = PipelineConfig().frontend, PnPConfig()
    ref, cur = (frontend.preprocess(f[k], fe.lk_levels) for k in ("odo_left0", "odo_left1"))
    track = TrackState(f["odo_pts2d"], f["odo_pts3d"], f["odo_colors"], f["odo_mask"])
    return ref, cur, track, Pinhole(*(float(v) for v in f["odo_cam"])), ODO_PNP_PX, fe, pc


def _feed(*sets):
    """A draw that hands out the given index sets in order."""
    it = iter(sets)
    return lambda mask, k_hyp, m: next(it).long()


def _odo(prefix: str, o) -> dict:
    return {f"{prefix}_{k}": getattr(o, k) for k in ("T_cw", "tracked", "mask", "n_tracked",
                                                      "n_inliers")}


def odometry_cases(mesh, f: dict) -> dict:
    """The points-sharded step from ODO_SEED's generator (with the
    collectives it made), the same step drawing through a recorder (its
    draws checked equal on every rank), and the step on the JAX sets."""
    ref, cur, track, *rest = odometry_setup(f)
    before = COLLECTIVES.copy()
    o = dist_frontend.odometry_step_sharded(mesh, ref, cur, track,
                                            torch.Generator().manual_seed(ODO_SEED), *rest)
    used = COLLECTIVES - before
    out = _odo("odo", o)
    out.update(odo_all_gather=torch.tensor(used["all_gather"]),
               odo_all_reduce=torch.tensor(used["all_reduce"]),
               odo_other=torch.tensor(sum(used.values()) - used["all_gather"]
                                      - used["all_reduce"]))
    gen, sets = torch.Generator().manual_seed(ODO_SEED), []

    def record(m, k_hyp, n):
        sets.append(ransac._sample_minimal_sets(gen, m, k_hyp, n))
        return sets[-1]

    rec = dist_frontend.odometry_from_sets_sharded(mesh, ref, cur, track, record, *rest)
    out["odo_recorded_same"] = torch.tensor(all(torch.equal(a, b) for a, b in
                                                zip(rec, o, strict=True)))
    own = sum((s * torch.arange(1, s.numel() + 1).view(s.shape)).sum() for s in sets)
    out.update(odo_n_sets=torch.tensor(len(sets)),
               odo_draws_equal=psum(own, mesh) == mesh.size * own)
    j = dist_frontend.odometry_from_sets_sharded(mesh, ref, cur, track,
                                                 _feed(f["odo_fidx"], f["odo_pidx"]), *rest)
    out.update(_odo("odo_j", j))
    return out


def run_cases(mesh, d: Path) -> dict:
    z = np.load(d / "inputs.npz")
    out = {}
    f = {k: torch.from_numpy(z[k]) for k in z.files}
    cam = Pinhole(*(float(v) for v in z["ba_cam"]))
    ba_args = (cam, f["ba_T"], f["ba_X"], f["ba_obs"], f["ba_mask"], f["ba_fixed"])
    res = dist_ba.ba_solve_sharded(mesh, *ba_args, iters=5, damping=1e-4)
    out.update(ba_T_cw=res.T_cw, ba_landmarks=res.landmarks, ba_rms_before=res.rms_before,
               ba_rms_after=res.rms_after)

    for name, (p, iters, cg) in PGO_CASES.items():
        fn = dist_pgo.optimize_sharded if name.startswith("edge") else \
            dist_pgo.optimize_chain_sharded
        out[name] = fn(mesh, *_pgo_args(z, p), iters=iters, cg_iters=cg)

    rw = dist_map.shard_keyframes(mesh, KeyframeStore.empty(16, 64, "cpu")._replace(
        points=f["rw_points"], frame_idx=f["rw_idx"]))
    out["rewrite"] = dist_map.rewrite_points_sharded(rw.points, rw.frame_idx, f["rw_old"],
                                                     f["rw_new"])

    kf = KeyframeStore.empty(16, 32, "cpu")._replace(points=f["rt_points"], valid=f["rt_valid"],
                                                     count=torch.tensor(9, dtype=torch.int32))
    sh = dist_map.shard_keyframes(mesh, kf)
    back = dist_map.gather_keyframes(mesh, sh)
    out.update(rt_shard_points=sh.points, rt_shard_valid=sh.valid, rt_points=back.points,
               rt_valid=back.valid, rt_count=back.count)
    try:
        dist_map.shard_keyframes(mesh, KeyframeStore.empty(4 * mesh.size + 2, 8, "cpu"))
        out["rt_value_error"] = torch.tensor(mesh.size == 1)
    except ValueError:
        out["rt_value_error"] = torch.tensor(True)

    graph = pose_graph.PoseGraph(PGOConfig(max_poses=64, max_loop_edges=8, iters=5,
                                           cg_iters=48), device="cpu")
    poses, n, odo_Z, li, lj, lZ, lv = _pgo_args(z, "pgo_two")
    graph.initialize()
    graph.add_odometry_batch(odo_Z[1:n])
    for k in range(int(lv.sum())):
        graph.add_loop(int(li[k]), int(lj[k]), lZ[k])
    out["graph_opt"] = graph.optimize(poses, mesh=mesh)
    out["graph_path"] = torch.tensor(graph.last_path == "chain_sharded")

    world, frames = slam_frames()
    cfg = slam_config(world)
    s, traj = _slam_run(cfg, frames, mesh, d / "stream.npz")
    full = s.keyframes
    out.update(slam_traj=torch.from_numpy(traj), slam_shard_points=s._carry.keyframes.points,
               slam_count=s._carry.keyframes.count,
               **{f"slam_kf_{k}": getattr(full, k) for k in full._fields})
    out["slam_map_n"] = torch.tensor(s.save_map(str(d / f"map{mesh.rank}.ply")))
    resumed = StereoSLAM(cfg, mesh=mesh, device="cpu")
    resumed.initialize(*frames[0])
    resumed.load_checkpoint(str(d / "stream.npz"))
    for left, right in frames[SLAM_CKPT_AT + 1:]:
        resumed.process_frame(left, right)
    out["slam_resumed_traj"] = torch.from_numpy(resumed.trajectory_array())
    # StereoSLAM's closure-time call on an injected loop edge
    s.graph.add_loop(6, 0)
    out["slam_closure_opt"] = s.graph.optimize(s.trajectory_dev, mesh=mesh)
    out["slam_closure_path"] = torch.tensor(s.graph.last_path == "chain_sharded")

    # Corrections on a ring that wraps: the chain-sharded solve's poses
    # rewrite each rank's blocks, the frame lands in the global slot.
    w, _ = _slam_run(slam_config(world, WRAP_K), frames, mesh)
    w.graph.add_loop(6, 0)
    old = w.trajectory_dev
    new = w.graph.optimize(old, mesh=mesh)
    carry = wrap_corrections(w, frames, new, old)
    full = dist_map.gather_keyframes(mesh, carry.keyframes)
    out.update(wrap_old=old, wrap_new=new, wrap_T_wc=carry.T_wc,
               wrap_shard_valid=carry.keyframes.valid,
               **{f"wrap_kf_{k}": getattr(full, k) for k in full._fields})

    out.update(odometry_cases(mesh, f))
    out.update({f"dry_{k}": torch.from_numpy(v) for k, v in dryrun.run(mesh).items()})
    return out


def single_cases(d: Path) -> dict:
    """The single-device calls of the cases, on the same inputs."""
    z = np.load(d / "inputs.npz")
    f = {k: torch.from_numpy(z[k]) for k in z.files}
    out = {}
    cam = Pinhole(*(float(v) for v in z["ba_cam"]))
    res = bundle_adjust.ba_solve(cam, f["ba_T"], f["ba_X"], f["ba_obs"], f["ba_mask"],
                                 f["ba_fixed"], iters=5, damping=1e-4)
    out.update(ba_T_cw=res.T_cw, ba_landmarks=res.landmarks, ba_rms_before=res.rms_before,
               ba_rms_after=res.rms_after)
    for name, (p, iters, cg) in PGO_CASES.items():
        out[name] = pose_graph.optimize(*_pgo_args(z, p), iters=iters, cg_iters=cg)
    out["rewrite"] = pose_graph.rewrite_points(f["rw_points"], f["rw_idx"], f["rw_old"],
                                               f["rw_new"])
    world, frames = slam_frames()
    s, traj = _slam_run(slam_config(world), frames, None)
    out["slam_traj"] = torch.from_numpy(traj)
    out.update({f"slam_kf_{k}": getattr(s.keyframes, k) for k in s.keyframes._fields})
    dev = torch.device("cpu")
    res = bundle_adjust.ba_solve(*dryrun.ba_problem(4, 64, 1, dev), iters=2)
    out.update(dry_ba_T_cw=res.T_cw, dry_ba_landmarks=res.landmarks, dry_ba_rms=res.rms_after)
    args = dryrun.chain_problem(16, dev)
    out["dry_pgo_edge"] = out["dry_pgo_chain"] = pose_graph.optimize(*args, iters=2,
                                                                     cg_iters=16)
    cfg, L, R = dryrun.lanes_problem(1, dev)
    _, stats = dryrun.run_lanes(cfg, L, R, range(1), 1)
    out.update(dry_lanes_T_wc=stats.T_wc, dry_lanes_is_kf=stats.is_keyframe)
    ref, cur, track, *rest = odometry_setup(f)
    out.update(_odo("odo", frontend.odometry_step(ref, cur, track,
                                                  torch.Generator().manual_seed(ODO_SEED), *rest)))
    out.update(_odo("odo_j", frontend.odometry_from_sets(
        ref, cur, track, _feed(f["odo_fidx"], f["odo_pidx"]), *rest)))
    out.update(_odo("dry_odo", dryrun.run_odometry(None, *dryrun.odometry_problem(1, dev))))
    return out


def main(rank: int, world: int, d: Path) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{d}/store", rank=rank,
                            world_size=world, timeout=timedelta(seconds=240))
    try:
        out = run_cases(make_mesh(world, device="cpu"), d)
    finally:
        dist.destroy_process_group()
    if world == 1:
        out.update({f"single_{k}": v for k, v in single_cases(d).items()})
    np.savez(d / f"rank{rank}.npz", **{k: v.numpy() for k, v in out.items()})


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
