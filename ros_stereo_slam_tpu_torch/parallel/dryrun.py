"""Dry run of every multi-rank path on a mesh.

    python -m ros_stereo_slam_tpu_torch.parallel.dryrun [--ranks D] [--device cuda|cpu]
    torchrun --nproc-per-node D -m ros_stereo_slam_tpu_torch.parallel.dryrun

Without ``torchrun`` it starts D ranks itself (a file store in a temporary
directory).  On the card each rank needs a GPU of its own (NCCL); ``--device
cpu`` runs the ranks on gloo.  The steps, those of the JAX package's
``__graft_entry__.dryrun_multichip``:

1. the points-sharded odometry step
   (:func:`.dist_frontend.odometry_step_sharded`, one small world's frames
   0 -> 1 after the single-device stereo bootstrap, a multiple of D
   points) against the single call on every rank: the same counts and
   inliers, the pose within ``ODO_ATOL``, and bit for bit at world size 1;
2. landmark-sharded BA (:func:`.dist_ba.ba_solve_sharded`);
3. edge-sharded PGO (:func:`.dist_pgo.optimize_sharded`);
4. chain-sharded PGO against the edge-sharded result (atol 1e-3);
5. the sharded keyframe store and its block-local rewrite (the blocks,
   gathered, bitwise the whole store's rewrite);
6. fleet lanes over the ranks: rank d runs lanes ``[d*B/D, (d+1)*B/D)``
   of a B-lane batch through ``step_batched.run_sequence_batched``, each
   lane's generators keyed by its global index
   (``step_batched.lane_keys(seed, B)[b]``), so every lane is the
   unsharded run's.

:func:`run` returns each step's results (this rank's), which the tests
hold against the single-device calls and the JAX package.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from ros_stereo_slam_tpu_torch.config import FrontendConfig, preset_distributed, preset_odometry
from ros_stereo_slam_tpu_torch.data.synthetic import small_world
from ros_stereo_slam_tpu_torch.models import frontend, pose_graph, step, step_batched
from ros_stereo_slam_tpu_torch.models.pipeline import _grid_for
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore
from ros_stereo_slam_tpu_torch.parallel import dist_ba, dist_frontend, dist_map, dist_pgo
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, all_gather, mesh_from_config
from ros_stereo_slam_tpu_torch.utils import lie
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

LANES_PER_RANK = 1
LANE_FRAMES = 2
ODO_POINTS = 512  # grid slots of the odometry step, rounded up to a multiple of D
ODO_SEED = 1
ODO_ATOL = 1e-5


def odometry_inputs(cfg, left0, right0, left1, device, seed: int = 0) -> tuple:
    """odometry_step's inputs for frames 0 -> 1: both left pyramids and
    the track of frame 0's single-device stereo bootstrap (identity pose,
    the generator seeded with `seed`), and the camera."""
    fe, c = cfg.frontend, cfg.camera
    ref_pyr, right_pyr, cur_pyr = (frontend.preprocess(torch.as_tensor(im).to(device),
                                                       fe.lk_levels)
                                   for im in (left0, right0, left1))
    gp, gm = _grid_for(cfg, device)
    cam = Pinhole(c.fx, c.fy, c.cx, c.cy)
    track, _ = frontend.stereo_bootstrap(
        ref_pyr, right_pyr, gp, gm, torch.eye(4, device=device),
        torch.Generator(device=device).manual_seed(seed), cam, c.baseline,
        cfg.keyframes.max_depth, fe)
    return ref_pyr, cur_pyr, track, cam


def odometry_problem(D: int, device) -> tuple:
    """The config and :func:`odometry_inputs` of one small world's frames
    0 -> 1, with ODO_POINTS grid slots rounded up to a multiple of D."""
    world = small_world(n_frames=2, seed=9)
    fe = FrontendConfig(grid_step=16, max_points=-(-ODO_POINTS // D) * D)
    cfg = preset_odometry().replace(camera=world.camera, frontend=fe)
    (l0, r0, _), (l1, _, _) = world.render(0), world.render(1)
    return cfg, odometry_inputs(cfg, l0, r0, l1, device)


def run_odometry(mesh: Mesh | None, cfg, inputs: tuple):
    """The odometry step on `inputs` (:func:`odometry_inputs`), points-sharded
    over `mesh` or, with None, the single call; the generator seeded with
    ODO_SEED."""
    ref_pyr, cur_pyr, track, cam = inputs
    gen = torch.Generator(device=track.pts2d.device).manual_seed(ODO_SEED)
    args = (ref_pyr, cur_pyr, track, gen, cam, cfg.pnp.thresh_px, cfg.frontend, cfg.pnp)
    if mesh is None:
        return frontend.odometry_step(*args)
    return dist_frontend.odometry_step_sharded(mesh, *args)


def ba_problem(W: int, N: int, seed: int, device) -> tuple:
    """A window of W poses 0.5 m apart along x looking at N landmarks 5-14 m
    ahead, observations with 0.3 px of noise; the first two poses fixed."""
    rng = np.random.default_rng(seed)
    cam = Pinhole(500.0, 500.0, 320.0, 240.0)
    X = np.stack([rng.uniform(-6, 6, N), rng.uniform(-3, 3, N), rng.uniform(5, 14, N)], 1)
    T = np.tile(np.eye(4), (W, 1, 1))
    T[:, 0, 3] = -0.5 * np.arange(W)
    p = np.einsum("wij,nj->wni", T[:, :3, :3], X) + T[:, None, :3, 3]
    obs = p[..., :2] / p[..., 2:] * 500.0 + [320.0, 240.0] + rng.normal(0, 0.3, (W, N, 2))
    X_pert = X + rng.normal(0, 0.05, X.shape)
    fixed = np.arange(W) < 2
    f32 = dict(dtype=torch.float32, device=device)
    return (cam, torch.tensor(T, **f32), torch.tensor(X_pert, **f32), torch.tensor(obs, **f32),
            torch.ones((W, N), dtype=torch.bool, device=device),
            torch.tensor(fixed, device=device))


def chain_problem(F: int, device) -> tuple:
    """F poses 1 m apart along z, odometry edges of 1 m, one loop edge
    (F - 2 -> 0) and F - 1 poses in use: optimize's arguments."""
    f32 = dict(dtype=torch.float32, device=device)
    poses = torch.eye(4, **f32).repeat(F, 1, 1)
    poses[:, 2, 3] = torch.arange(F, **f32)
    odo_Z = lie.make_se3(torch.eye(3, **f32), torch.tensor([0.0, 0.0, 1.0], **f32))
    L = 8
    loop_i = torch.zeros(L, dtype=torch.int32, device=device)
    loop_i[0] = F - 2
    loop_valid = torch.zeros(L, dtype=torch.bool, device=device)
    loop_valid[0] = True
    return (poses, F - 1, odo_Z.repeat(F, 1, 1), loop_i, torch.zeros_like(loop_i),
            torch.eye(4, **f32).repeat(L, 1, 1), loop_valid)


def circle_problem(F: int, L: int, n: int, loops, device, seed: int = 3) -> tuple:
    """A circle of n poses (radius 10 m) with drifted odometry (2 mm and
    0.2 mrad of noise a step) in F slots, and `loops` as loop edges (of L
    slots) measured from the true circle: optimize's arguments."""
    th = 2 * np.pi * np.arange(n) / (n - 1)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, 0, 0] = gt[:, 2, 2] = np.cos(th)
    gt[:, 0, 2], gt[:, 2, 0] = np.sin(th), -np.sin(th)
    gt[:, 0, 3], gt[:, 2, 3] = 10 * np.sin(th), 10 * (1 - np.cos(th))
    rng = np.random.default_rng(seed)
    noise = np.concatenate([rng.normal(0, 2e-3, (n, 3)), rng.normal(0, 2e-4, (n, 3))], 1)
    dn = lie.exp_se3(torch.from_numpy(noise)).numpy()
    est = gt.copy()
    for i in range(1, n):
        est[i] = est[i - 1] @ np.linalg.inv(gt[i - 1]) @ gt[i] @ dn[i]
    poses = np.tile(np.eye(4), (F, 1, 1))
    poses[:n] = est
    odo_Z = np.tile(np.eye(4), (F, 1, 1))
    odo_Z[1:n] = np.linalg.inv(est[:-1]) @ est[1:]
    loop_i, loop_j = np.zeros(L, np.int32), np.zeros(L, np.int32)
    loop_Z = np.tile(np.eye(4), (L, 1, 1))
    loop_valid = np.zeros(L, bool)
    for k, (i, j) in enumerate(loops):
        loop_i[k], loop_j[k], loop_valid[k] = i, j, True
        loop_Z[k] = np.linalg.inv(gt[i]) @ gt[j]

    def t(a):
        return torch.from_numpy(a.astype(np.float32) if a.dtype == np.float64 else a).to(device)

    return t(poses), n, t(odo_Z), t(loop_i), t(loop_j), t(loop_Z), t(loop_valid)


def lanes_problem(n_lanes: int, device):
    """B lanes of one small world's frames 1..LANE_FRAMES (the JAX dry
    run's), the config, and frame 0."""
    world = small_world(n_frames=LANE_FRAMES + 1, seed=9, scale=4)
    cfg = preset_odometry().replace(
        camera=world.camera,
        frontend=FrontendConfig(grid_step=16, max_points=256, lk_levels=2, lk_iters=4,
                                fmat_iters=64))
    frames = [world.render(i)[:2] for i in range(LANE_FRAMES + 1)]
    L = torch.from_numpy(np.stack([f[0] for f in frames])).to(device)
    R = torch.from_numpy(np.stack([f[1] for f in frames])).to(device)
    return cfg, L.expand(n_lanes, -1, -1, -1), R.expand(n_lanes, -1, -1, -1)


def run_lanes(cfg, L, R, lanes: range, n_lanes: int):
    """Lanes `lanes` of an `n_lanes` batch, each keyed by its global index."""
    keys = step_batched.lane_keys(cfg.seed, n_lanes)
    gp, gm = _grid_for(cfg, L.device)
    sel = slice(lanes.start, lanes.stop)
    carry = step.init_carry_batched(L[sel, 0], R[sel, 0], gp, gm, [keys[b] for b in lanes], cfg)
    return step_batched.run_sequence_batched(L[sel, 1:], R[sel, 1:], carry, gp, gm, cfg)


def _check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dry run: {msg}")


def run(mesh: Mesh) -> dict:
    """Every step on this rank; raises RuntimeError on a failed check."""
    D, dev = mesh.size, mesh.device
    out = {}

    # 1) points-sharded odometry step, against the single call
    cfg, inputs = odometry_problem(D, dev)
    odo = run_odometry(mesh, cfg, inputs)
    one = run_odometry(None, cfg, inputs)
    blk = slice(mesh.rank * odo.mask.shape[0], (mesh.rank + 1) * odo.mask.shape[0])
    _check(bool(torch.isfinite(odo.T_wc).all()), "non-finite pose from the sharded step")
    _check(int(odo.n_inliers) == int(one.n_inliers) > 0
           and int(odo.n_tracked) == int(one.n_tracked)
           and torch.equal(odo.mask, one.mask[blk]) and torch.equal(odo.tracked, one.tracked[blk]),
           "the sharded odometry step's inliers differ from the single call's")
    diff = float((odo.T_cw - one.T_cw).abs().max())
    _check(diff == 0.0 if D == 1 else diff <= ODO_ATOL,
           f"the sharded odometry pose {diff} from the single call's")
    out.update(odo_T_cw=odo.T_cw, odo_tracked=odo.tracked, odo_mask=odo.mask,
               odo_n_inliers=odo.n_inliers, odo_n_tracked=odo.n_tracked)

    # 2) landmark-sharded BA
    res = dist_ba.ba_solve_sharded(mesh, *ba_problem(4, 64 * D, 1, dev), iters=2)
    _check(bool(torch.isfinite(res.T_cw).all() & torch.isfinite(res.landmarks).all()),
           "non-finite BA result")
    out.update(ba_T_cw=res.T_cw, ba_landmarks=res.landmarks, ba_rms=res.rms_after)

    # 3) edge-sharded PGO
    F = max(16, 2 * D)
    F = -(-F // D) * D
    args = chain_problem(F, dev)
    edge = dist_pgo.optimize_sharded(mesh, *args, iters=2, cg_iters=16)
    _check(bool(torch.isfinite(edge).all()), "non-finite edge-sharded PGO")

    # 4) chain-sharded PGO (O(F/D) per rank) against the edge-sharded result
    blk = dist_pgo.optimize_chain_sharded(mesh, *args, iters=2, cg_iters=16)
    _check(blk.shape == (F // D, 4, 4), f"chain-sharded block {tuple(blk.shape)}")
    chain = all_gather(blk, mesh)
    diff = float((chain - edge).abs().max())
    _check(diff <= 1e-3, f"chain-sharded PGO {diff} from the edge-sharded")
    out.update(pgo_edge=edge, pgo_chain=chain)

    # 5) the sharded store and its block-local rewrite
    K = 2 * D
    kf = KeyframeStore.empty(K, 32, dev)
    g = torch.Generator().manual_seed(3)
    kf = kf._replace(points=(5 * torch.randn((K, 32, 3), generator=g)).to(dev),
                     frame_idx=torch.arange(K, dtype=torch.int32, device=dev) % F,
                     valid=torch.ones(K, dtype=torch.bool, device=dev))
    sh = dist_map.shard_keyframes(mesh, kf)
    _check(sh.points.shape[0] == K // D, f"{sh.points.shape[0]} keyframe slots on a rank")
    pts = dist_map.rewrite_points_sharded(sh.points, sh.frame_idx, args[0], chain)
    whole = pose_graph.rewrite_points(kf.points, kf.frame_idx, args[0], chain)
    _check(torch.equal(all_gather(pts, mesh), whole),
           "the sharded rewrite differs from the whole store's")
    out.update(rewrite=pts)

    # 6) fleet lanes over the ranks
    B = LANES_PER_RANK * D
    cfg, L, R = lanes_problem(B, dev)
    lanes = range(mesh.rank * LANES_PER_RANK, (mesh.rank + 1) * LANES_PER_RANK)
    carry, stats = run_lanes(cfg, L, R, lanes, B)
    _check(carry.T_wc.shape == (LANES_PER_RANK, 4, 4), f"lanes {tuple(carry.T_wc.shape)}")
    _check(bool(torch.isfinite(stats.T_wc).all()), "non-finite lane poses")
    out.update(lanes_T_wc=stats.T_wc, lanes_is_kf=stats.is_keyframe)
    return {k: v.cpu().numpy() for k, v in out.items()}


def _rank_main(rank: int, world: int, local: int, init: str, device: str) -> None:
    dev = torch.device(f"cuda:{local}" if device == "cuda" else "cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init,
                            rank=rank, world_size=world)
    try:
        mesh = mesh_from_config(preset_distributed(world).parallel, dev)
        run(mesh)
        print(f"rank {rank}/{world}: dry run ok", flush=True)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: every GPU, or 4 on the CPU)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if "RANK" in os.environ:  # started by torchrun: one rank per process
        _rank_main(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   int(os.environ.get("LOCAL_RANK", 0)), "env://", args.device)
        return 0
    n = args.ranks or (torch.cuda.device_count() if args.device == "cuda" else 4)
    if args.device == "cuda" and not 0 < n <= torch.cuda.device_count():
        print(f"{n} ranks need {n} GPUs, {torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, r, f"file://{tmp}/store", args.device))
                 for r in range(n)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        codes = [p.exitcode for p in procs]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if any(c != 0 for c in codes):
        print(f"dry run failed: rank exit codes {codes}", file=sys.stderr)
        return 1
    print(f"dry run ok on {n} {args.device} ranks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
