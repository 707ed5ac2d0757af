#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ros_stereo_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. toolchain: the card's name and power limit, torch and its CUDA build,
   ``nvcc --version``, whether ``triton`` imports;
2. build: every kernel (K1 ``lk_level``, K2 ``orb_desc``, K3
   ``vocab_descend``) from ``csrc/``, one ``nvcc`` per source, all started
   together (timed);
3. render (host, worker processes): the bench corridor and two jittered
   two-lap revisit worlds (A, the bench's, and B, other seeds), all at
   full KITTI geometry (1241x376); phase endurance's lap then renders in
   a pool of two processes fewer than the host's CPUs while the phases
   below run;
4. vocab: the full-width vocabulary (k = 9, L = 6: 531,441 words) trained
   on the card with ``train_batched`` from every 8th revisit frame;
5. kernels: each kernel (K1, K2, K3 and the lane-gridded K1b, K2b)
   against its plain PyTorch version on the card, at the main path's
   shapes and at image borders (K1: points within a window of a border;
   K2: corners 17..21 px from each border; K3: one and two lanes'
   descriptors and a tree with tied siblings, L2-hot and L2-cold, and no
   dense descent product left in the detection step), with the median time of a
   wrapper call (CUDA events around it: ``ms``), the kernel's own time
   (200 bare launches of the C entry point back to back between two
   events, the least of 7 rounds: ``device_ms``), each launch again behind
   a spacer that keeps the queue ahead of the card (a spin, L2-hot:
   ``device_ms_spaced_hot``; a 64 MB write, L2-cold: ``device_ms_cold``),
   an empty kernel's time taken the same way (the launch floor) and the
   bound of each call's work on the card;
6. slice: the stereo-odometry path (``run_offline`` on ``cuda:0``) over the
   corridor, checked against ground truth, with K1's launch count from that
   run; then the streaming driver (``StereoOdometry``) against ``run_offline``;
7. slam: full SLAM with loop closure (``run_offline_slam`` on ``cuda:0``,
   ``preset_loop_closure()`` at its defaults) over 257 revisit frames,
   checked against ground truth, with K1/K2/K3 launch counts from that run
   (K3: one per detection frame);
8. batched_odo: the corridor split into 2 lanes of 24 frames through
   ``step_batched.run_sequence_batched`` (bench.py's batched row), each
   lane held against its single-lane run, with K1b's launch count;
9. batched_slam: ``run_offline_slam_batched`` over worlds A and B as two
   lanes, checked per lane against ground truth, with K1b/K2b/K3 counts
   (K3: one per detection frame for all lanes);
10. polish: K1 and K1b with freeze-polish (3 walk steps of 8, the JAX
    sweep's row) against their plain versions on the card at the seeded
    track's shapes and at borders, each kernel's time beside the
    walk-only run of the same 8 steps; then ``run_offline`` over the
    corridor with ``lk_seeded_iters=8, lk_seeded_walk_iters=3`` against
    ground truth (phase slice's ATE bound), its K1 launches and its fps
    beside phase slice's;
11. lane_cadences: the corridor as 2 lanes with ``batch_align_window=2``
    (every keyframe on an even ``frame_idx`` unless tracking failed; ATE
    per lane), and ``run_offline_slam_batched(interleave=True)`` over
    worlds A and B: lane 0's accepted closures are phase batched_slam's
    lane 0's, lane 1 detects on odd frames and closes at true revisits;
    K1b/K2/K2b/K3 counts (K2b only in the lockstep frame-0 detection);
12. online: the online postures over world A at the same configuration:
    ``StereoSLAM`` frame by frame (a checkpoint after frame 128 resumed in a
    fresh object, the graph and the map written and read back) and
    ``run_online_slam(chunk=32)``, speculative and sequential; both accept
    phase slam's closures, with K1/K2/K3 counts per path;
13. mapping: config 2, ``preset_mapping()`` through ``run_offline`` over the
    corridor with its RGB frames staged as uint8 (~69 MB): the trajectory
    bitwise equal to phase slice's, keyframe 0's colours equal to a host
    bilinear sample of RGB frame 0, a chromatic map, the PLY read back;
14. ba: config 4, ``preset_ba()`` (windowed Schur BA on every frame)
    through ``run_offline`` over the corridor (ATE against phase slice's),
    through ``step_batched.run_sequence_batched`` as 2 lanes (each lane
    bitwise equal to its single-lane run) and through ``StereoSLAM`` over
    world A's frames 0-255 (closures at true revisits, PGO below
    odometry-only, a checkpoint after frame 128 resumed bitwise), with BA's
    milliseconds per frame from CUDA events around ``step._ba_refine``;
15. reference_frontend: ``preset_odometry()`` with the reference's own
    frontend (FAST + ANMS keypoints, F-matrix RANSAC on the stereo and the
    temporal matches) through ``run_offline`` over the corridor;
16. orb_stereo: ORB stereo matching (K2 on both views of every keyframe)
    with the temporal F-gate through ``run_offline``, then (phase
    orb_stereo_lanes) as 2 lanes of 24 frames through
    ``run_sequence_batched`` (K1b, K2b), each lane bitwise equal to its
    single-lane run;
17. stereo_depth: the dense-disparity node on corridor pair 0 (SGBM, 96
    disparities, block 7) against the depth oracle and, on a crop, against
    the CPU run of the same function; the cloud -> SOR -> PLY flow;
18. essential: ``monocular_triangulate`` on corridor frames 0 -> 1 (LK
    tracks of the grid), and the card against the CPU on the same index
    sets, on those tracks and on exact correspondences;
19. multichip: config 5 at world size 1 (a one-rank NCCL group on
    ``cuda:0``): the points-sharded odometry step on corridor frames
    0 -> 1 (768 points; its collectives and K1 launches counted),
    landmark-sharded BA, edge- and chain-sharded PGO and the
    sharded store's rewrite and gather at full width, and
    ``StereoSLAM(preset_distributed(1), mesh=...)`` over phase ba's frames,
    each bitwise equal to its single-device call, with K1/K2/K3 launches,
    one float64 all-reduce of BA's reduced system timed, and what each
    collective and each PGO layout's Gauss-Newton step cost;
20. cli: the four command-line tools on the card.  KITTI-layout trees
    (stdlib zlib PNGs under ``build/kitti_smoke``: sequence 00 = the
    corridor's 49 frames as uint8 with ``image_2``, sequence 01 = world A's
    frames 0-255) read back through ``KittiSequence`` bitwise (the route
    printed); ``run_kitti --mode scan`` (odometry) string for string equal
    to ``run_offline`` on the same uint8 frames; ``run_kitti --mode stream
    --preset mapping`` with a chromatic map; ``build_vocab`` (k = 9, L = 6)
    from sequence 01, then ``run_kitti --preset loop_closure --mode scan``:
    closures at true revisits, carried into ``poseGraph.g2o``;
    ``run_synthetic --preset loop_closure --orbit --mode chunked``, whose
    vocabulary (``vocab.train`` on the card) equals the CPU's bitwise;
    ``python -m ...stereo_depth`` in a child that imports no JAX.  K1/K2/K3
    launches per run (``--no-plots`` where matplotlib is absent);
21. endurance: the endurance CLI's functions
    (``ros_stereo_slam_tpu_torch.tools.endurance_run``) at full width and
    reduced depth: its plain 512-pose lap (rendered in the background
    from phase render on) tiled to 1,024 frames, its k = 9,
    L = 6 vocabulary trained on the lap, ``preset_loop_closure()`` with
    detection on every frame, 192 keyframe slots and a 960-frame database
    (both rings wrap), through the scan posture: at least 4 closures, each
    at an exact revisit, post-PGO ATE below odometry-only, every frame
    tracked, K1/K2/K3 launches (K3: one per frame).

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "ros_stereo_slam_tpu_torch"

# K1 against its plain version: the bounds of the JAX package's own
# kernel-vs-oracle test (tests/test_lk_pallas.py).
K1_PTS_ATOL = 5e-3  # px
K1_RESID_ATOL = 1e-2
K1_BORDER_PX = 10.0  # compare where both results stay this far inside
K1_BORDER_INSIDE = 0.9  # share of the border case's points that stay in the image

# The slice's reference: the JAX package's run_offline on the same 48
# corridor frames, measured on a host CPU (NOT on any GPU): ATE 0.040 m,
# 22 keyframes, every frame tracked, >= 161 PnP inliers on every frame;
# ~30 s for the first call, ~1.0 s per warm run.  The port's bound allows
# 2.5x that ATE because its RANSAC draws are not JAX's random streams.
JAX_CPU_ATE_M = 0.040
ATE_BOUND_M = 0.10
FRAMES = 48  # frames after frame 0: the run the JAX numbers above describe

# Full SLAM: the bench's jittered revisit world (bench.py --world revisit
# --jitter): 256 frames after frame 0, so a lap is 128 frames and a
# revisit lies 128 frames after its first visit (> min_separation = 100).
SLAM_FRAMES = 256
LAP = (SLAM_FRAMES + 1) // 2
REVISIT_TOL = 3  # an accepted match lies within 3 frames of query - LAP
KERNELS = ("lk_level", "orb_desc", "vocab_descend")
# K2 against its plain version: bits flip only where a pair's two samples
# nearly tie (the kernel takes cos/sin from the normalized moments, the
# plain version cos(atan2)); moments differ by the f32 summation order.
# Besides the aggregate bound, no valid corner may differ in more than
# K2_MAX_CORNER_BITS of its 256 bits: a few wholly wrong descriptors
# would pass the aggregate bound alone.
K2_MIN_AGREE = 0.995
K2_MAX_CORNER_BITS = 4
K2_MOMENT_ATOL = 2e-3
K2_MOMENT_RTOL = 1e-5
WARM_RUNS = 3  # phases slice and batched_odo
# Phase polish: the seeded track with freeze-polish, the JAX sweep's row
# "seeded 8 = walk 3 + polish 5" (tools/sweep_fast.py); phase lane_cadences:
# the batched lanes' shared keyframe window.
POLISH = dict(lk_seeded_iters=8, lk_seeded_walk_iters=3)
POLISH_WARM_RUNS = 2
ALIGN_WINDOW = 2
# Batched lanes: the corridor splits into 2 lanes of FRAMES // 2 frames
# (bench.py --lanes 2); full SLAM runs the revisit worlds A and B as 2
# lanes.  A lane's poses must match its single-lane run with the same key
# within LANE_TOL_M (the bound of tests/test_batched.py).
LANES = 2
LANE_TOL_M = 1e-4
SLAM_WARM_RUNS = 1  # phases slam and batched_slam
# Revisit worlds: (plan seed, world seed); A is bench.py's.  Frame 256
# starts a third lap with a fresh jitter and brightness, a jump that some
# seed pairs leave with under 10 PnP inliers; B's pair keeps >= 44 there.
REVISIT_SEEDS = {"A": (17, 11), "B": (53, 59)}
# The online postures (phase online): warm runs per driver, the chunk, the
# frame after which the streaming run is checkpointed, and how far a
# keyframe's pose may lie from the live trajectory (test_chunked_online_driver).
ONLINE_WARM_RUNS = 1
ONLINE_CHUNK = 32
CKPT_FRAME = LAP
KF_POSE_TOL_M = 1e-4
# Configs 2 and 4 (phases mapping and ba): warm runs per path; keyframe 0's
# colours against a host bilinear sample of RGB frame 0; the ATE bound of
# BA against phase slice's (tests/test_ba_pipeline.py); StereoSLAM under
# BA runs world A's frames 0-255 (frame 256 starts a third lap that some
# runs lose, PERF.md section 7).
MAPPING_WARM_RUNS = 2
BA_WARM_RUNS = 2
COLOUR_ATOL = 1e-5
BA_SLAM_FRAMES = 255
# The frontend choices (phases reference_frontend and orb_stereo), each
# through run_offline over the corridor: the reference's own keypoints and
# gates (FAST + ANMS, F-matrix RANSAC on the stereo and the temporal
# matches), and its non-dense stereo matcher (ORB on both views) at the
# setting of tests/test_match.py, also as 2 lanes (bitwise equal to their
# single-lane runs).  The ATE bound is the odometry one: the JAX package's
# full-size runs of these frontends were not made (PERF.md section 6).
REFERENCE_FRONTEND = dict(sampler="anms", stereo_gate="fmat", fmat_gate="ransac")
ORB_STEREO = dict(stereo_matcher="orb", fmat_gate="ransac", lk_seeded_iters=10,
                  max_points=1152)
FRONTEND_WARM_RUNS = 2
# Dense disparity (phase stereo_depth) on corridor pair 0 against its
# depth, with the bounds of tests/test_sgbm.py (valid share, median error,
# bad-pixel rate over 3 px) and its border mask; the card against the CPU
# on a crop: the same valid pixels, disparities within SGBM_CROP_ATOL px.
SGBM_MAX_DISP, SGBM_BLOCK = 96, 7
SGBM_MIN_VALID, SGBM_MAX_MEDIAN_PX, SGBM_MAX_BAD = 0.20, 1.0, 0.15
SGBM_CROP = (slice(96, 224), slice(320, 704))
SGBM_CROP_ATOL = 1e-4
# Essential matrix (phase essential), corridor frames 0 -> 1 (a true
# rotation of 0.344 deg and 0.80 m forward).  On the LK tracks of the grid,
# forward motion leaves E poorly conditioned: the JAX package's own result
# moves with the key (tools/torch_essential_corridor.py), and R = I with a
# fitted t explains about as many tracks as the true pose, so the tracks
# cannot tell R from I.  There each run is held to the spread of the JAX
# package's results (a bound against gross faults), and the card to the CPU
# on the same index sets through a float64 witness: the 256 hypotheses'
# MSAC scores on the card must stray from float64 no further than the
# CPU's do (median ratio <= ESS_ROUNDING_RATIO); where the two pick
# different winners, that is rounding between near-tied scores.  On exact
# correspondences (the grid through the depth oracle) the card equals the
# CPU on the same index sets (equal inliers, R within ESS_R_ATOL, unit t
# within ESS_T_ATOL), with tests/test_essential.py's tight bound against
# ground truth, which must lie well below the true rotation (at most
# ESS_ROT_SHARE of it), so that R = I fails there.
ESS_TRACK_MIN_INLIERS, ESS_TRACK_ROT_DEG = 0.4, 1.5
ESS_ROUNDING_RATIO = 3.0
ESS_R_ATOL, ESS_T_ATOL = 1e-4, 1e-3
ESS_ROT_DEG, ESS_ROT_SHARE = 0.1, 0.5
# The card's peaks for a kernel's bound (NVIDIA's H100 SXM data sheet): HBM
# bytes/s, float32 FLOP/s outside the tensor cores, int8 OP/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_INT8_S = 1979e12
# A spin of this many cycles (~25 us) spaces the launches that
# device_ms_spaced times without touching memory.
SPIN_CYCLES = 50_000
# Phase endurance: the endurance CLI's plain regime (the 512-pose lap of
# radius 20 m rendered once, tiled to 1,024 frames) through the scan
# posture, detecting on every frame, with rings that wrap within the run:
# 192 keyframe slots, and a database of 960 frames.  A database must span
# the lap (512 frames back) to hold a revisit's match at query time; the
# scan verifies its candidates after the run on the rows then in the
# ring (ROADMAP F6), so the revisits whose match row frames 960-1,023
# overwrite (queries 512-575) cannot close here and the first closes at
# 576: about 5 closures (every 101 frames after the cooldown).
ENDURANCE_FRAMES = 1024
ENDURANCE_LAP = 512
ENDURANCE_RADIUS = 20.0
ENDURANCE_KF = 192
ENDURANCE_DB = 960
ENDURANCE_MIN_CLOSURES = 4

# Phase cli: the KITTI-layout trees it writes (under build/, git-ignored),
# the frames of each run and the vocabulary the CLI trains from sequence 01.
KITTI_DIR = ROOT / "build" / "kitti_smoke"
CLI_OUT = ROOT / "build" / "cli_smoke"
CLI_MAPPING_FRAMES = 17
CLI_VOCAB = dict(stride=4, k=9, levels=6)
CLI_SYNTH_FRAMES = 80


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def run_cmd(cmd: list[str]) -> str:
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    check(proc.returncode == 0, f"{' '.join(cmd)} failed: {proc.stderr.strip()}")
    return proc.stdout.strip()


def phase_toolchain(torch) -> str:
    """Prints the card's name and power limit and returns them."""
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0].strip()
    print(smi, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}")
    from ros_stereo_slam_tpu_torch.kernels import build

    nvcc = build.nvcc_path()
    log(f"nvcc {nvcc}: {run_cmd([nvcc, '--version']).splitlines()[-1]}")
    try:
        import triton  # noqa: F401

        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import ({e})")
    return smi


def phase_build() -> None:
    """One nvcc per kernel source, all started together."""
    from ros_stereo_slam_tpu_torch.kernels import build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(build.load, KERNELS))
    log(f"build: {len(KERNELS)} kernels in {time.perf_counter() - t0:.2f} s (parallel)")
    for name in KERNELS:
        secs = build.BUILD_LOG[name][0] if name in build.BUILD_LOG else 0.0
        log(f"build {name}: {secs:.2f} s ({build.library_path(name).name})")
        if name in build.BUILD_LOG:
            for line in build.BUILD_LOG[name][1].splitlines():
                if any(k in line for k in ("entry function", "registers", "spill")):
                    log(f"  ptxas: {line.strip()}")


def _render_job(world_kw: dict, indices: list, rgb: bool = False) -> list:
    """Worker process: render frames `indices` of one SyntheticWorld (with
    `rgb`, their left RGB frames as uint8)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import CameraConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    world = SyntheticWorld(camera=CameraConfig(), **world_kw)
    if rgb:
        return [(world.render_rgb(i) * 255.0 + 0.5).astype(np.uint8) for i in indices]
    return [world.render(i) for i in indices]


def _revisit_plan(n_total: int, shape: tuple[int, int], plan_seed: int, world_seed: int,
                  keep_noise: bool = True):
    """The jittered revisit world of bench.py (--world revisit --jitter):
    laps of a circle, lap 2+ with smoothly jittered poses, a per-lap
    brightness and per-frame sensor noise, drawn from one generator
    (`plan_seed`; the bench's is 17) in the bench's order, textures from
    `world_seed` (the bench's is 11).  Returns (render jobs, per-frame
    (brightness, noise), ground-truth poses); with `keep_noise` false the
    noise is drawn (so the later laps are the same) but not kept."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.data.synthetic import jitter_poses

    lap = max(n_total // 2, 2)
    r = lap * 0.8 / (2.0 * np.pi)  # ~0.8 m/frame
    lap_poses = np.zeros((lap, 4, 4))
    for i in range(lap):
        th = 2 * np.pi * i / lap
        c, sn = np.cos(th), np.sin(th)
        lap_poses[i] = np.eye(4)
        lap_poses[i, :3, :3] = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]])
        lap_poses[i, :3, 3] = np.array([r * (1 - c), 0.0, r * sn])
    rng = np.random.default_rng(plan_seed)
    jobs, post, gt = [], [], []
    for lap_i in range(-(-n_total // lap)):
        poses_l = (lap_poses if lap_i == 0
                   else jitter_poses(lap_poses, rng, trans_m=0.1, rot_deg=1.0))
        b = rng.uniform(0.85, 1.15) if lap_i > 0 else 1.0
        idx = list(range(min(lap, n_total - len(gt))))
        for i in idx:
            gt.append(poses_l[i])
            if lap_i > 0:
                noise = rng.normal(0, 0.02, shape).astype(np.float32)
                post.append((b, noise if keep_noise else None))
            else:
                post.append(None)
        jobs.append((dict(n_frames=lap, seed=world_seed, custom_poses=poses_l,
                          half_w=max(3.0 * r, 18.0), end_z=max(6.0 * r, 260.0)), idx))
    return jobs, post, np.stack(gt)


def revisit_frames(seeds: tuple[int, int], frames: list, camera=None, noise_seed: int = 0):
    """Frames `frames` of the revisit world with (plan, world) `seeds`,
    rendered one by one: (left, right) stacks.  With no `camera`, at full
    KITTI geometry with the world's own noise, as phase render makes them;
    with a smaller `camera`, the same poses, textures and per-lap
    brightness, with the sensor noise drawn at the camera's size from
    `noise_seed` (the world's own is drawn at full size)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import CameraConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    full = CameraConfig()
    jobs, post, _ = _revisit_plan(SLAM_FRAMES + 1, (full.height, full.width), *seeds,
                                  keep_noise=camera is None)
    rng = np.random.default_rng(noise_seed)
    lap = len(jobs[0][1])
    lefts, rights = [], []
    for f in frames:
        kw, _ = jobs[f // lap]
        left, right, _ = SyntheticWorld(camera=camera or full, **kw).render(f % lap)
        if post[f] is not None:
            b, noise = post[f]
            if noise is None:
                noise = rng.normal(0, 0.02, left.shape).astype(np.float32)
            left, right = np.clip(left * b + noise, 0, 1), np.clip(right * b + noise, 0, 1)
        lefts.append(left)
        rights.append(right)
    return np.stack(lefts).astype(np.float32), np.stack(rights).astype(np.float32)


class PendingRender:
    """Phase endurance's frames, rendering in a pool of `workers` processes
    while the phases before it run."""

    def __init__(self, pool, result, gt: list, workers: int):
        self.pool, self.result, self.gt, self.workers = pool, result, gt, workers

    def frames(self):
        """(left, right, ground truth, first lap's left frames), uint8;
        the pool is closed after."""
        from ros_stereo_slam_tpu_torch.tools import endurance_run as er

        parts = self.result.get()
        self.close()
        return er.assemble(parts, self.gt, ENDURANCE_FRAMES, ENDURANCE_LAP, False)

    def close(self) -> None:
        self.pool.terminate()
        self.pool.join()


def phase_render():
    """The corridor (with its RGB frames) and both revisit worlds at full
    KITTI geometry, rendered by worker processes.

    Returns ((corridor left, right, depths {0, 24}, poses, camera, RGB
    uint8), {"A": (revisit left, right, poses), "B": ...}, workers, the
    endurance lap still rendering (a PendingRender)).  The lap renders in
    a pool of two processes fewer than the host has CPUs, so the timed
    phases that overlap it keep two CPUs for the process that drives the
    card."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import CameraConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld
    from ros_stereo_slam_tpu_torch.tools import endurance_run as er

    cam = CameraConfig()
    # The bench corridor (bench.py::_render_world): seed 11, half_w 18 m.
    corridor_kw = dict(n_frames=FRAMES + 1, seed=11, half_w=18.0)
    corridor_poses = SyntheticWorld(camera=cam, **corridor_kw).poses
    plans = {name: _revisit_plan(SLAM_FRAMES + 1, (cam.height, cam.width), *seeds)
             for name, seeds in REVISIT_SEEDS.items()}
    chunks = []  # (world kwargs, frame indices, rgb), 8 frames each
    for kw, idx in [(corridor_kw, list(range(FRAMES + 1)))] + [
            job for jobs, _, _ in plans.values() for job in jobs]:
        chunks += [(kw, idx[i:i + 8], False) for i in range(0, len(idx), 8)]
    rgb_chunks = [(corridor_kw, list(range(i, min(i + 8, FRAMES + 1))), True)
                  for i in range(0, FRAMES + 1, 8)]
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(8, os.cpu_count() or 1))
    with ctx.Pool(workers) as pool:
        parts = pool.starmap(_render_job, chunks + rgb_chunks)
    # phase endurance's lap renders in the background while the phases run
    lap_workers = max(1, (os.cpu_count() or 1) - 2)
    lap_pool = ctx.Pool(lap_workers)
    gt = []
    lap = lap_pool.map_async(er._job, list(er.render_plan(
        ENDURANCE_FRAMES, ENDURANCE_LAP, ENDURANCE_RADIUS, gt=gt)))
    pending = PendingRender(lap_pool, lap, gt, lap_workers)
    frames = [f for part in parts[:len(chunks)] for f in part]
    rgb = np.stack([f for part in parts[len(chunks):] for f in part])
    corridor, rest = frames[:FRAMES + 1], frames[FRAMES + 1:]
    worlds = {}
    for name, (_, post, gt) in plans.items():
        revisit, rest = rest[:SLAM_FRAMES + 1], rest[SLAM_FRAMES + 1:]
        lefts, rights = [], []
        for (left, right, _), pp in zip(revisit, post):
            if pp is not None:  # photometric jitter on the revisit laps
                b, noise = pp
                left = np.clip(left * b + noise, 0, 1)
                right = np.clip(right * b + noise, 0, 1)
            lefts.append(left)
            rights.append(right)
        worlds[name] = (np.stack(lefts), np.stack(rights), gt)
    per = FRAMES // LANES
    return ((np.stack([f[0] for f in corridor]), np.stack([f[1] for f in corridor]),
             {0: corridor[0][2], per: corridor[per][2]}, corridor_poses, cam, rgb),
            worlds, workers, pending)


def cuda_ms(torch, fn, reps: int = 25) -> float:
    """Median milliseconds of `fn` from CUDA events (after 3 warm-ups)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(torch, launch, reps: int = 200, rounds: int = 7) -> float:
    """The kernel's own milliseconds: `launch` (a bare call of the C entry
    point on pre-allocated outputs, the wrappers' ``bare_launch``) made
    `reps` times back to back on one stream between two CUDA events, over
    `reps`; the least of `rounds` (the host can only add to a round).  Once
    the queue is ahead of the card this reads the kernel and not the host;
    for a kernel shorter than a launch it reads the launch rate (see
    ``empty_launch``)."""
    for _ in range(20):
        launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        err = 0
        start.record()
        for _ in range(reps):
            err |= launch()
        end.record()
        end.synchronize()
        check(err == 0, f"a bare kernel launch failed: cudaError {err}")
        times.append(start.elapsed_time(end) / reps)
    return min(times)


# Points a K1 call tracks: the grid's 768 slots, and the ORB route's
# keypoints (max_points).
K1_N, K1_N_ORB, K1_S = 768, ORB_STEREO["max_points"], 15


def _k1_points(rng, shape, depth, poses, i, cam, n: int = K1_N):
    """n points of corridor frame i whose true position in frame i + 1
    stays >= 40 px inside the image: (points, true positions in i + 1),
    from the rendered depth of frame i."""
    import numpy as np

    H, W = shape
    m = 40
    cand = np.stack([rng.uniform(m, W - m, 8 * n), rng.uniform(m, H - m, 8 * n)],
                    axis=1)
    z = depth[cand[:, 1].astype(int), cand[:, 0].astype(int)].astype(np.float64)
    pc = np.stack([(cand[:, 0] - cam.cx) / cam.fx * z,
                   (cand[:, 1] - cam.cy) / cam.fy * z, z], axis=1)
    T01 = np.linalg.inv(poses[i + 1]) @ poses[i]
    q = pc @ T01[:3, :3].T + T01[:3, 3]
    uv1 = np.stack([cam.fx * q[:, 0] / q[:, 2] + cam.cx,
                    cam.fy * q[:, 1] / q[:, 2] + cam.cy], axis=1)
    keep = np.nonzero((uv1[:, 0] >= m) & (uv1[:, 0] < W - m)
                      & (uv1[:, 1] >= m) & (uv1[:, 1] < H - m))[0][:n]
    check(keep.size == n, f"only {keep.size} interior K1 points in frame {i}")
    return cand[keep].astype(np.float32), uv1[keep]


def k1_cases(torch, left, depths, poses, cam, dev):
    """K1 inputs at the main path's shapes: corridor frames 0 and 1, N = 768
    points whose true position stays >= 40 px inside both frames.  Guesses
    are the true flow plus noise, as the path hands them over: up to 1 px
    for the seeded temporal track (level 0, 6 iters), up to 2 px for the
    rescue's level 0 after the coarse levels (10 iters), and the level-2
    (311x94) rescue pass at 1/4 scale (10 iters).  The ORB route tracks N =
    1,152 keypoints: its seeded temporal track (level 0, lk_seeded_iters =
    10, within 1 px) and a coarse level of its unseeded re-match (level 2,
    10 iters)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import lk, pyramid

    rng = np.random.default_rng(0)
    S = K1_S
    pts, uv1 = _k1_points(rng, left.shape[1:], depths[0], poses, 0, cam)
    opts, ouv1 = _k1_points(rng, left.shape[1:], depths[0], poses, 0, cam, K1_N_ORB)

    def seed(noise_px, scale=1.0, truth=uv1):
        g = (truth + rng.uniform(-noise_px, noise_px, truth.shape)) / scale
        return torch.from_numpy(g.astype(np.float32)).to(dev)

    ref_pyr = pyramid.build_pyramid(torch.from_numpy(left[0]).to(dev), 4)
    cur_pyr = pyramid.build_pyramid(torch.from_numpy(left[1]).to(dev), 4)
    p, op = (torch.from_numpy(x).to(dev) for x in (pts, opts))
    base = lk.LKParams(window=S, levels=4, iters=10)
    return [
        ("L0 1241x376 iters=6", ref_pyr[0], cur_pyr[0], p, seed(1.0),
         base._replace(iters=6)),
        ("L0 1241x376 iters=10", ref_pyr[0], cur_pyr[0], p, seed(2.0), base),
        ("L2 311x94 iters=10", ref_pyr[2], cur_pyr[2], (p / 4.0).contiguous(),
         seed(2.0, 4.0), base),
        ("ORB route L0 1241x376 iters=10", ref_pyr[0], cur_pyr[0], op,
         seed(1.0, truth=ouv1), base),
        ("ORB route L2 311x94 iters=10", ref_pyr[2], cur_pyr[2], (op / 4.0).contiguous(),
         seed(2.0, 4.0, ouv1), base),
    ]


def _bound(nbytes: float, ops: float, peak_ops: float = PEAK_F32_S) -> dict:
    """The least time the card could take for a call's work: the larger of
    its bytes over the memory rate and its operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / peak_ops * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": nbytes, "ops": ops}


def _sectors(torch, H: int, W: int, y0, x0, h: int, w: int) -> int:
    """Distinct 32-byte sectors (8 f32 pixels of the flat, lane-major
    layout) of (B, H, W) images that boxes cover: box m of lane b covers
    rows y0[b, m] .. + h - 1 and columns x0[b, m] .. + w - 1."""
    dev = y0.device
    lane = torch.arange(y0.shape[0], device=dev).reshape(-1, 1, 1, 1)
    rows = y0[..., None, None] + torch.arange(h, device=dev)[:, None]
    cols = x0[..., None, None] + torch.arange(w, device=dev)
    flat = (lane * H + rows) * W + cols
    return int(torch.unique(flat.reshape(-1) // 8).numel())


def _tile_start(torch, pos, n: int, dim: int):
    """lk_level.cu's tile_start: floor(pos) clamped to [0, dim - (n + 1)]."""
    return torch.clamp(torch.floor(torch.nan_to_num(pos, nan=0.0)), 0, dim - (n + 1)).long()


def lk_evals(torch, track, guesses, out, iters: int) -> int:
    """Gauss-Newton steps K1 evaluated over all points of one call.  A
    point stops at the first step under eps, and a point that stopped at
    step j gives the same result with `iters` = j, so j is the fewest
    iterations that reproduce `out`; `track(k)` reruns the call with k.  A
    point whose `ok` is false returns its guess and counts one step."""
    j = torch.full(out.shape[:-1], iters, dtype=torch.long, device=out.device)
    for k in range(iters - 1, -1, -1):
        same = ((guesses if k == 0 else track(k)[0]) == out).all(-1)
        j = torch.where(same, torch.full_like(j, k), j)
    return int(torch.where(j < iters, j + 1, j).sum())


def lk_work(torch, ref_pts, guesses, out_pts, H: int, W: int, S: int, evals: int) -> dict:
    """K1's work on (B, N, 2) points of B lanes.  Bytes: the 32-byte
    sectors that the (S+3)^2 template tiles cover in the reference images
    and the (S+1)^2 sample tiles at the guess and at the result cover in
    the current images (each read once; the steps between add little), the
    points and guesses read, the points, residuals and flags written.  A
    kernel that stages these tiles reads the same sectors, so the count
    holds for it as it stands.
    Operations per point: the (S+2)^2 template samples (9 each), gradients
    and structure tensor (16 per pixel) and the residual (12 per pixel),
    and `evals` Gauss-Newton steps of S^2 samples and products (14 per
    pixel) over all points."""
    T, half = S + 2, (S - 1) * 0.5
    B, n = ref_pts.shape[:2]
    ry = _tile_start(torch, ref_pts[..., 1] - half - 1.0, T, H)
    rx = _tile_start(torch, ref_pts[..., 0] - half - 1.0, T, W)
    cur = torch.cat([guesses, out_pts], dim=1)
    cy = _tile_start(torch, cur[..., 1] - half, S, H)
    cx = _tile_start(torch, cur[..., 0] - half, S, W)
    sectors = (_sectors(torch, H, W, ry, rx, T + 1, T + 1)
               + _sectors(torch, H, W, cy, cx, S + 1, S + 1))
    nbytes = sectors * 32 + B * n * (4 * 4 + 2 * 4 + 4 + 1)
    ops = B * n * (9 * T * T + S * S * (16 + 12)) + evals * S * S * 14
    return {**_bound(nbytes, ops), "image_sectors": sectors}


def orb_work(torch, img, pts, moments) -> dict:
    """K2's work on B lanes: (B, H, W) level images, (B, N, 2) corners and
    the (B, N, 2) moments the kernel found.  Bytes: the 32-byte sectors
    that the 2x2 footprints of every centroid sample and of every rotated
    pattern sample cover (positions as the kernel computes them, up to
    rounding), the corners, their validity flags and the constant patterns
    read once, the (N, 256) signs, (N, 2) moments and (N, 8) packed words
    written.  A kernel that stages each corner's patch reads the same
    sectors, so the count holds for it as it stands.  Operations per corner: 709
    centroid samples (9 + 2 each), 512 rotated samples (4 + 9 each) and 256
    compares."""
    from ros_stereo_slam_tpu_torch.ops import orb

    B, H, W = img.shape
    n = pts.shape[1]
    dev = pts.device
    cent = torch.from_numpy(orb._CENT).to(dev)
    pat = torch.cat([torch.from_numpy(orb._PAT_P), torch.from_numpy(orb._PAT_Q)]).to(dev)
    m10, m01 = moments[..., 0:1], moments[..., 1:2]
    r = torch.sqrt(torch.clamp(m10 * m10 + m01 * m01, min=1e-18))
    ca, sa = m10 / r, m01 / r
    rot = torch.stack([ca * pat[:, 0] - sa * pat[:, 1], sa * pat[:, 0] + ca * pat[:, 1]], -1)
    pos = torch.nan_to_num(torch.cat([pts[:, :, None, :] + cent, pts[:, :, None, :] + rot], 2))
    x0 = torch.floor(torch.clamp(pos[..., 0], 0.0, float(W - 1.001))).long().reshape(B, -1)
    y0 = torch.floor(torch.clamp(pos[..., 1], 0.0, float(H - 1.001))).long().reshape(B, -1)
    sectors = _sectors(torch, H, W, y0, x0, 2, 2)
    consts = (orb._CENT.size + orb._PAT_P.size + orb._PAT_Q.size) * 4
    nbytes = sectors * 32 + consts + B * n * (2 * 4 + 1 + 256 * 4 + 2 * 4 + 8 * 4)
    ops = B * n * (len(orb._CENT) * 11 + 512 * 13 + 256)
    return {**_bound(nbytes, ops), "image_sectors": sectors}


def _k1_case(torch, name, ref, cur, pts, guess, params) -> tuple:
    """One K1 call against lk._track_level on the card.  The two routes
    clamp tile reads differently at image borders (by design, as the JAX
    kernel and its oracle do), so points and residuals are compared where
    both results stay K1_BORDER_PX inside the image; that must be >= 95 %
    of N.  Returns (max |dpts|, wrapper ms, plain ms, device_ms, the bare
    launch)."""
    from ros_stereo_slam_tpu_torch.ops import interp, lk, lk_cuda

    kg, kr, kok = lk_cuda.track_level(ref, cur, pts, guess, params)
    again = lk_cuda.track_level(ref, cur, pts, guess, params)
    pg, pr, pok = lk._track_level(ref, cur, pts, guess, params)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(kg).all()), f"K1 {name}: non-finite points")
    check(all(torch.equal(x, y) for x, y in zip((kg, kr, kok), again)),
          f"K1 {name}: two runs of the same call differ")
    H, W = ref.shape
    inner = (interp.in_bounds(kg, H, W, K1_BORDER_PX)
             & interp.in_bounds(pg, H, W, K1_BORDER_PX))
    n, n_in = pts.shape[0], int(inner.sum())
    n_ok_diff = int((kok != pok).sum())
    err = float((kg - pg)[inner].abs().max())
    rerr = float((kr - pr)[inner].abs().max())
    ms = cuda_ms(torch, lambda: lk_cuda.track_level(ref, cur, pts, guess, params))
    plain_ms = cuda_ms(torch, lambda: lk._track_level(ref, cur, pts, guess, params))
    launch = lk_cuda.bare_launch(ref, cur, pts, guess, params)
    dev_ms = device_ms(torch, launch)
    log(f"K1 {name}: N={n} ok={int(kok.sum())} ok_mismatch={n_ok_diff} "
        f"compared={n_in} max|dpts|={err:.3e} px max|dresid|={rerr:.3e} "
        f"wrapper {ms:.4f} ms, kernel alone {dev_ms:.4f} ms, plain {plain_ms:.4f} ms")
    check(n_ok_diff == 0, f"K1 {name}: ok differs on {n_ok_diff} points")
    check(n_in >= 0.95 * n, f"K1 {name}: only {n_in}/{n} points stay interior")
    check(err <= K1_PTS_ATOL, f"K1 {name}: points differ by {err} px")
    check(rerr <= K1_RESID_ATOL, f"K1 {name}: resid differs by {rerr}")
    return err, ms, plain_ms, dev_ms, launch


def spaced_ms(torch, launch, dev) -> dict:
    """`launch` timed by device_ms_spaced behind a spin (L2-hot) and behind
    a 64 MB scratch write (L2-cold)."""
    hot = device_ms_spaced(torch, launch, lambda: torch.cuda._sleep(SPIN_CYCLES))
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    cold = device_ms_spaced(torch, launch, lambda: scratch.fill_(1))
    del scratch
    torch.cuda.synchronize()
    return {"device_ms_spaced_hot": hot, "device_ms_cold": cold}


def phase_kernels(torch, cases) -> dict:
    """K1 against lk._track_level on the card (:func:`_k1_case`), the
    headline call's times behind a spacer too, its bound and the border
    case."""
    from ros_stereo_slam_tpu_torch.ops import lk_cuda

    worst, rows = 0.0, []
    for name, ref, cur, pts, guess, params in cases:
        err, *times = _k1_case(torch, name, ref, cur, pts, guess, params)
        worst = max(worst, err)
        rows.append(times)
    # The headline time is the seeded temporal track (the per-frame call).
    _, ref, cur, pts, guess, params = cases[0]
    spaced = spaced_ms(torch, rows[0][3], ref.device)
    log(f"K1 {cases[0][0]} kernel alone behind a spacer: {spaced['device_ms_spaced_hot']:.4f} "
        f"ms after a spin (L2-hot), {spaced['device_ms_cold']:.4f} ms after a 64 MB scratch "
        f"write (L2-cold)")
    out = lk_cuda.track_level(ref, cur, pts, guess, params)[0]
    evals = lk_evals(torch, lambda k: lk_cuda.track_level(
        ref, cur, pts, guess, params._replace(iters=k)), guess, out, params.iters)
    work = lk_work(torch, pts[None], guess[None], out[None], *ref.shape, params.window, evals)
    log(f"K1 bound: {work['image_sectors']} image sectors, {evals} GN steps over "
        f"{pts.shape[0]} points: {work['bound_ms'] * 1e3:.3f} us ({work['bound_by']})")
    k1_border_case(torch, ref, params)
    return {"max_abs_err": worst, "ms": rows[0][0], "plain_ms": rows[0][1],
            "device_ms": rows[0][2], **spaced, **work}


def k1_border_case(torch, img, params) -> None:
    """K1 on points within `window` px of a border, where every tile start
    clamps: the image is tracked into itself from guesses within 1 px, out of
    a buffer whose rows above and below the image are NaN, so a read that
    leaves the image shows in the result.  Every output must be finite, and
    at least K1_BORDER_INSIDE of the tracked points inside the image (next
    to a border the clamped tiles extrapolate, and a few points walk out:
    lk.track masks those)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import lk_cuda

    H, W = img.shape
    S, n = params.window, 64
    rng = np.random.default_rng(2)
    d = rng.uniform(2.0, S, 4 * n)  # distance to the border
    along_w, along_h = rng.uniform(2.0, W - 3.0, 4 * n), rng.uniform(2.0, H - 3.0, 4 * n)
    x = np.concatenate([d[:n], W - 1 - d[n:2 * n], along_w[2 * n:]])
    y = np.concatenate([along_h[:2 * n], d[2 * n:3 * n], H - 1 - d[3 * n:]])
    pts = torch.from_numpy(np.stack([x, y], 1).astype(np.float32)).to(img.device)
    guess = pts + torch.from_numpy(rng.uniform(-1.0, 1.0, (4 * n, 2)).astype(np.float32)).to(
        img.device)
    pad = S + 4
    guarded = torch.full(((H + 2 * pad) * W,), float("nan"), device=img.device)
    inner = guarded[pad * W:(pad + H) * W].view(H, W)
    inner.copy_(img)
    kg, kr, kok = lk_cuda.track_level(inner, inner, pts, guess, params)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(kg).all() and torch.isfinite(kr).all())
    inside = ((kg[:, 0] >= 0) & (kg[:, 0] <= W - 1) & (kg[:, 1] >= 0) & (kg[:, 1] <= H - 1))
    moved = float((kg - pts).abs().max())
    log(f"K1 border case: {4 * n} points 2..{S} px from a border of {W}x{H}, ok={int(kok.sum())}"
        f", finite {finite}, inside the image {int(inside.sum())}/{4 * n}, max |result - point| "
        f"{moved:.3f} px")
    check(finite, "K1 border case: non-finite output (a read outside the image?)")
    check(int(inside.sum()) >= K1_BORDER_INSIDE * 4 * n,
          f"K1 border case: only {int(inside.sum())}/{4 * n} tracked points stay in the image")


def k1b_phase(torch, left, depths, poses, cam, dev,
              runs=((K1_N, 6, None), (K1_N_ORB, 10, None)), tag: str = "K1b") -> dict:
    """K1b (``lk_level_f32`` on B lanes) against its plain version (a loop of
    lk._track_level over lanes) on the card: the batched odometry's two
    lanes, corridor frames 0 -> 1 and 24 -> 25 at level 0 (1241x376), N =
    768 points each (the grid) and N = 1,152 (the ORB route's keypoints),
    guesses within 1 px of the truth, 6 and 10 iterations (the grid's and
    the ORB route's seeded track); K1's bounds.  Each lane must also equal
    the single-lane call's result bitwise (one entry point).  The
    headline numbers are the first run's (the grid's); `runs` holds (points
    per lane, iters, walk_iters or None for a walk of every step)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import interp, lk, lk_cuda

    rng = np.random.default_rng(1)
    starts = [b * (FRAMES // LANES) for b in range(LANES)]
    ref = torch.from_numpy(np.stack([left[i] for i in starts])).to(dev)
    cur = torch.from_numpy(np.stack([left[i + 1] for i in starts])).to(dev)
    H, W = ref.shape[1:]
    worst, out = 0.0, None
    for n_pts, iters, walk in runs:
        pts, guesses = [], []
        for i in starts:
            p, uv1 = _k1_points(rng, left.shape[1:], depths[i], poses, i, cam, n_pts)
            pts.append(p)
            guesses.append((uv1 + rng.uniform(-1.0, 1.0, uv1.shape)).astype(np.float32))
        P = torch.from_numpy(np.stack(pts)).to(dev)
        G = torch.from_numpy(np.stack(guesses)).to(dev)
        params = lk.LKParams(window=K1_S, levels=4, iters=iters,
                             walk_iters=iters if walk is None else walk)
        kg, kr, kok = lk_cuda.track_level_batch(ref, cur, P, G, params)
        pg, pr, pok = lk_cuda.track_level_batch_plain(ref, cur, P, G, params)
        singles = [lk_cuda.track_level(ref[b], cur[b], P[b], G[b], params)
                   for b in range(LANES)]
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kg).all()), f"{tag} N={n_pts}: non-finite points")
        inner = (interp.in_bounds(kg, H, W, K1_BORDER_PX)
                 & interp.in_bounds(pg, H, W, K1_BORDER_PX))
        n, n_in = kok.numel(), int(inner.sum())
        n_ok_diff = int((kok != pok).sum())
        err = float((kg - pg)[inner].abs().max())
        rerr = float((kr - pr)[inner].abs().max())
        same = all(torch.equal(kg[b], s[0]) and torch.equal(kr[b], s[1])
                   and torch.equal(kok[b], s[2]) for b, s in enumerate(singles))
        ms = cuda_ms(torch, lambda: lk_cuda.track_level_batch(ref, cur, P, G, params))
        plain_ms = cuda_ms(torch, lambda: lk_cuda.track_level_batch_plain(ref, cur, P, G,
                                                                          params))
        launch = lk_cuda.bare_launch(ref, cur, P, G, params)
        dev_ms = device_ms(torch, launch)
        log(f"{tag} {LANES} lanes L0 {W}x{H} iters={iters} walk={params.walk_iters}: "
            f"N={n_pts} per lane, "
            f"ok={int(kok.sum())} ok_mismatch={n_ok_diff} compared={n_in} "
            f"max|dpts|={err:.3e} px max|dresid|={rerr:.3e}; lanes equal the single-lane "
            f"kernel: {same}; wrapper {ms:.4f} ms, kernel alone {dev_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms")
        check(n_ok_diff == 0, f"{tag} N={n_pts}: ok differs on {n_ok_diff} points")
        check(n_in >= 0.95 * n, f"{tag} N={n_pts}: only {n_in}/{n} points stay interior")
        check(err <= K1_PTS_ATOL, f"{tag} N={n_pts}: points differ by {err} px")
        check(rerr <= K1_RESID_ATOL, f"{tag} N={n_pts}: resid differs by {rerr}")
        check(same, f"{tag} N={n_pts}: a lane differs from the single-lane kernel on the "
              f"same inputs")
        worst = max(worst, err)
        if out is None:
            spaced = spaced_ms(torch, launch, dev)
            log(f"{tag} kernel alone behind a spacer: {spaced['device_ms_spaced_hot']:.4f} ms "
                f"after a spin (L2-hot), {spaced['device_ms_cold']:.4f} ms after a 64 MB "
                f"scratch write (L2-cold)")
            out = {"ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms, **spaced,
                   "inputs": (ref, cur, P, G)}
            if walk is None:  # lk_evals counts the steps of a walk-only call
                evals = lk_evals(torch, lambda k: lk_cuda.track_level_batch(
                    ref, cur, P, G, params._replace(iters=k)), G, kg, params.iters)
                work = lk_work(torch, P, G, kg, H, W, K1_S, evals)
                log(f"{tag} bound: {work['image_sectors']} image sectors, {evals} GN steps "
                    f"over {LANES} x {n_pts} points: {work['bound_ms'] * 1e3:.3f} us "
                    f"({work['bound_by']})")
                out.update(work)
    return {"max_abs_err": worst, **out}


def phase_vocab(torch, left, cfg, dev):
    """The full-width vocabulary, trained on the card as bench.py trains
    it: ORB of every 8th frame, train_batched at (vocab_k, vocab_levels)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import vocab
    from ros_stereo_slam_tpu_torch.ops import orb

    lcc = cfg.loop
    t0 = time.perf_counter()
    descs, docs = [], []
    for i in range(0, left.shape[0], 8):
        f = orb.detect_and_compute(torch.from_numpy(left[i]).to(dev), lcc.orb_features,
                                   cfg.frontend.fast_thresh / 255.0, n_levels=lcc.orb_levels)
        descs.append(f.desc_sign[f.valid])
        docs.append(np.full(int(f.valid.sum()), i))
    X = torch.cat(descs)
    voc = vocab.train_batched(X, k=lcc.vocab_k, levels=lcc.vocab_levels,
                              doc_ids=np.concatenate(docs), device=dev)
    torch.cuda.synchronize()
    words = vocab.transform_words(voc, X)
    n_used = int(torch.unique(words).numel())
    tree = voc.packed()
    log(f"vocab: k={voc.k} L={voc.levels} ({voc.n_words} words) trained on the card from "
        f"{X.shape[0]} descriptors of {len(docs)} frames in {time.perf_counter() - t0:.2f} s; "
        f"{n_used} words used; int8 tables {sum(c.numel() for c in voc.centers)} bytes, "
        f"packed tree {tuple(tree.words.shape)} int32 = {tree.words.numel() * 4} bytes")
    check(voc.n_words == lcc.vocab_k ** lcc.vocab_levels, "vocabulary size")
    check(n_used > min(X.shape[0], voc.n_words) // 4,
          f"only {n_used} words used by {X.shape[0]} descriptors")
    return voc


def k2_border_case(torch, lvl, tag: str) -> tuple[int, int]:
    """K2 on corners 17..21 px from each border of one level image (17 is the
    nearest a valid corner comes), sides and the four image corners: the
    patch hangs over the border there, and the samples must still be
    bilinear_at's.  Held to K2's per-corner bit bound against the plain
    version; returns (bits compared, bits differing)."""
    from ros_stereo_slam_tpu_torch.ops import orb, orb_cuda

    H, W = lvl.shape
    xs, ys = [], []
    for d in range(17, 22):
        along_w = [W // 5, W // 2, W - W // 5]
        along_h = [H // 4, H // 2, H - H // 4]
        xs += [d] * 3 + [W - 1 - d] * 3 + along_w * 2 + [d, d, W - 1 - d, W - 1 - d]
        ys += along_h * 2 + [d] * 3 + [H - 1 - d] * 3 + [d, H - 1 - d, d, H - 1 - d]
    pts = torch.tensor(list(zip(xs, ys)), dtype=torch.float32, device=lvl.device)
    valid = torch.ones(pts.shape[0], dtype=torch.bool, device=lvl.device)
    ks, km, kw = orb_cuda.level_describe(lvl, pts, valid)
    ps, pm = orb._descriptors_plain(lvl, pts)
    torch.cuda.synchronize()
    per_corner = (ks != ps).sum(dim=1)
    m_ok = bool(((km - pm).abs() <= K2_MOMENT_ATOL + K2_MOMENT_RTOL * pm.abs()).all())
    log(f"{tag} border case {W}x{H}: {pts.shape[0]} corners 17..21 px from the borders, bits "
        f"differing {int(per_corner.sum())}/{pts.shape[0] * 256} (at most "
        f"{int(per_corner.max())} in one corner), max|dm|={float((km - pm).abs().max()):.3e}")
    check(m_ok, f"{tag} border case {W}x{H}: moments differ")
    check(int(per_corner.max()) <= K2_MAX_CORNER_BITS,
          f"{tag} border case {W}x{H}: a corner differs in {int(per_corner.max())} bits")
    check(torch.equal(kw, orb.pack_bits(ks > 0)), f"{tag} border case: packed words")
    return pts.shape[0] * 256, int(per_corner.sum())


def k2_phase(torch, img, cfg, stereo_img) -> dict:
    """K2 (an (H, W) image) or K2b (a (B, H, W) stack of lanes, the batched
    entry point) against its plain version, orb._level_describe_plain,
    through ``level_describe``, the call the main path makes, at the shapes
    of both routes that describe corners: the four ORB levels of a
    jittered revisit frame per lane `img` on the corners FAST + ANMS pick
    there (full SLAM's detection: 1241x376 .. 635x193, 173 .. 89 corners
    per lane), and the ORB stereo route's single level of corridor frame(s)
    `stereo_img` (1241x376) on the 1,152 corners per lane that
    ``detect_and_compute`` picks, as the route calls it.  Besides the bit and
    moment bounds: the packed words must be pack_bits of the kernel's own
    signs, invalid rows zero, valid rows +-1 and equal to those of the same
    call with every corner valid, two runs bitwise equal, each lane bitwise equal to the
    single-lane entry point, and (one image only) the border case at the
    largest and the smallest level."""
    from ros_stereo_slam_tpu_torch.ops import orb, orb_cuda

    lanes = img.dim() == 3
    tag, nl = ("K2b", img.shape[0]) if lanes else ("K2", 1)
    lcc = cfg.loop
    budgets = orb._level_budgets(lcc.orb_features, lcc.orb_levels, 1.25)
    levels = orb.level_images(img, lcc.orb_levels, 1.25)
    cases = [(f"level {l}", lvl, budget,
              orb._level_corners(lvl, budget, cfg.frontend.fast_thresh / 255.0))
             for l, (lvl, budget) in enumerate(zip(levels, budgets))]
    fe = _frontend_cfg(cfg.camera, ORB_STEREO).frontend
    f = orb.detect_and_compute(stereo_img, fe.max_points, fe.fast_thresh / 255.0)
    cases.append(("ORB stereo level 0", stereo_img, fe.max_points, (f.pts, f.valid)))
    worst, n_bits, n_diff, rows = 0.0, 0, 0, []
    for label, lvl, budget, (pts, valid) in cases:
        every = torch.ones_like(valid)  # every corner valid: the kernel's raw signs
        ks, km, kw = orb_cuda.level_describe(lvl, pts, valid)
        again = orb_cuda.level_describe(lvl, pts, valid)
        ps, pm, pw = orb._level_describe_plain(lvl, pts, valid)
        raw_s, raw_m, _ = orb_cuda.level_describe(lvl, pts, every)
        singles = ([orb_cuda.level_describe(lvl[b], pts[b], valid[b]) for b in range(nl)]
                   if lanes else [])
        torch.cuda.synchronize()
        per_corner = (ks != ps)[valid].sum(dim=-1)
        diff = int(per_corner.sum())
        corner_max = int(per_corner.max()) if per_corner.numel() else 0
        nv = int(valid.sum())
        merr = float((km - pm).abs().max())
        m_ok = bool(((km - pm).abs() <= K2_MOMENT_ATOL + K2_MOMENT_RTOL * pm.abs()).all())
        same = all(torch.equal(x[b], y) for b, s in enumerate(singles)
                   for x, y in zip((ks, km, kw), s))
        ms = cuda_ms(torch, lambda: orb_cuda.level_describe(lvl, pts, valid))
        plain_ms = cuda_ms(torch, lambda: orb._level_describe_plain(lvl, pts, valid))
        every_ms = cuda_ms(torch, lambda: orb_cuda.level_describe(lvl, pts, every))
        launch = orb_cuda.bare_launch(lvl, pts, valid)
        dev_ms = device_ms(torch, launch)
        H, W = lvl.shape[-2:]
        log(f"{tag} {label} {nl}x{W}x{H}: N={budget} per lane, valid={nv} bits differing "
            f"{diff}/{nv * 256} (at most {corner_max} in one corner) max|dm|={merr:.3e}"
            + (f"; lanes equal the single-lane kernel: {same}" if lanes else "")
            + f"; wrapper {ms:.4f} ms (every corner valid: {every_ms:.4f} ms), kernel alone "
            f"{dev_ms:.4f} ms, plain {plain_ms:.4f} ms")
        check(nv > nl * budget // 2, f"{tag} {label}: only {nv} valid corners")
        check(m_ok, f"{tag} {label}: moments differ by {merr}")
        check(corner_max <= K2_MAX_CORNER_BITS,
              f"{tag} {label}: a corner differs in {corner_max} bits > {K2_MAX_CORNER_BITS}")
        check(bool(torch.isin(raw_s, torch.tensor([-1.0, 1.0], device=ks.device)).all()),
              f"{tag} {label}: signs not +-1")
        check(torch.equal(ks[valid], raw_s[valid]) and not bool(ks[~valid].any())
              and torch.equal(km, raw_m),
              f"{tag} {label}: masked signs are not the all-valid signs times valid")
        check(torch.equal(kw, orb.pack_bits(ks > 0)),
              f"{tag} {label}: packed words are not pack_bits of the kernel's signs")
        check(all(torch.equal(x, y) for x, y in zip((ks, km, kw), again)),
              f"{tag} {label}: two runs of the same call differ")
        check(same, f"{tag} {label}: a lane differs from the single-lane kernel")
        worst = max(worst, merr)
        n_bits += nv * 256
        n_diff += diff
        rows.append((ms, plain_ms, dev_ms))
        if label == "level 0":
            work = orb_work(torch, lvl.reshape(nl, H, W), pts.reshape(nl, -1, 2),
                            km.reshape(nl, -1, 2))
            spaced = spaced_ms(torch, launch, lvl.device)
            log(f"{tag} level 0 kernel alone behind a spacer: "
                f"{spaced['device_ms_spaced_hot']:.4f} ms after a spin (L2-hot), "
                f"{spaced['device_ms_cold']:.4f} ms after a 64 MB scratch write (L2-cold)")
    if not lanes:
        for lvl in (levels[0], levels[-1]):
            nb, nd = k2_border_case(torch, lvl, tag)
            n_bits += nb
            n_diff += nd
    agree = 1.0 - n_diff / n_bits
    log(f"{tag}: bit agreement {agree:.5f} over {n_bits} bits of valid features "
        f"(bound {K2_MIN_AGREE})")
    check(agree >= K2_MIN_AGREE, f"{tag} bit agreement {agree} < {K2_MIN_AGREE}")
    # The headline time is full SLAM's level 0 (the largest call of a
    # detection frame).
    log(f"{tag} bound: {work['image_sectors']} image sectors at level 0: "
        f"{work['bound_ms'] * 1e3:.3f} us ({work['bound_by']})")
    return {"max_abs_err": worst, "mismatches": n_diff, "ms": rows[0][0],
            "plain_ms": rows[0][1], "device_ms": rows[0][2], **spaced, **work}


def device_ms_spaced(torch, launch, spacer, reps: int = 50, rounds: int = 5) -> float:
    """The kernel's own milliseconds with `spacer` run before each launch:
    `spacer` and `launch` made `reps` times back to back between two
    events, less `spacer` alone made the same way, over `reps`; each the
    least of `rounds`.  A spacer longer than the host's work per launch
    keeps the queue ahead of the card, so no host time enters, which
    back-to-back launches of a kernel shorter than that cannot promise.  A
    spin spacer (``torch.cuda._sleep``) leaves the L2 as it is (hot); a
    write larger than the L2 flushes it (cold)."""
    def window(fn) -> float:
        best = float("inf")
        for _ in range(rounds):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / reps)
        return best

    errs = []
    window(lambda: (spacer(), errs.append(launch())))  # warm-up
    both = window(lambda: (spacer(), errs.append(launch())))
    check(not any(errs), f"a bare kernel launch failed: cudaError {max(errs)}")
    return both - window(spacer)


def _duplicate_siblings(torch, tree, k: int):
    """`tree` with siblings 2 and 3 of every group copies of siblings 1 and
    0, at every level: exact ties that the first max must break to 0 or 1."""
    from ros_stereo_slam_tpu_torch.models import vocab

    words = tree.words.clone()
    for l in range(tree.levels):
        g = words[tree.offsets[l]:tree.offsets[l + 1]].view(-1, k, 8)
        g[:, 2] = g[:, 1]
        g[:, 3] = g[:, 0]
    return vocab.PackedTree(words=words, offsets=tree.offsets)


def descent_products(torch, tree, idf, img, cfg, n_desc: int) -> list:
    """The matrix products of one full-SLAM detection (``_lc_scan_step``)
    that take an (n_desc, 256) operand, i.e. a dense descent level, from
    ``torch.profiler`` with shapes recorded: (name, input shapes)."""
    from torch.profiler import ProfilerActivity, profile

    from ros_stereo_slam_tpu_torch.models import slam_scan

    lc = slam_scan.init_lc_state(cfg, device=img.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        slam_scan._lc_scan_step(lc, img, 0, tree, idf, cfg, cfg.loop.vocab_k)
        torch.cuda.synchronize()
    products = ("aten::mm", "aten::matmul", "aten::addmm", "aten::bmm", "aten::einsum",
                "aten::linear")
    return [(e.name, e.input_shapes) for e in prof.events() if e.name in products
            and any(list(sh) == [n_desc, 256] for sh in e.input_shapes)]


def k3_phase(torch, img, imgs, voc, cfg) -> dict:
    """K3 against vocab._descend_packed_plain on the trained full-width tree
    (k = 9, L = 6, 597,870 packed rows), descending ORB's packed words as
    the main path does: one frame's 512 descriptors (invalid rows
    included), two lanes' 1,024, and the 512 again through the tree with
    duplicate sibling rows (ties at every level).  Word ids must be equal
    on every row and two runs bitwise equal.  Times: the wrapper call
    (``ms``), the kernel alone back to back (``device_ms``, L2-hot), behind
    a spin (``device_ms_spaced_hot``) and behind a 64 MB scratch write
    (``device_ms_cold``), the plain
    version, and ``_descend`` on the sign rows (checks and packing
    included)."""
    from ros_stereo_slam_tpu_torch.models import vocab
    from ros_stereo_slam_tpu_torch.ops import orb, vocab_cuda

    lcc = cfg.loop
    k, L = voc.k, voc.levels
    tree = voc.packed()

    def features(x):
        f = orb.detect_and_compute(x, lcc.orb_features, cfg.frontend.fast_thresh / 255.0,
                                   n_levels=lcc.orb_levels)
        return (f.desc_bits.reshape(-1, 8), f.valid.reshape(-1),
                f.desc_sign.reshape(-1, orb.N_BITS))

    one, two = features(img), features(imgs)
    dup = _duplicate_siblings(torch, tree, k)
    cases = [("one frame", one, tree), ("two lanes", two, tree),
             ("duplicate siblings", one, dup)]
    worst = 0
    for name, (bits, valid, _), t in cases:
        out = vocab_cuda.descend(bits, valid, t, k, L)
        again = vocab_cuda.descend(bits, valid, t, k, L)
        ref = vocab._descend_packed_plain(bits, valid, t, k, L)
        torch.cuda.synchronize()
        mismatches = int((out != ref).sum())
        same = torch.equal(out, again)
        log(f"K3 {name}: {bits.shape[0]} descriptors ({int(valid.sum())} valid) through "
            f"{L} levels of {t.words.shape[0]} packed rows: word ids differing {mismatches}, "
            f"two runs equal {same}, {int(torch.unique(out).numel())} distinct words")
        check(mismatches == 0, f"K3 {name}: {mismatches} word ids differ from the plain version")
        check(same, f"K3 {name}: two runs of the same call differ")
        check(not bool(out[~valid].any()), f"K3 {name}: an invalid row is not word 0")
        if t is dup:
            digits = {int(d) for m in range(L) for d in torch.unique(out[valid] // k ** m % k)}
            check(not digits & {2, 3}, f"K3 {name}: children {sorted(digits)} taken where "
                  f"siblings 2, 3 tie 1, 0")
        worst = max(worst, mismatches)
    bits, valid, sign = one
    # the whole descent of sign rows, and its dense products: none may remain
    words_sign = vocab._descend(tree, sign, k, L)
    check(torch.equal(words_sign, vocab_cuda.descend(bits, valid, tree, k, L)),
          "K3: _descend on the sign rows differs from the descent of the packed words")
    dense = descent_products(torch, tree, voc.idf, img, cfg, bits.shape[0])
    log(f"K3: matrix products with a ({bits.shape[0]}, 256) operand in one _lc_scan_step "
        f"(torch.profiler): {dense}")
    check(not dense, f"K3: the detection step still runs dense descent products {dense}")

    ms = cuda_ms(torch, lambda: vocab_cuda.descend(bits, valid, tree, k, L))
    plain_ms = cuda_ms(torch, lambda: vocab._descend_packed_plain(bits, valid, tree, k, L))
    whole_ms = cuda_ms(torch, lambda: vocab._descend(tree, sign, k, L))
    launch = vocab_cuda.bare_launch(bits, valid, tree, k, L)
    dev_ms = device_ms(torch, launch)
    spaced = spaced_ms(torch, launch, img.device)
    hot_ms, cold_ms = spaced["device_ms_spaced_hot"], spaced["device_ms_cold"]
    check(torch.equal(launch.outputs[0], vocab_cuda.descend(bits, valid, tree, k, L)),
          "K3: the bare launch's word ids differ from the wrapper's")
    log(f"K3 kernel alone: {dev_ms:.4f} ms back to back (L2-hot); behind a spacer, so the "
        f"host stays ahead: {hot_ms:.4f} ms after a spin (L2-hot), {cold_ms:.4f} ms after a "
        f"64 MB scratch write (L2-cold)")
    log(f"K3 512 descriptors -> word ids: wrapper {ms:.4f} ms (the main path's call), "
        f"_descend of the sign rows {whole_ms:.4f} ms (checks and packing included), plain "
        f"{plain_ms:.4f} ms")
    # Bound: the descriptors' words and flags read, the word ids written, and
    # the k sibling rows of every node this run's valid descriptors visit,
    # read once per level; per visited row 8 XORs, 8 popcounts and 8 adds.
    # Beside it, the same rows as int8 (the tables the old K3 read).
    rows_read, node = 0, torch.zeros_like(valid, dtype=torch.int64)
    for l in range(L):
        rows_read += int(torch.unique(node[valid]).numel()) * k
        node = vocab._descend_packed_plain(bits, valid, tree, k, l + 1)
    n, nv = bits.shape[0], int(valid.sum())
    io = n * (32 + 1 + 8) + (L + 1) * 4
    work = _bound(io + rows_read * 32, nv * L * k * 24)
    old = _bound(io + rows_read * 256, nv * L * k * 256 * 2, PEAK_INT8_S)
    log(f"K3 bound: {rows_read} sibling rows visited over {L} levels: packed "
        f"{rows_read * 32} bytes -> {work['bound_ms'] * 1e3:.3f} us ({work['bound_by']}); as "
        f"int8 rows {rows_read * 256} bytes -> {old['bound_ms'] * 1e3:.3f} us")
    return {"max_abs_err": float(worst), "mismatches": worst, "ms": ms, "plain_ms": plain_ms,
            "device_ms": dev_ms, **spaced, "whole_descent_ms": whole_ms,
            "int8_bound_ms": old["bound_ms"], **work}


def phase_slice(torch, left, right, poses, cam, dev) -> dict:
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.models import pipeline, step
    from ros_stereo_slam_tpu_torch.ops import lk_cuda
    from ros_stereo_slam_tpu_torch.utils import metrics

    cfg = preset_odometry().replace(camera=cam)
    L = torch.from_numpy(left).to(dev)
    R = torch.from_numpy(right).to(dev)
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    pipeline.run_offline(cfg, L, R, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    times, launches = [], None
    for rep in range(3):
        lk_cuda.LAUNCHES = 0
        step.HOST_READS = 0
        step.RESCUES = 0
        t0 = time.perf_counter()
        res = pipeline.run_offline(cfg, L, R, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            launches = lk_cuda.LAUNCHES
            host_reads, rescues = step.HOST_READS, step.RESCUES
    traj = res.trajectory
    F = left.shape[0] - 1
    check(traj.shape == (F + 1, 4, 4), f"trajectory shape {traj.shape}")
    check(bool(np.isfinite(traj).all()), "non-finite poses")
    ate = metrics.ate_rmse(traj, poses)
    n_kf = 1 + int(res.is_keyframe.sum())
    med = statistics.median(times)
    log(f"slice: {F + 1} frames {left.shape[2]}x{left.shape[1]}, first run "
        f"{first_s:.3f} s, warm runs {[round(t, 4) for t in times]} s, "
        f"median {med:.4f} s -> {F / med:.2f} fps (F/median, as bench.py)")
    log(f"slice: ATE {ate:.4f} m (bound {ATE_BOUND_M}; JAX package on a host "
        f"CPU: {JAX_CPU_ATE_M}), keyframes {n_kf}, rescues {rescues}, "
        f"host reads/frame {host_reads / F:.2f}, lk_cuda launches {launches}, "
        f"min inliers {int(res.n_inliers.min())}, "
        f"all tracked {bool(res.tracking_ok.all())}")
    check(bool(res.tracking_ok.all()),
          f"tracking lost on frames {np.nonzero(~res.tracking_ok)[0] + 1}")
    check(launches > 0, "the main path launched no K1 kernel")
    check(ate < ATE_BOUND_M, f"ATE {ate} m >= {ATE_BOUND_M} m")

    # The streaming driver must give the offline driver's poses.
    n_stream = min(8, F + 1)
    odo = pipeline.StereoOdometry(cfg, device=dev)
    odo.initialize(left[0], right[0])
    for i in range(1, n_stream):
        odo.process_frame(left[i], right[i])
    diff = float(np.abs(odo.trajectory_array() - traj[:n_stream]).max())
    log(f"StereoOdometry vs run_offline over {n_stream} frames: max |dT| {diff:.3e}")
    check(diff <= 1e-5, f"StereoOdometry poses differ from run_offline by {diff}")
    return {"launches": launches, "fps": F / med, "ate": ate, "trajectory": traj,
            "host_reads": host_reads}


def phase_slam(torch, voc, left, right, gt, cfg, dev) -> dict:
    """Full SLAM through run_offline_slam on the card: one cold run, then
    warm runs; launch counts and host reads from the first warm run."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import slam_scan, step
    from ros_stereo_slam_tpu_torch.ops import lk_cuda, orb_cuda, vocab_cuda
    from ros_stereo_slam_tpu_torch.utils import metrics

    L = torch.from_numpy(left).to(dev)
    R = torch.from_numpy(right).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam_scan.run_offline_slam(cfg, voc, L, R, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0

    times, counts = [], None
    for rep in range(SLAM_WARM_RUNS):
        if rep == 0:
            lk_cuda.LAUNCHES = orb_cuda.LAUNCHES = vocab_cuda.LAUNCHES = 0
            step.HOST_READS = step.RESCUES = 0
        t0 = time.perf_counter()
        res = slam_scan.run_offline_slam(cfg, voc, L, R, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            counts = dict(lk_level=lk_cuda.LAUNCHES, orb_desc=orb_cuda.LAUNCHES,
                          vocab_descend=vocab_cuda.LAUNCHES, host_reads=step.HOST_READS,
                          rescues=step.RESCUES)
    F = left.shape[0] - 1
    traj = res.trajectory
    check(traj.shape == (F + 1, 4, 4), f"trajectory shape {traj.shape}")
    check(bool(np.isfinite(traj).all()), "non-finite poses")
    ate = metrics.ate_rmse(traj, gt)
    ate_odo = metrics.ate_rmse(res.trajectory_odo, gt)
    med = statistics.median(times)
    events = [(int(q), int(m), int(n)) for q, m, n in res.loop_events]
    log(f"slam: {F + 1} revisit frames {left.shape[2]}x{left.shape[1]}, cold run "
        f"{first_s:.3f} s, warm runs {[round(t, 4) for t in times]} s, median {med:.4f} s "
        f"-> {F / med:.2f} fps (F/median)")
    log(f"slam: ATE post-PGO {ate:.4f} m, odometry only {ate_odo:.4f} m; loop events "
        f"(query, match, inliers) {events}; keyframes {1 + int(res.is_keyframe.sum())}; "
        f"min PnP inliers {int(res.n_inliers.min())}; launches K1 {counts['lk_level']}, "
        f"K2 {counts['orb_desc']}, K3 {counts['vocab_descend']}; host reads/frame "
        f"{counts['host_reads'] / F:.2f}; rescues {counts['rescues']}; all tracked "
        f"{bool(res.tracking_ok.all())}")
    check(bool(res.tracking_ok.all()),
          f"tracking lost on frames {np.nonzero(~res.tracking_ok)[0] + 1}")
    check(len(events) >= 1, "no loop closure accepted")
    for q, m, _ in events:
        d = (q - m) % LAP
        check(min(d, LAP - d) <= REVISIT_TOL,
              f"closure ({q}, {m}) is not within {REVISIT_TOL} frames of a true revisit")
    check(ate < ate_odo, f"post-PGO ATE {ate} m is not below odometry-only {ate_odo} m")
    for name in KERNELS:
        check(counts[name] > 0, f"the full-SLAM path launched no {name} kernel")
    n_detect = 1 + F // max(cfg.loop.detect_every, 1)
    check(counts["vocab_descend"] == n_detect,
          f"K3 launched {counts['vocab_descend']} times over {n_detect} detection frames")
    return {"counts": counts, "fps": F / med, "ate": ate, "ate_odo": ate_odo,
            "events": events}


def phase_batched_odo(torch, left, right, poses, cam, dev) -> dict:
    """bench.py's batched row (--lanes 2) on the card: the corridor splits
    into 2 lanes of 24 frames through step_batched.run_sequence_batched at
    preset_odometry(); one cold run, then warm runs, counts from the first
    warm run.  Each lane is held against the single-lane run of the same
    frames with that lane's key."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.models import pipeline, step, step_batched
    from ros_stereo_slam_tpu_torch.ops import lk_cuda
    from ros_stereo_slam_tpu_torch.utils import metrics

    cfg = preset_odometry().replace(camera=cam)
    per = FRAMES // LANES
    starts = [b * per for b in range(LANES)]
    L = torch.from_numpy(left).to(dev)
    R = torch.from_numpy(right).to(dev)
    Ls = torch.stack([L[s:s + per + 1] for s in starts])  # (B, per + 1, H, W)
    Rs = torch.stack([R[s:s + per + 1] for s in starts])
    gp, gm = pipeline._grid_for(cfg, dev)
    keys = step_batched.lane_keys(cfg.seed, LANES)

    def run():
        c0 = step.init_carry_batched(Ls[:, 0], Rs[:, 0], gp, gm, keys, cfg)
        return step_batched.run_sequence_batched(Ls[:, 1:], Rs[:, 1:], c0, gp, gm, cfg)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times, counts = [], None
    for rep in range(WARM_RUNS):
        if rep == 0:
            lk_cuda.LAUNCHES = lk_cuda.BATCH_LAUNCHES = 0
            step.HOST_READS = step.RESCUES = 0
        t0 = time.perf_counter()
        _, st = run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            counts = dict(k1=lk_cuda.LAUNCHES, k1b=lk_cuda.BATCH_LAUNCHES,
                          host_reads=step.HOST_READS, rescues=step.RESCUES)
    T = st.T_wc.cpu().numpy()  # (per, B, 4, 4)
    check(T.shape == (per, LANES, 4, 4), f"stats shape {T.shape}")
    check(bool(np.isfinite(T).all()), "non-finite poses")
    tracked = st.tracking_ok.cpu().numpy()
    ates, lane_diff = [], []
    for b, s0 in enumerate(starts):
        traj = np.concatenate([np.eye(4, dtype=np.float32)[None], T[:, b]])
        ates.append(metrics.ate_rmse(traj, poses[s0:s0 + per + 1]))
        c = step.init_carry(Ls[b, 0], Rs[b, 0], gp, gm, keys[b], cfg)
        _, ss = step.run_sequence(Ls[b, 1:], Rs[b, 1:], c, gp, gm, cfg)
        lane_diff.append(float(np.abs(T[:, b, :3, 3] - ss.T_wc[:, :3, 3].cpu().numpy()).max()))
    med = statistics.median(times)
    log(f"batched_odo: {LANES} lanes x {per} frames {left.shape[2]}x{left.shape[1]}, cold "
        f"{first_s:.3f} s, warm runs {[round(t, 4) for t in times]} s, median {med:.4f} s "
        f"-> {LANES * per / med:.2f} fps aggregate (B * per / median, as bench.py)")
    log(f"batched_odo: ATE per lane {[round(a, 4) for a in ates]} m (bound {ATE_BOUND_M}), "
        f"keyframes per lane {(st.is_keyframe.sum(0) + 1).tolist()}, rescues {counts['rescues']}, "
        f"host reads/frame {counts['host_reads'] / per:.2f}, K1b launches {counts['k1b']}, "
        f"K1 launches {counts['k1']}, max |dt| vs the single-lane runs per lane "
        f"{[f'{d:.2e}' for d in lane_diff]} m, all tracked {bool(tracked.all())}")
    check(bool(tracked.all()), f"batched tracking lost at (frame, lane) {np.argwhere(~tracked)}")
    check(max(ates) < ATE_BOUND_M, f"worst-lane ATE {max(ates)} m >= {ATE_BOUND_M} m")
    check(counts["host_reads"] == 2 * per,
          f"{counts['host_reads']} host reads over {per} frames, not 2 per frame")
    check(counts["k1b"] > 0, "the batched path launched no K1b kernel")
    check(counts["k1"] == 0, f"the batched path launched the single-lane K1 {counts['k1']} times")
    check(max(lane_diff) <= LANE_TOL_M,
          f"a lane differs from its single-lane run by {max(lane_diff)} m > {LANE_TOL_M}")
    return {"launches": counts["k1b"], "fps": LANES * per / med, "ate_worst": max(ates),
            "lane_diff": max(lane_diff), "keyframes": (st.is_keyframe.sum(0) + 1).tolist()}


def phase_batched_slam(torch, voc, worlds, cfg, dev) -> dict:
    """run_offline_slam_batched on the card over revisit worlds A and B as two
    lanes (preset_loop_closure() at its defaults): one cold run, then warm
    runs, counts from the first warm run; every lane checked as phase slam
    checks its run."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import slam_scan, step
    from ros_stereo_slam_tpu_torch.ops import lk_cuda, orb_cuda, vocab_cuda
    from ros_stereo_slam_tpu_torch.utils import metrics

    L = torch.from_numpy(np.stack([worlds[n][0] for n in REVISIT_SEEDS])).to(dev)
    R = torch.from_numpy(np.stack([worlds[n][1] for n in REVISIT_SEEDS])).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slam_scan.run_offline_slam_batched(cfg, voc, L, R, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times, counts = [], None
    for rep in range(SLAM_WARM_RUNS):
        if rep == 0:
            lk_cuda.LAUNCHES = lk_cuda.BATCH_LAUNCHES = 0
            orb_cuda.LAUNCHES = orb_cuda.BATCH_LAUNCHES = vocab_cuda.LAUNCHES = 0
            step.HOST_READS = step.RESCUES = 0
        t0 = time.perf_counter()
        res = slam_scan.run_offline_slam_batched(cfg, voc, L, R, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            counts = dict(k1=lk_cuda.LAUNCHES, k1b=lk_cuda.BATCH_LAUNCHES,
                          k2=orb_cuda.LAUNCHES, k2b=orb_cuda.BATCH_LAUNCHES,
                          k3=vocab_cuda.LAUNCHES, host_reads=step.HOST_READS,
                          rescues=step.RESCUES)
    F = L.shape[1] - 1
    med = statistics.median(times)
    log(f"batched_slam: {LANES} lanes x {F + 1} revisit frames, cold {first_s:.3f} s, warm "
        f"runs {[round(t, 4) for t in times]} s, median {med:.4f} s -> "
        f"{LANES * F / med:.2f} fps aggregate (B * F / median)")
    log(f"batched_slam: launches K1b {counts['k1b']}, K2b {counts['k2b']}, K3 {counts['k3']} "
        f"(single-lane K1 {counts['k1']} and K2 {counts['k2']}: the epilogue's loop edges "
        f"and checks), host reads/frame {counts['host_reads'] / F:.2f}, rescues "
        f"{counts['rescues']}")
    out = []
    for name, r in zip(REVISIT_SEEDS, res):
        gt = worlds[name][2]
        traj = r.trajectory
        check(traj.shape == (F + 1, 4, 4), f"lane {name}: trajectory shape {traj.shape}")
        check(bool(np.isfinite(traj).all()), f"lane {name}: non-finite poses")
        ate = metrics.ate_rmse(traj, gt)
        ate_odo = metrics.ate_rmse(r.trajectory_odo, gt)
        events = [(int(q), int(m), int(n)) for q, m, n in r.loop_events]
        log(f"batched_slam lane {name}: ATE post-PGO {ate:.4f} m, odometry only "
            f"{ate_odo:.4f} m; loop events (query, match, inliers) {events}; keyframes "
            f"{1 + int(r.is_keyframe.sum())}; min PnP inliers {int(r.n_inliers.min())}; all "
            f"tracked {bool(r.tracking_ok.all())}")
        check(bool(r.tracking_ok.all()),
              f"lane {name}: tracking lost on frames {np.nonzero(~r.tracking_ok)[0] + 1}")
        check(len(events) >= 1, f"lane {name}: no loop closure accepted")
        for q, m, _ in events:
            d = (q - m) % LAP
            check(min(d, LAP - d) <= REVISIT_TOL,
                  f"lane {name}: closure ({q}, {m}) is not within {REVISIT_TOL} frames of a "
                  f"true revisit")
        check(ate < ate_odo, f"lane {name}: post-PGO ATE {ate} m is not below odometry-only "
                             f"{ate_odo} m")
        out.append({"lane": name, "ate": ate, "ate_odo": ate_odo, "events": events,
                    "trajectory": traj})
    for k in ("k1b", "k2b", "k3"):
        check(counts[k] > 0, f"the batched full-SLAM path launched no {k} kernel")
    n_detect = 1 + F // max(cfg.loop.detect_every, 1)
    check(counts["k3"] == n_detect,
          f"K3 launched {counts['k3']} times over {n_detect} detection frames of all lanes")
    check(counts["host_reads"] == 2 * F,
          f"{counts['host_reads']} host reads over {F} frames, not 2 per frame")
    return {"counts": counts, "fps": LANES * F / med, "lanes": out}


def k1_converged_walk_case(torch, img, params) -> None:
    """K1 with freeze-polish where the walk converges at once and polish
    must still run: the image moved by 1 px to the right (to the bottom),
    reference points whose match lies in [dim - S//2 - 2, dim - S//2 - 1)
    from their exact match.  No tile clamps there, but the polish anchor
    does, and the clamped sample moves the points: K1 within K1's bounds of
    its plain version, the walk alone leaving the points where they were."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda

    H, W = img.shape
    r, n = params.window // 2, 64
    rng = np.random.default_rng(3)
    f = rng.uniform(0.1, 0.9, n)
    worst, moved = 0.0, []
    for axis, fixed, along in ((1, W, H), (0, H, W)):
        edge = fixed - r - 3 + f
        mid = rng.uniform(40, along - 40, n)
        pts = np.stack([edge, mid] if axis == 1 else [mid, edge], 1).astype(np.float32)
        p = torch.from_numpy(pts).to(img.device)
        shift = torch.tensor([1.0, 0.0] if axis == 1 else [0.0, 1.0], device=img.device)
        cur = torch.roll(img, 1, dims=axis).contiguous()
        g0 = p + shift
        kg, kr, kok = lk_cuda.track_level(img, cur, p, g0, params)
        pg, pr, pok = lk._track_level(img, cur, p, g0, params)
        wg = lk_cuda.track_level(img, cur, p, g0, params._replace(iters=params.walk_iters))[0]
        torch.cuda.synchronize()
        check(torch.equal(kok, pok), "K1 converged-walk case: ok differs")
        worst = max(worst, float((kg - pg).abs().max()), float((kr - pr).abs().max()) / 2)
        check(float((wg - g0).abs().max()) < 1e-3, "K1 converged-walk case: the walk moved")
        moved.append(float((kg - wg).abs().max(1).values.mean()))
    log(f"K1 converged-walk case ({2 * n} points at the right and bottom borders of {W}x{H}): "
        f"max |kernel - plain| {worst:.3e}, mean polish move {[round(m, 3) for m in moved]} px")
    check(worst <= K1_PTS_ATOL, f"K1 converged-walk case: kernel and plain differ by {worst}")
    check(min(moved) > 0.05, f"K1 converged-walk case: polish did not move the points {moved}")


def phase_polish(torch, left, right, depths, poses, cam, dev, sl: dict) -> dict:
    """Freeze-polish on the card: K1 and K1b with 3 walk steps of 8 against
    their plain versions at the seeded track's shapes (level 0, the grid's
    768 points and the ORB route's 1,152) and at borders, each kernel's
    time beside the walk-only call of the same 8 steps; then the corridor
    through run_offline with POLISH (one cold run, then warm runs, counts
    from the first warm run), held to phase slice's ATE bound."""
    import dataclasses

    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.models import pipeline, step
    from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda
    from ros_stereo_slam_tpu_torch.utils import metrics

    iters, walk = POLISH["lk_seeded_iters"], POLISH["lk_seeded_walk_iters"]
    cases = k1_cases(torch, left, depths, poses, cam, dev)
    k1 = None
    for name, ref, cur, pts, guess, params in (cases[0], cases[3]):
        pol = params._replace(iters=iters, walk_iters=walk)
        err, ms, plain_ms, dev_ms, launch = _k1_case(
            torch, f"{name.split(' iters')[0]} walk {walk} of {iters}", ref, cur, pts, guess, pol)
        walk_ms = device_ms(torch, lk_cuda.bare_launch(ref, cur, pts, guess,
                                                       pol._replace(walk_iters=iters)))
        log(f"K1 polish N={pts.shape[0]}: kernel alone {dev_ms:.4f} ms against {walk_ms:.4f} ms "
            f"for {iters} walk steps ({dev_ms / walk_ms:.3f}x)")
        if k1 is None:
            k1 = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "device_ms": dev_ms,
                  "walk_device_ms": walk_ms, **spaced_ms(torch, launch, dev)}
            log(f"K1 polish kernel alone behind a spacer: {k1['device_ms_spaced_hot']:.4f} ms "
                f"after a spin (L2-hot), {k1['device_ms_cold']:.4f} ms after a 64 MB scratch "
                f"write (L2-cold)")
            k1_border_case(torch, ref, pol)
            k1_converged_walk_case(torch, ref, pol)
        k1["max_abs_err"] = max(k1["max_abs_err"], err)
    k1b = k1b_phase(torch, left, depths, poses, cam, dev, runs=((K1_N, iters, walk),),
                    tag="K1b polish")
    k1b["walk_device_ms"] = device_ms(torch, lk_cuda.bare_launch(
        *k1b.pop("inputs"), lk.LKParams(window=K1_S, levels=4, iters=iters, walk_iters=iters)))
    log(f"K1b polish: kernel alone {k1b['device_ms']:.4f} ms against "
        f"{k1b['walk_device_ms']:.4f} ms for {iters} walk steps "
        f"({k1b['device_ms'] / k1b['walk_device_ms']:.3f}x)")

    base = preset_odometry()
    cfg = base.replace(camera=cam, frontend=dataclasses.replace(base.frontend, **POLISH))
    L = torch.from_numpy(left).to(dev)
    R = torch.from_numpy(right).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipeline.run_offline(cfg, L, R, device=dev)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    times, counts = [], None
    for rep in range(POLISH_WARM_RUNS):
        if rep == 0:
            _kernel_counts(reset=True)
            step.HOST_READS = step.RESCUES = 0
        t0 = time.perf_counter()
        res = pipeline.run_offline(cfg, L, R, device=dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if rep == 0:
            counts = {**_kernel_counts(), "host_reads": step.HOST_READS,
                      "rescues": step.RESCUES}
    F = left.shape[0] - 1
    traj = res.trajectory
    check(traj.shape == (F + 1, 4, 4) and bool(np.isfinite(traj).all()),
          f"polish: trajectory {traj.shape} not finite")
    ate = metrics.ate_rmse(traj, poses)
    med = statistics.median(times)
    fps = F / med
    log(f"polish: run_offline {POLISH} over {F + 1} corridor frames, cold {first_s:.3f} s, "
        f"warm runs {[round(t, 4) for t in times]} s -> {fps:.2f} fps against phase slice's "
        f"{sl['fps']:.2f} fps ({fps / sl['fps']:.3f}x)")
    log(f"polish: ATE {ate:.4f} m (bound {ATE_BOUND_M}; slice {sl['ate']:.4f} m), keyframes "
        f"{1 + int(res.is_keyframe.sum())}, rescues {counts['rescues']}, host reads/frame "
        f"{counts['host_reads'] / F:.2f}, K1 launches {counts['k1']} (slice {sl['launches']}), "
        f"K1b {counts['k1b']}, all tracked {bool(res.tracking_ok.all())}")
    check(bool(res.tracking_ok.all()),
          f"polish: tracking lost on frames {np.nonzero(~res.tracking_ok)[0] + 1}")
    check(ate < ATE_BOUND_M, f"polish: ATE {ate} m >= {ATE_BOUND_M} m")
    check(counts["k1"] > 0, "the polish path launched no K1 kernel")
    check(counts["host_reads"] == 2 * F,
          f"polish: {counts['host_reads']} host reads over {F} frames, not 2 per frame")
    check(not np.array_equal(traj, sl["trajectory"]), "polish: the trajectory is phase slice's")
    return {"k1": k1, "k1b": k1b, "counts": counts, "fps": fps, "ate": ate}


def phase_lane_cadences(torch, voc, left, right, poses, cam, worlds, slam_cfg, dev,
                        bo: dict, bs: dict) -> dict:
    """The batched lanes' other cadences on the card.  The corridor as 2
    lanes of 24 frames with ``batch_align_window`` = ALIGN_WINDOW (one cold
    run, one warm run, counts from the warm run): no keyframe off the
    window unless tracking failed, ATE per lane.  Then worlds A and B through
    ``run_offline_slam_batched(interleave=True)`` (one run, counts from it):
    lane 0 (phase 0) accepts phase batched_slam's lane 0's closures, lane 1
    (phase 1) detects on odd frames only and closes at true revisits; K1b
    for odometry, single-lane K2 and K3 for each lane's detection, K2b only
    in the lockstep frame-0 detection."""
    import dataclasses

    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.models import pipeline, slam_scan, step, step_batched
    from ros_stereo_slam_tpu_torch.utils import metrics

    base = preset_odometry()
    cfg = base.replace(camera=cam, keyframes=dataclasses.replace(
        base.keyframes, batch_align_window=ALIGN_WINDOW))
    per = FRAMES // LANES
    starts = [b * per for b in range(LANES)]
    Lc = torch.from_numpy(left).to(dev)
    Rc = torch.from_numpy(right).to(dev)
    Ls = torch.stack([Lc[s:s + per + 1] for s in starts])
    Rs = torch.stack([Rc[s:s + per + 1] for s in starts])
    gp, gm = pipeline._grid_for(cfg, dev)
    keys = step_batched.lane_keys(cfg.seed, LANES)

    def run():
        c0 = step.init_carry_batched(Ls[:, 0], Rs[:, 0], gp, gm, keys, cfg)
        return step_batched.run_sequence_batched(Ls[:, 1:], Rs[:, 1:], c0, gp, gm, cfg)

    run()
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    step.HOST_READS = step.RESCUES = 0
    t0 = time.perf_counter()
    _, st = run()
    torch.cuda.synchronize()
    align_s = time.perf_counter() - t0
    align_counts = {**_kernel_counts(), "host_reads": step.HOST_READS}
    T = st.T_wc.cpu().numpy()
    kf, ok = st.is_keyframe.cpu().numpy(), st.tracking_ok.cpu().numpy()  # (per, B)
    frame_idx = 1 + np.arange(per)
    off = kf & ok & (frame_idx % ALIGN_WINDOW != 0)[:, None]
    ates = [metrics.ate_rmse(np.concatenate([np.eye(4, dtype=np.float32)[None], T[:, b]]),
                             poses[s0:s0 + per + 1]) for b, s0 in enumerate(starts)]
    kf_idx = [(frame_idx[kf[:, b]]).tolist() for b in range(LANES)]
    align_fps = LANES * per / align_s
    log(f"lane_cadences align: {LANES} lanes x {per} frames, batch_align_window="
        f"{ALIGN_WINDOW}: keyframes at frame_idx {kf_idx} (lockstep run: "
        f"{bo['keyframes']} per lane), ATE per lane {[round(a, 4) for a in ates]} m, warm run "
        f"{align_s:.3f} s -> {align_fps:.2f} fps aggregate (phase batched_odo "
        f"{bo['fps']:.2f} fps); K1b {align_counts['k1b']}, K1 {align_counts['k1']}, host "
        f"reads/frame {align_counts['host_reads'] / per:.2f}, all tracked {bool(ok.all())}")
    check(bool(ok.all()), f"align: tracking lost at (frame, lane) {np.argwhere(~ok)}")
    check(not off.any(), f"align: keyframes off the window at (frame, lane) {np.argwhere(off)}")
    check(bool(kf.any()), "align: no keyframe after frame 0")
    check(max(ates) < ATE_BOUND_M, f"align: worst-lane ATE {max(ates)} m >= {ATE_BOUND_M} m")
    check(align_counts["k1b"] > 0 and align_counts["k1"] == 0,
          f"align: K1b {align_counts['k1b']}, K1 {align_counts['k1']}")
    check(align_counts["host_reads"] == 2 * per,
          f"align: {align_counts['host_reads']} host reads over {per} frames")

    L = torch.from_numpy(np.stack([worlds[n][0] for n in REVISIT_SEEDS])).to(dev)
    R = torch.from_numpy(np.stack([worlds[n][1] for n in REVISIT_SEEDS])).to(dev)
    F = L.shape[1] - 1
    every = max(slam_cfg.loop.detect_every, 1)
    torch.cuda.synchronize()
    _kernel_counts(reset=True)
    step.HOST_READS = 0
    t0 = time.perf_counter()
    res = slam_scan.run_offline_slam_batched(slam_cfg, voc, L, R, device=dev, interleave=True)
    torch.cuda.synchronize()
    ilv_s = time.perf_counter() - t0
    counts = {**_kernel_counts(), "host_reads": step.HOST_READS}
    detections = [sum(1 for f in range(1, F + 1) if f % every == slam_scan.lane_phase(b, every))
                  for b in range(LANES)]
    n_levels = slam_cfg.loop.orb_levels
    log(f"lane_cadences interleave: {LANES} lanes x {F + 1} revisit frames in {ilv_s:.3f} s "
        f"(one run, the first with interleave) -> {LANES * F / ilv_s:.2f} fps aggregate (phase "
        f"batched_slam {bs['fps']:.2f} fps, warm); detections per lane {detections}; launches "
        f"K1b {counts['k1b']}, K2 {counts['k2']}, K2b {counts['k2b']}, K3 {counts['k3']}, K1 "
        f"{counts['k1']}; host reads/frame {counts['host_reads'] / F:.2f}")
    lanes = []
    for b, (name, r) in enumerate(zip(REVISIT_SEEDS, res)):
        gt = worlds[name][2]
        ate, ate_odo = metrics.ate_rmse(r.trajectory, gt), metrics.ate_rmse(r.trajectory_odo, gt)
        events = [(int(q), int(m), int(n)) for q, m, n in r.loop_events]
        log(f"lane_cadences interleave lane {name} (phase {slam_scan.lane_phase(b, every)}): "
            f"ATE post-PGO {ate:.4f} m, odometry only {ate_odo:.4f} m; loop events {events} "
            f"(lockstep: {bs['lanes'][b]['events']})")
        check(bool(r.tracking_ok.all()), f"interleave lane {name}: tracking lost")
        check(len(events) >= 1, f"interleave lane {name}: no loop closure accepted")
        for q, m, _ in events:
            d = (q - m) % LAP
            check(min(d, LAP - d) <= REVISIT_TOL and q % every == slam_scan.lane_phase(b, every),
                  f"interleave lane {name}: closure ({q}, {m}) off its phase or not a revisit")
        check(ate < ate_odo, f"interleave lane {name}: post-PGO ATE {ate} m >= {ate_odo} m")
        lanes.append({"lane": name, "ate": ate, "ate_odo": ate_odo, "events": events})
    lock0 = bs["lanes"][0]
    check([e[:2] for e in lanes[0]["events"]] == [e[:2] for e in lock0["events"]],
          f"interleave lane 0 accepts {lanes[0]['events']}, lockstep {lock0['events']}")
    d0 = float(np.abs(res[0].trajectory - lock0["trajectory"]).max())
    log(f"lane_cadences interleave lane 0 against lockstep: max |dT| {d0:.3e}")
    check(d0 <= LANE_TOL_M, f"interleave lane 0's trajectory differs from lockstep by {d0}")
    check(counts["k3"] == 1 + sum(detections),
          f"K3 launched {counts['k3']} times for 1 + {sum(detections)} detections")
    check(counts["k2"] == n_levels * sum(detections) and counts["k2b"] == n_levels,
          f"K2 {counts['k2']} / K2b {counts['k2b']}: not {n_levels} a per-lane detection and "
          f"{n_levels} for frame 0's lockstep detection")
    check(counts["k1b"] > 0, "the interleaved path launched no K1b kernel")
    check(counts["host_reads"] == 2 * F, f"interleave: {counts['host_reads']} host reads")
    return {"align": {"counts": align_counts, "fps": align_fps, "ates": ates},
            "interleave": {"counts": counts, "fps": LANES * F / ilv_s, "lanes": lanes},
            "counts": {k: align_counts[k] + counts[k] for k in counts if k in align_counts}}


def _kernel_counts(reset: bool = False) -> dict:
    """K1/K1b/K2/K2b/K3 launches so far (all set to 0 first with `reset`)."""
    from ros_stereo_slam_tpu_torch.ops import lk_cuda, orb_cuda, vocab_cuda

    if reset:
        lk_cuda.LAUNCHES = lk_cuda.BATCH_LAUNCHES = vocab_cuda.LAUNCHES = 0
        orb_cuda.LAUNCHES = orb_cuda.BATCH_LAUNCHES = 0
    return dict(k1=lk_cuda.LAUNCHES, k1b=lk_cuda.BATCH_LAUNCHES, k2=orb_cuda.LAUNCHES,
                k2b=orb_cuda.BATCH_LAUNCHES, k3=vocab_cuda.LAUNCHES)


def _redispatched_detections(events, F: int, chunk: int, every: int) -> int:
    """Detection frames of the chunks that run_online_slam dispatches twice:
    the chunk after each chunk that accepted a closure."""
    n = 0
    for c in sorted({(q - 1) // chunk for q, _, _ in events}):
        lo = 1 + (c + 1) * chunk
        n += sum(1 for fid in range(lo, min(lo + chunk, F + 1)) if fid % every == 0)
    return n


def phase_online(torch, voc, left, right, gt, cfg, dev, scan: dict, smi: str) -> dict:
    """The online postures on the card over phase slam's world and
    configuration: StereoSLAM frame by frame (cold run with a checkpoint
    after CKPT_FRAME, warm runs, the checkpoint resumed in a fresh object,
    the graph and map files read back), then run_online_slam speculative
    and ChunkedSLAM.process_chunk in a loop (sequential): a cold run, then
    one warm run of each (sequential first).  Counts from the warm runs; each
    run is checked against phase slam (`scan`) and ground truth."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import slam, slam_chunked
    from ros_stereo_slam_tpu_torch.models.pose_graph import PoseGraph
    from ros_stereo_slam_tpu_torch.utils import metrics, ply

    L = torch.from_numpy(left).to(dev)
    R = torch.from_numpy(right).to(dev)
    F = L.shape[0] - 1
    every = max(cfg.loop.detect_every, 1)
    n_detect = 1 + F // every
    scan_set = [(q, m) for q, m, _ in scan["events"]]
    out_dir = ROOT / "build" / "online"
    out_dir.mkdir(parents=True, exist_ok=True)
    ckpt = str(out_dir / "stream.npz")

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    def check_run(name, traj, events, kf):
        check(traj.shape == (F + 1, 4, 4), f"{name}: trajectory shape {traj.shape}")
        check(bool(np.isfinite(traj).all()), f"{name}: non-finite poses")
        check([(q, m) for q, m, _ in events] == scan_set,
              f"{name}: closures {events} differ from phase slam's {scan_set}")
        for q, m, _ in events:
            d = (q - m) % LAP
            check(min(d, LAP - d) <= REVISIT_TOL,
                  f"{name}: closure ({q}, {m}) is not within {REVISIT_TOL} frames of a true "
                  f"revisit")
        ate = metrics.ate_rmse(traj, gt)
        check(ate < scan["ate_odo"], f"{name}: ATE {ate} m is not below odometry-only "
                                     f"{scan['ate_odo']} m")
        valid = kf.valid.cpu().numpy()
        kf_dev = float(np.abs(kf.poses.cpu().numpy()[valid]
                              - traj[kf.frame_idx.cpu().numpy()[valid]]).max())
        check(kf_dev <= KF_POSE_TOL_M, f"{name}: keyframe poses {kf_dev} m off the trajectory")
        return ate, kf_dev

    # -- streaming ------------------------------------------------------
    io_s = {}

    def stream(save_at=None):
        s = slam.StereoSLAM(cfg, voc, device=dev)
        s.initialize(L[0], R[0])
        for i in range(1, F + 1):
            s.process_frame(L[i], R[i])
            if i == save_at:
                t0 = time.perf_counter()
                s.save_checkpoint(ckpt)
                io_s["save"] = time.perf_counter() - t0
        return s

    cold, cold_s = timed_run(lambda: stream(save_at=CKPT_FRAME))
    times, counts = [], None
    for rep in range(ONLINE_WARM_RUNS):
        _kernel_counts(reset=rep == 0)
        s, t = timed_run(stream)
        times.append(t)
        if rep == 0:
            counts = _kernel_counts()
    traj = s.trajectory_array()
    events = [(e.query, e.match, e.n_inliers) for e in s.loop_events]
    ate, kf_dev = check_run("StereoSLAM", traj, events, s.keyframes)
    check(not s.tracking_failed, "StereoSLAM lost tracking")
    cold_diff = float(np.abs(cold.trajectory_array() - traj).max())
    s.save_graph(str(out_dir / "pose_graph.g2o"))
    g, _ = PoseGraph.load(str(out_dir / "pose_graph.g2o"), cfg.pgo, device=dev)
    n_pts = s.save_map(str(out_dir / "map.ply"))
    pts, _ = ply.load_ply(str(out_dir / "map.ply"))
    check((g.count, g.n_loops) == (F + 1, len(events)),
          f"g2o read back {g.count} poses, {g.n_loops} loops")
    check(len(pts) == n_pts > 0, f"map.ply read back {len(pts)} of {n_pts} points")
    resumed = slam.StereoSLAM(cfg, voc, device=dev)
    resumed.initialize(L[0], R[0])
    t0 = time.perf_counter()
    resumed.load_checkpoint(ckpt)
    io_s["load"] = time.perf_counter() - t0
    for i in range(CKPT_FRAME + 1, F + 1):
        resumed.process_frame(L[i], R[i])
    check(np.array_equal(resumed.trajectory_array(), cold.trajectory_array())
          and resumed.loop_events == cold.loop_events,
          "the run resumed from the checkpoint differs from the uninterrupted run")
    med = statistics.median(times)
    log(f"[{smi}] online StereoSLAM: {F + 1} frames, cold {cold_s:.3f} s, warm "
        f"{[round(t, 4) for t in times]} s, median {med:.4f} s -> {F / med:.2f} fps (the cold "
        f"run includes saving the checkpoint: {io_s['save']:.3f} s; loading it took "
        f"{io_s['load']:.3f} s; cold vs warm max |dT| {cold_diff:.3e}); ATE "
        f"{ate:.4f} m (odometry only {scan['ate_odo']:.4f} m); closures {events}; launches "
        f"K1 {counts['k1']}, K2 {counts['k2']}, K3 {counts['k3']} ({n_detect} detection "
        f"frames); keyframe poses within {kf_dev:.2e} m of the trajectory; resumed after frame "
        f"{CKPT_FRAME}: bitwise equal; g2o {g.count} poses {g.n_loops} loops; map {n_pts} "
        f"points")
    for k in ("k1", "k2", "k3"):
        check(counts[k] > 0, f"StereoSLAM launched no {k} kernel")
    check(counts["k3"] == n_detect,
          f"StereoSLAM launched K3 {counts['k3']} times over {n_detect} detection frames")
    stream_out = {"fps": F / med, "cold_s": cold_s, "counts": counts, "ate": ate}

    # -- chunked --------------------------------------------------------
    chunk = ONLINE_CHUNK

    def speculative():
        return slam_chunked.run_online_slam(cfg, voc, L, R, chunk=chunk, device=dev)

    def sequential():
        c = slam_chunked.ChunkedSLAM(cfg, voc, device=dev)
        c.initialize(L[0], R[0])
        n = 0
        for pos in range(1, F + 1, chunk):
            c.process_chunk(L[pos:pos + chunk], R[pos:pos + chunk],
                            query_frames=lambda fid: (L[fid], R[fid]))
            n += 1
        return c.result(n_chunks=n)

    _, cold_s = timed_run(speculative)
    runs = {"speculative": [], "sequential": []}
    counts = {}
    for name in ("sequential", "speculative"):
        first = name not in counts
        _kernel_counts(reset=first)
        res, t = timed_run(speculative if name == "speculative" else sequential)
        runs[name].append((res, t))
        if first:
            counts[name] = _kernel_counts()
    spec, seq = runs["speculative"][0][0], runs["sequential"][0][0]
    events = [(int(q), int(m), int(n)) for q, m, n in spec.loop_events]
    ate_c, kf_dev_c = check_run("run_online_slam", spec.trajectory, events, spec.keyframes)
    check(spec.n_corrections >= 1, "run_online_slam applied no correction")
    check(bool(spec.tracking_ok.all()), "run_online_slam lost tracking")
    same = (np.array_equal(spec.trajectory, seq.trajectory)
            and all(torch.equal(a, b) for a, b in zip(spec.keyframes, seq.keyframes))
            and spec.loop_events == seq.loop_events)
    check(same, "the speculative and the sequential chunked runs differ")
    extra = _redispatched_detections(events, F, chunk, every)
    med_spec = statistics.median(t for _, t in runs["speculative"])
    med_seq = statistics.median(t for _, t in runs["sequential"])
    cs, cq = counts["speculative"], counts["sequential"]
    log(f"[{smi}] online run_online_slam(chunk={chunk}): cold {cold_s:.3f} s; speculative "
        f"warm {[round(t, 4) for _, t in runs['speculative']]} s, median {med_spec:.4f} s -> "
        f"{F / med_spec:.2f} fps; sequential warm "
        f"{[round(t, 4) for _, t in runs['sequential']]} s, median {med_seq:.4f} s -> "
        f"{F / med_seq:.2f} fps; speculative / sequential {med_spec / med_seq:.4f}")
    log(f"[{smi}] online run_online_slam: {spec.n_chunks} chunks, {spec.n_corrections} "
        f"corrections, closures {events}; ATE {ate_c:.4f} m (odometry only "
        f"{scan['ate_odo']:.4f} m); keyframe poses within {kf_dev_c:.2e} m of the trajectory; "
        f"launches speculative K1 {cs['k1']}, K2 {cs['k2']}, K3 {cs['k3']} ({n_detect} "
        f"detection frames + {extra} in re-dispatched chunks), sequential K1 {cq['k1']}, K2 "
        f"{cq['k2']}, K3 {cq['k3']}; speculative = sequential bitwise (trajectory, keyframes)")
    for form, c in counts.items():
        for k in ("k1", "k2", "k3"):
            check(c[k] > 0, f"the {form} chunked run launched no {k} kernel")
    check(cs["k3"] == n_detect + extra,
          f"run_online_slam launched K3 {cs['k3']} times, not {n_detect} + {extra}")
    check(cq["k3"] == n_detect,
          f"the sequential chunked run launched K3 {cq['k3']} times over {n_detect} frames")
    return {"stream": stream_out,
            "chunked": {"fps": F / med_spec, "fps_sequential": F / med_seq, "cold_s": cold_s,
                        "counts": counts, "ate": ate_c, "corrections": spec.n_corrections}}


def _bilinear_host(img, pts):
    """Float64 bilinear samples of an (H, W, C) image at (N, 2) (x, y)
    points, clamped as the step clamps them."""
    import numpy as np

    h, w = img.shape[:2]
    x = np.clip(pts[:, 0].astype(np.float64), 0.0, w - 1.001)
    y = np.clip(pts[:, 1].astype(np.float64), 0.0, h - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    im = img.astype(np.float64)
    return ((1 - fy) * ((1 - fx) * im[y0, x0] + fx * im[y0, x0 + 1])
            + fy * ((1 - fx) * im[y0 + 1, x0] + fx * im[y0 + 1, x0 + 1]))


def phase_mapping(torch, left, right, rgb8, cam, dev, sl: dict, smi: str) -> dict:
    """Config 2 on the card: preset_mapping() through run_offline over the
    corridor, its RGB frames staged as uint8; one cold run, then warm
    runs, K1 counted over the first warm run."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_mapping
    from ros_stereo_slam_tpu_torch.models import pipeline, step
    from ros_stereo_slam_tpu_torch.ops import lk_cuda
    from ros_stereo_slam_tpu_torch.utils import ply

    cfg = preset_mapping().replace(camera=cam)
    L, R = (torch.from_numpy(a).to(dev) for a in (left, right))
    RGB = torch.from_numpy(rgb8).to(dev)
    F = L.shape[0] - 1

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.run_offline(cfg, L, R, device=dev, rgb_seq=RGB)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold_s = run()
    times, launches = [], None
    for rep in range(MAPPING_WARM_RUNS):
        if rep == 0:
            lk_cuda.LAUNCHES = step.HOST_READS = 0
        res, t = run()
        times.append(t)
        if rep == 0:
            launches, host_reads = lk_cuda.LAUNCHES, step.HOST_READS
    traj_diff = float(np.abs(res.trajectory - sl["trajectory"]).max())
    kf = res.keyframes
    m0 = kf.point_mask[0].cpu().numpy()
    want = _bilinear_host(rgb8[0].astype(np.float64) / 255.0,
                          pipeline._grid_for(cfg, "cpu")[0].numpy())
    colour_err = float(np.abs(kf.colors[0].cpu().numpy()[m0] - want[m0]).max())
    pts, cols = pipeline.map_points_of(kf)
    spread = float(np.abs(cols[:, 0] - cols[:, 2]).mean())
    out_dir = ROOT / "build" / "mapping"
    out_dir.mkdir(parents=True, exist_ok=True)
    n_pts = ply.save_ply(str(out_dir / "map.ply"), pts, cols)
    back, back_cols = ply.load_ply(str(out_dir / "map.ply"))
    med = statistics.median(times)
    log(f"[{smi}] mapping: preset_mapping(), {F + 1} corridor frames "
        f"{left.shape[2]}x{left.shape[1]} + uint8 RGB ({RGB.numel() / 1e6:.1f} MB on the card), "
        f"cold {cold_s:.3f} s, warm {[round(t, 4) for t in times]} s, median {med:.4f} s -> "
        f"{F / med:.2f} fps ({F / med / sl['fps']:.3f}x phase slice's); K1 launches {launches}, "
        f"host reads/frame {host_reads / F:.2f}; max |dT| vs phase slice {traj_diff:.3e}; "
        f"keyframe 0 colours vs host bilinear {colour_err:.2e} (bound {COLOUR_ATOL}); mean "
        f"|R - B| {spread:.4f}; map {n_pts} points, PLY read back {len(back)}")
    check(bool(res.tracking_ok.all()), "mapping: tracking lost")
    check(np.array_equal(res.trajectory, sl["trajectory"]),
          f"mapping: the trajectory differs from phase slice's by {traj_diff}")
    check(colour_err <= COLOUR_ATOL, f"mapping: keyframe 0 colours off by {colour_err}")
    check(spread > 0.02, f"mapping: the map is effectively gray (mean |R - B| {spread})")
    check(back_cols is not None and len(back) == n_pts == len(pts) > 0,
          f"mapping: PLY read back {len(back)} of {n_pts} points")
    check(launches > 0, "mapping: the path launched no K1 kernel")
    return {"fps": F / med, "launches": launches, "n_points": n_pts}


class _BATimer:
    """CUDA events around every ``step._ba_refine`` call while active (the
    window push, the solve of every lane, the refined pose read)."""

    def __init__(self, torch):
        self.torch = torch
        self.events = []

    def __enter__(self):
        from ros_stereo_slam_tpu_torch.models import step

        self._orig = step._ba_refine

        def timed(*args):
            start = self.torch.cuda.Event(enable_timing=True)
            end = self.torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*args)
            end.record()
            self.events.append((start, end))
            return out

        step._ba_refine = timed
        return self

    def __exit__(self, *exc):
        from ros_stereo_slam_tpu_torch.models import step

        step._ba_refine = self._orig

    def ms(self) -> list:
        self.torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e in self.events]


def phase_ba(torch, voc, left, right, poses, cam, dev, sl: dict, rl, rr, rgt, smi: str) -> dict:
    """Config 4 on the card: preset_ba() through run_offline over the
    corridor, through the batched step as 2 lanes, and through StereoSLAM
    over world A's frames 0-BA_SLAM_FRAMES.  Each: one cold run, then warm
    runs; counts over the first warm run; BA's ms per frame from CUDA
    events around step._ba_refine on the warm runs."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_ba
    from ros_stereo_slam_tpu_torch.models import pipeline, slam, step, step_batched
    from ros_stereo_slam_tpu_torch.ops import lk_cuda
    from ros_stereo_slam_tpu_torch.utils import metrics

    cfg = preset_ba().replace(camera=cam)
    L, R = (torch.from_numpy(a).to(dev) for a in (left, right))
    F = L.shape[0] - 1

    def timed_run(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # -- run_offline over the corridor ---------------------------------
    def offline():
        return pipeline.run_offline(cfg, L, R, device=dev)

    _, cold_s = timed_run(offline)
    times, counts = [], None
    with _BATimer(torch) as timer:
        for rep in range(BA_WARM_RUNS):
            if rep == 0:
                _kernel_counts(reset=True)
                step.HOST_READS = 0
            res, t = timed_run(offline)
            times.append(t)
            if rep == 0:
                counts = dict(_kernel_counts(), host_reads=step.HOST_READS)
    ba_ms = timer.ms()
    med = statistics.median(times)
    ate = metrics.ate_rmse(res.trajectory, poses)
    bound = max(1.5 * sl["ate"], 0.05)
    pts, _ = pipeline.map_points_of(res.keyframes)
    log(f"[{smi}] ba offline: preset_ba() (window {cfg.ba.window}, {cfg.ba.iters} GN "
        f"iterations), {F + 1} corridor frames {left.shape[2]}x{left.shape[1]}, cold "
        f"{cold_s:.3f} s, warm {[round(t, 4) for t in times]} s, median {med:.4f} s -> "
        f"{F / med:.2f} fps ({F / med / sl['fps']:.3f}x phase slice's); ATE {ate:.4f} m "
        f"(bound {bound:.4f}: max(1.5 x slice's {sl['ate']:.4f}, 0.05)); BA ms/frame median "
        f"{statistics.median(ba_ms):.3f}, mean {statistics.fmean(ba_ms):.3f}, max "
        f"{max(ba_ms):.3f} over {len(ba_ms)} frames; ba_rms {float(res.ba_rms.min()):.3f}-"
        f"{float(res.ba_rms.max()):.3f} px; keyframes {1 + int(res.is_keyframe.sum())}; "
        f"K1 launches {counts['k1']}; host reads/frame {counts['host_reads'] / F:.2f}")
    check(bool(res.tracking_ok.all()),
          f"ba offline: tracking lost on frames {np.nonzero(~res.tracking_ok)[0] + 1}")
    check(ate < bound, f"ba offline: ATE {ate} m >= {bound} m")
    check(bool(np.isfinite(res.ba_rms).all()), "ba offline: non-finite ba_rms")
    check(bool(np.isfinite(pts).all()) and len(pts) > 0, "ba offline: non-finite map")
    check(counts["host_reads"] == sl["host_reads"],
          f"ba offline: {counts['host_reads']} host reads, phase slice {sl['host_reads']}")
    check(counts["k1"] > 0, "ba offline: the path launched no K1 kernel")
    offline_out = {"fps": F / med, "ate": ate, "ba_ms": statistics.median(ba_ms),
                   "counts": counts}

    # -- 2 lanes (bench.py's --lanes 2 split) ---------------------------
    per = FRAMES // LANES
    Ls = torch.stack([L[b * per:(b + 1) * per + 1] for b in range(LANES)])
    Rs = torch.stack([R[b * per:(b + 1) * per + 1] for b in range(LANES)])
    gp, gm = pipeline._grid_for(cfg, dev)
    keys = step_batched.lane_keys(cfg.seed, LANES)

    def lanes():
        c0 = step.init_carry_batched(Ls[:, 0], Rs[:, 0], gp, gm, keys, cfg)
        return step_batched.run_sequence_batched(Ls[:, 1:], Rs[:, 1:], c0, gp, gm, cfg)

    _, cold_l = timed_run(lanes)
    lk_cuda.LAUNCHES = lk_cuda.BATCH_LAUNCHES = 0
    with _BATimer(torch) as timer:
        (cN, st), t_l = timed_run(lanes)
    ba_ms_l = timer.ms()
    k1b, k1_l = lk_cuda.BATCH_LAUNCHES, lk_cuda.LAUNCHES
    diffs, equal = [], True
    for b in range(LANES):
        c = step.init_carry(Ls[b, 0], Rs[b, 0], gp, gm, keys[b], cfg)
        cs, ss = step.run_sequence(Ls[b, 1:], Rs[b, 1:], c, gp, gm, cfg)
        diffs.append(max(float((st.T_wc[:, b] - ss.T_wc).abs().max()),
                         float((st.ba_rms[:, b] - ss.ba_rms).abs().max())))
        equal &= all(torch.equal(getattr(st, n)[:, b], getattr(ss, n)) for n in ss._fields)
        equal &= all(torch.equal(x[b], y) for x, y in zip(cN.ba, cs.ba))
    kf_lanes = (st.is_keyframe.sum(0) + 1).tolist()
    log(f"[{smi}] ba lanes: {LANES} lanes x {per} frames, cold {cold_l:.3f} s, warm "
        f"{t_l:.4f} s -> {LANES * per / t_l:.2f} fps aggregate; BA ms/frame (all lanes) median "
        f"{statistics.median(ba_ms_l):.3f}; keyframes per lane {kf_lanes}; K1b launches {k1b}, "
        f"K1 {k1_l}; max |difference| vs the single-lane runs per lane "
        f"{[f'{d:.2e}' for d in diffs]} (T_wc, ba_rms); bitwise equal {equal}")
    check(bool(st.tracking_ok.all()), "ba lanes: tracking lost")
    check(equal, f"ba lanes: a lane differs from its single-lane run ({diffs})")
    check(k1b > 0, "ba lanes: the batched path launched no K1b kernel")
    lanes_out = {"fps": LANES * per / t_l, "k1b": k1b, "lane_diff": max(diffs)}

    # -- StereoSLAM over world A's frames 0-BA_SLAM_FRAMES ---------------
    n = BA_SLAM_FRAMES
    SL, SR = (torch.from_numpy(a[:n + 1]).to(dev) for a in (rl, rr))
    gt = rgt[:n + 1]
    ckpt = str(ROOT / "build" / "online" / "stream_ba.npz")
    (ROOT / "build" / "online").mkdir(parents=True, exist_ok=True)

    def stream(save_at=None):
        s = slam.StereoSLAM(cfg, voc, device=dev)
        s.initialize(SL[0], SR[0])
        for i in range(1, n + 1):
            s.process_frame(SL[i], SR[i])
            if i == save_at:
                s.save_checkpoint(ckpt)
        return s

    cold, cold_st = timed_run(lambda: stream(save_at=CKPT_FRAME))
    _kernel_counts(reset=True)
    with _BATimer(torch) as timer:
        s, t_s = timed_run(stream)
    counts_s = _kernel_counts()
    ba_ms_s = timer.ms()
    traj = s.trajectory_array()
    g = s.graph
    Z = g.odo_Z[:g.count].double().cpu().numpy()
    odo = np.empty_like(Z)
    odo[0] = np.eye(4)
    for i in range(1, len(Z)):
        odo[i] = odo[i - 1] @ Z[i]
    ate_s, ate_odo = metrics.ate_rmse(traj, gt), metrics.ate_rmse(odo, gt)
    events = [(e.query, e.match, e.n_inliers) for e in s.loop_events]
    resumed = slam.StereoSLAM(cfg, voc, device=dev)
    resumed.initialize(SL[0], SR[0])
    resumed.load_checkpoint(ckpt)
    for i in range(CKPT_FRAME + 1, n + 1):
        resumed.process_frame(SL[i], SR[i])
    same = (np.array_equal(resumed.trajectory_array(), cold.trajectory_array())
            and resumed.loop_events == cold.loop_events
            and all(torch.equal(x, y) for x, y in zip(resumed._carry.ba, cold._carry.ba)))
    cold_diff = float(np.abs(cold.trajectory_array() - traj).max())
    log(f"[{smi}] ba StereoSLAM: preset_ba(), world A frames 0-{n}, cold {cold_st:.3f} s (with "
        f"the checkpoint), warm {t_s:.4f} s -> {n / t_s:.2f} fps; ATE {ate_s:.4f} m, its "
        f"odometry chain {ate_odo:.4f} m; closures {events}; BA ms/frame median "
        f"{statistics.median(ba_ms_s):.3f}, mean {statistics.fmean(ba_ms_s):.3f}; launches K1 "
        f"{counts_s['k1']}, K2 {counts_s['k2']}, K3 {counts_s['k3']}; cold vs warm max |dT| "
        f"{cold_diff:.3e}; resumed after frame {CKPT_FRAME}: bitwise equal {same}")
    check(not s.tracking_failed, "ba StereoSLAM lost tracking")
    check(len(events) >= 1, "ba StereoSLAM: no loop closure accepted")
    for q, m, _ in events:
        d = (q - m) % LAP
        check(min(d, LAP - d) <= REVISIT_TOL,
              f"ba StereoSLAM: closure ({q}, {m}) is not within {REVISIT_TOL} frames of a true "
              f"revisit")
    check(ate_s < ate_odo, f"ba StereoSLAM: ATE {ate_s} m is not below its odometry chain's "
                           f"{ate_odo} m")
    check(same, "ba StereoSLAM: the run resumed from the checkpoint differs")
    for k in ("k1", "k2", "k3"):
        check(counts_s[k] > 0, f"ba StereoSLAM launched no {k} kernel")
    return {"offline": offline_out, "lanes": lanes_out,
            "stream": {"fps": n / t_s, "ate": ate_s, "ate_odo": ate_odo, "events": events,
                       "ba_ms": statistics.median(ba_ms_s), "counts": counts_s, "run": s}}


def _frontend_cfg(cam, overrides: dict):
    import dataclasses

    from ros_stereo_slam_tpu_torch.config import preset_odometry

    base = preset_odometry()
    return base.replace(camera=cam, frontend=dataclasses.replace(base.frontend, **overrides))


def phase_frontend(torch, name: str, overrides: dict, left, right, poses, cam, dev, sl: dict,
                   smi: str) -> dict:
    """One frontend choice through run_offline over the corridor: a cold
    run, then warm runs, every counter from the first warm run."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import pipeline, step
    from ros_stereo_slam_tpu_torch.utils import metrics

    cfg = _frontend_cfg(cam, overrides)
    L, R = (torch.from_numpy(a).to(dev) for a in (left, right))
    F = L.shape[0] - 1

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipeline.run_offline(cfg, L, R, device=dev)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold_s = run()
    times = []
    for rep in range(FRONTEND_WARM_RUNS):
        if rep == 0:
            _kernel_counts(reset=True)
            step.HOST_READS = step.RESCUES = 0
        res, t = run()
        times.append(t)
        if rep == 0:
            counts = dict(_kernel_counts(), host_reads=step.HOST_READS, rescues=step.RESCUES)
    traj = res.trajectory
    check(traj.shape == (F + 1, 4, 4) and bool(np.isfinite(traj).all()),
          f"{name}: trajectory {traj.shape} not finite")
    ate = metrics.ate_rmse(traj, poses)
    n_kf = 1 + int(res.is_keyframe.sum())
    med = statistics.median(times)
    log(f"[{smi}] {name}: {overrides}, {F + 1} corridor frames {left.shape[2]}x{left.shape[1]}, "
        f"cold {cold_s:.3f} s, warm {[round(t, 4) for t in times]} s, median {med:.4f} s -> "
        f"{F / med:.2f} fps ({F / med / sl['fps']:.3f}x phase slice's); ATE {ate:.4f} m (bound "
        f"{ATE_BOUND_M}; phase slice {sl['ate']:.4f}); keyframes {n_kf}; rescues "
        f"{counts['rescues']}; host reads/frame {counts['host_reads'] / F:.2f}; launches K1 "
        f"{counts['k1']}, K1b {counts['k1b']}, K2 {counts['k2']}, K2b {counts['k2b']}; min "
        f"inliers {int(res.n_inliers.min())}; all tracked {bool(res.tracking_ok.all())}")
    check(bool(res.tracking_ok.all()),
          f"{name}: tracking lost on frames {np.nonzero(~res.tracking_ok)[0] + 1}")
    check(ate < ATE_BOUND_M, f"{name}: ATE {ate} m >= {ATE_BOUND_M} m")
    check(counts["host_reads"] == 2 * F,
          f"{name}: {counts['host_reads']} host reads over {F} frames, not 2 per frame")
    check(counts["k1"] > 0, f"{name}: the path launched no K1 kernel")
    orb_route = cfg.frontend.stereo_matcher == "orb"
    check(counts["k2"] == (2 * n_kf if orb_route else 0),
          f"{name}: K2 launched {counts['k2']} times for {n_kf} keyframes")
    check(counts["k1b"] == counts["k2b"] == 0, f"{name}: a lane-gridded kernel launched")
    return {"fps": F / med, "ate": ate, "keyframes": n_kf, "counts": counts,
            "trajectory": traj, "cfg": cfg}


def phase_orb_stereo_lanes(torch, left, right, poses, cam, dev, smi: str) -> dict:
    """ORB stereo as 2 lanes of 24 corridor frames through
    run_sequence_batched (K1b, K2b): a cold run and a warm run, counters
    from the warm run; each lane bitwise equal to its single-lane run with
    the lane's key."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import pipeline, step, step_batched
    from ros_stereo_slam_tpu_torch.utils import metrics

    cfg = _frontend_cfg(cam, ORB_STEREO)
    per = FRAMES // LANES
    L, R = (torch.from_numpy(a).to(dev) for a in (left, right))
    Ls = torch.stack([L[b * per:(b + 1) * per + 1] for b in range(LANES)])
    Rs = torch.stack([R[b * per:(b + 1) * per + 1] for b in range(LANES)])
    gp, gm = pipeline._grid_for(cfg, dev)
    keys = step_batched.lane_keys(cfg.seed, LANES)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c0 = step.init_carry_batched(Ls[:, 0], Rs[:, 0], gp, gm, keys, cfg)
        out = step_batched.run_sequence_batched(Ls[:, 1:], Rs[:, 1:], c0, gp, gm, cfg)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    _, cold_s = run()
    _kernel_counts(reset=True)
    step.HOST_READS = 0
    (cN, st), t = run()
    counts = dict(_kernel_counts(), host_reads=step.HOST_READS)
    equal, ates = True, []
    for b in range(LANES):
        c = step.init_carry(Ls[b, 0], Rs[b, 0], gp, gm, keys[b], cfg)
        cs, ss = step.run_sequence(Ls[b, 1:], Rs[b, 1:], c, gp, gm, cfg)
        equal &= all(torch.equal(getattr(st, n)[:, b], getattr(ss, n)) for n in ss._fields)
        equal &= all(torch.equal(x[b], y) for x, y in zip(cN.keyframes, cs.keyframes))
        T = np.concatenate([np.eye(4, dtype=np.float32)[None], st.T_wc[:, b].cpu().numpy()])
        ates.append(metrics.ate_rmse(T, poses[b * per:(b + 1) * per + 1]))
    kf_frames = int(st.is_keyframe.any(1).sum())  # frames where any lane took the branch
    log(f"[{smi}] orb_stereo lanes: {LANES} lanes x {per} frames, cold {cold_s:.3f} s, warm "
        f"{t:.4f} s -> {LANES * per / t:.2f} fps aggregate; ATE per lane "
        f"{[round(a, 4) for a in ates]} m; keyframes per lane "
        f"{(st.is_keyframe.sum(0) + 1).tolist()}, frames with a keyframe branch {kf_frames}; "
        f"host reads/frame {counts['host_reads'] / per:.2f}; launches K1b {counts['k1b']}, K2b "
        f"{counts['k2b']}, K1 {counts['k1']}, K2 {counts['k2']}; lanes bitwise equal to their "
        f"single-lane runs {equal}")
    check(bool(st.tracking_ok.all()), "orb_stereo lanes: tracking lost")
    check(max(ates) < ATE_BOUND_M, f"orb_stereo lanes: worst-lane ATE {max(ates)} m")
    check(equal, "orb_stereo lanes: a lane differs from its single-lane run")
    check(counts["host_reads"] == 2 * per, f"orb_stereo lanes: {counts['host_reads']} host reads")
    check(counts["k1b"] > 0 and counts["k1"] == 0,
          f"orb_stereo lanes: K1b {counts['k1b']}, K1 {counts['k1']}")
    check(counts["k2b"] == 2 * (1 + kf_frames) and counts["k2"] == 0,
          f"orb_stereo lanes: K2b {counts['k2b']} for {1 + kf_frames} keyframe branches, "
          f"K2 {counts['k2']}")
    return {"fps": LANES * per / t, "counts": counts, "ate_worst": max(ates)}


def phase_stereo_depth(torch, left, right, depth, cam, dev, smi: str) -> dict:
    """The dense-disparity node on corridor pair 0: SGBM against the
    depth oracle, the card against the CPU on a crop, the cloud -> SOR ->
    PLY flow; SGBM milliseconds split between the cost volume, the
    aggregation and the selection (CUDA events, median of 5 after a warm-up)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import sgbm
    from ros_stereo_slam_tpu_torch.utils import ply

    L, R = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (left[0], right[0]))
    D = SGBM_MAX_DISP
    parts = {"cost_volume": lambda: sgbm.cost_volume(L, R, D, SGBM_BLOCK)}
    vol = parts["cost_volume"]()
    parts["aggregation"] = lambda: sgbm.aggregate(vol, 0.03, 0.12)
    agg = parts["aggregation"]()
    parts["selection"] = lambda: sgbm.select_disparity(agg, D)
    ms = {k: cuda_ms(torch, fn, reps=5) for k, fn in parts.items()}
    torch.cuda.reset_peak_memory_stats()
    res = sgbm.sgbm(L, R, max_disp=D, block=SGBM_BLOCK)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    disp, valid = res.disparity.cpu().numpy(), res.valid.cpu().numpy()
    gt = cam.fx * cam.baseline / depth
    H, W = disp.shape
    m = valid.copy()
    m[:10] = m[-10:] = False
    m[:, :70] = m[:, -10:] = False
    m &= (gt > 2.0) & (gt < 60.0)
    err = np.abs(disp[m] - gt[m])
    share, med, bad = m.sum() / (H * W), float(np.median(err)), float((err > 3.0).mean())

    rows, cols = SGBM_CROP
    crop = [np.ascontiguousarray(a[0][rows, cols]) for a in (left, right)]
    on_card = sgbm.sgbm(*(torch.from_numpy(c).to(dev) for c in crop), max_disp=D)
    on_cpu = sgbm.sgbm(*(torch.from_numpy(c) for c in crop), max_disp=D)
    cv, cd = on_card.valid.cpu().numpy(), on_card.disparity.cpu().numpy()
    same_valid = bool(np.array_equal(cv, on_cpu.valid.numpy()))
    crop_err = float(np.abs(cd - on_cpu.disparity.numpy()).max())

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, pts = sgbm.depth_cloud(L, R, pinhole(cam), float(cam.baseline), max_disp=D,
                              block=SGBM_BLOCK)
    torch.cuda.synchronize()
    flow_s = time.perf_counter() - t0
    out_dir = ROOT / "build" / "stereo_depth"
    out_dir.mkdir(parents=True, exist_ok=True)
    n_out = ply.save_ply(str(out_dir / "StereoCloud.ply"), pts.cpu().numpy())
    back, _ = ply.load_ply(str(out_dir / "StereoCloud.ply"))
    total = sum(ms.values())
    log(f"[{smi}] stereo_depth: SGBM {W}x{H}, {D} disparities, block {SGBM_BLOCK}: "
        f"{total:.3f} ms = cost volume {ms['cost_volume']:.3f} + aggregation "
        f"{ms['aggregation']:.3f} + selection {ms['selection']:.3f} (median of 5, CUDA events); "
        f"peak memory {peak_gb:.3f} GB; valid {share:.4f} (bound > {SGBM_MIN_VALID}), median "
        f"error {med:.4f} px (bound < {SGBM_MAX_MEDIAN_PX}), bad-pixel rate {bad:.4f} (bound < "
        f"{SGBM_MAX_BAD}); crop {crop[0].shape[1]}x{crop[0].shape[0]} card vs CPU: same valid "
        f"{same_valid} ({int(cv.sum())} px), max |d| {crop_err:.2e} px (bound "
        f"{SGBM_CROP_ATOL}); depth_cloud {flow_s:.3f} s, {n_out} points after SOR, PLY read "
        f"back {len(back)}")
    check(share > SGBM_MIN_VALID, f"stereo_depth: valid share {share}")
    check(med < SGBM_MAX_MEDIAN_PX, f"stereo_depth: median disparity error {med} px")
    check(bad < SGBM_MAX_BAD, f"stereo_depth: bad-pixel rate {bad}")
    check(same_valid and cv.sum() > 0,
          "stereo_depth: the card's valid pixels differ from the CPU's")
    check(crop_err <= SGBM_CROP_ATOL, f"stereo_depth: card vs CPU disparity {crop_err} px")
    check(len(back) == n_out == pts.shape[0] > 0, f"stereo_depth: PLY read back {len(back)}")
    return {"ms": ms, "total_ms": total, "points": n_out}


def pinhole(cam):
    """The port's Pinhole of a CameraConfig."""
    from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

    return Pinhole(fx=float(cam.fx), fy=float(cam.fy), cx=float(cam.cx), cy=float(cam.cy))


def corridor_tracks(torch, left0, left1, cam, dev):
    """``preset_odometry()``'s grid tracked by LK from (H, W) frame `left0`
    to `left1` on `dev`: (grid points, tracked points, valid)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.models import frontend, pipeline
    from ros_stereo_slam_tpu_torch.ops import lk, pyramid

    cfg = preset_odometry().replace(camera=cam)
    fe = cfg.frontend
    gp, gm = pipeline._grid_for(cfg, dev)
    L0, L1 = (torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (left0, left1))
    tr = lk.track(tuple(pyramid.build_pyramid(L0[None], fe.lk_levels)),
                  tuple(pyramid.build_pyramid(L1[None], fe.lk_levels)), gp[None], None,
                  frontend._lk_params(fe))
    return gp, tr.points[0].contiguous(), gm & tr.valid[0]


def _exact_correspondences(pts, depth, T21, cam):
    """The grid points of frame 0 projected into frame 1 through the depth
    oracle and the true motion: (pts1, pts2, valid) as numpy arrays."""
    import numpy as np

    z = depth[np.clip(pts[:, 1].astype(int), 0, cam.height - 1),
              np.clip(pts[:, 0].astype(int), 0, cam.width - 1)]
    P = np.stack([(pts[:, 0] - cam.cx) / cam.fx * z, (pts[:, 1] - cam.cy) / cam.fy * z, z], 1)
    P2 = P @ T21[:3, :3].T + T21[:3, 3]
    uv2 = np.stack([P2[:, 0] / P2[:, 2] * cam.fx + cam.cx, P2[:, 1] / P2[:, 2] * cam.fy + cam.cy],
                   1)
    m = ((P2[:, 2] > 0.1) & (uv2[:, 0] >= 0) & (uv2[:, 0] < cam.width) & (uv2[:, 1] >= 0)
         & (uv2[:, 1] < cam.height) & np.isfinite(z))
    return pts.astype(np.float32), uv2.astype(np.float32), m


def _skew(t):
    """[t]x of (..., 3) t."""
    import numpy as np

    z = np.zeros(t.shape[:-1])
    return np.stack([np.stack([z, -t[..., 2], t[..., 1]], -1),
                     np.stack([t[..., 2], z, -t[..., 0]], -1),
                     np.stack([-t[..., 1], t[..., 0], z], -1)], -2)


def _pose_inliers(torch, E, pin, pts1, pts2, m, thr: float):
    """Tracks within the solve's threshold of each (..., 3, 3) E, in float64
    on the host."""
    from ros_stereo_slam_tpu_torch.ops import essential, ransac

    x1h, x2h = (torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype)], 1)
                for x in (essential.normalized_coords(pin, p.cpu().double())
                          for p in (pts1, pts2)))
    err = ransac.sampson_distance(torch.as_tensor(E, dtype=torch.float64), x1h, x2h)
    return ((err < thr) & m.cpu()).sum(-1)


def phase_essential(torch, left, depth0, poses, cam, dev, smi: str) -> dict:
    """The monocular utilities on corridor frames 0 -> 1.  LK tracks of
    the grid (K1): ``monocular_triangulate`` on the card, and the solve on
    the card and on the CPU from the same index sets, each held to the
    bounds of the JAX package's spread on these tracks, and the card's
    hypotheses to the CPU's through a float64 witness.  The grid projected
    through the depth oracle (exact correspondences): the card and the CPU
    on the same index sets, equal inliers, R and unit t within tolerance,
    the rotation within a bound that R = I fails."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import essential, lk_cuda, ransac

    T21 = np.linalg.inv(poses[1]) @ poses[0]
    t_gt = T21[:3, 3] / np.linalg.norm(T21[:3, 3])
    true_deg = float(np.degrees(np.arccos(np.clip((np.trace(T21[:3, :3]) - 1) / 2, -1, 1))))
    pin = pinhole(cam)

    def rot_err(rp):
        R = rp.R.cpu().double().numpy()
        return float(np.degrees(np.arccos(np.clip((np.trace(T21[:3, :3].T @ R) - 1) / 2,
                                                  -1, 1))))

    def t_dot(rp):
        return abs(float(rp.t.cpu().double().numpy() @ t_gt))

    def sets(m, seed):
        return ransac._sample_minimal_sets(torch.Generator().manual_seed(seed),
                                           torch.as_tensor(m).cpu(), 256, 8)

    def on_both(pts1, pts2, m, idx):
        """The solve from one set of index sets, on the card and on the CPU."""
        outs = []
        for d in (dev, torch.device("cpu")):
            a = [torch.as_tensor(x).to(d) for x in (pts1, pts2, m)]
            e = essential._essential_from_sets(idx.to(d), pin, *a, 1.0)
            outs.append((e, essential.recover_pose(e.E, pin, *a[:2], e.inliers)))
        return outs

    lk_cuda.LAUNCHES = 0
    pts1, pts2, m = corridor_tracks(torch, left[0], left[1], cam, dev)
    k1 = lk_cuda.LAUNCHES
    n_valid = int(m.sum())
    gen = torch.Generator(device=dev).manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    er, rp = essential.monocular_triangulate(gen, pin, pts1, pts2, m, 1.0, 256)
    torch.cuda.synchronize()
    mono_ms = (time.perf_counter() - t0) * 1e3
    idx = sets(m, 0)
    (ec, rc), (eh, rh) = on_both(pts1, pts2, m, idx)
    host64 = [x.cpu().double() for x in (pts1, pts2)] + [m.cpu()]
    e64 = essential._essential_from_sets(idx, pin, *host64, 1.0)
    r64 = essential.recover_pose(e64.E, pin, *host64[:2], e64.inliers)
    runs = {"card": (er, rp), "card, CPU's sets": (ec, rc), "CPU": (eh, rh),
            "float64 host, same sets": (e64, r64)}
    # R = I against the tracks: with the true t, and with the best t over
    # a grid of directions (2 deg steps).
    th, ph = np.meshgrid(np.radians(np.arange(0, 181, 2)), np.radians(np.arange(0, 360, 2)))
    dirs = np.stack([np.sin(th) * np.cos(ph), np.sin(th) * np.sin(ph), np.cos(th)], -1)
    thr = essential._threshold(pin, 1.0)
    truth_inl = int(_pose_inliers(torch, _skew(t_gt) @ T21[:3, :3], pin, *host64, thr))
    eye_true_t = int(_pose_inliers(torch, _skew(t_gt), pin, *host64, thr))
    eye_best = int(_pose_inliers(torch, _skew(dirs.reshape(-1, 3)), pin, *host64, thr).max())
    log(f"[{smi}] essential, LK tracks: corridor frames 0 -> 1 (true rotation {true_deg:.4f} "
        f"deg), {n_valid} of {pts1.shape[0]} grid points tracked (K1 launches {k1}); "
        f"monocular_triangulate on the card {mono_ms:.1f} ms (one call, host clock); "
        f"(inliers, rotation error deg, |t . t_gt|): "
        + ", ".join(f"{k} ({int(e.n_inliers)}, {rot_err(r):.4f}, {t_dot(r):.5f})"
                    for k, (e, r) in runs.items())
        + f"; bounds > {ESS_TRACK_MIN_INLIERS} x valid, < {ESS_TRACK_ROT_DEG} deg; tracks "
        f"within 1 px of the true pose {truth_inl}, of R = I with the true t {eye_true_t}, "
        f"with the best t {eye_best}")
    check(k1 > 0, "essential: the LK tracks launched no K1 kernel")
    for k, (e, r) in list(runs.items())[:3]:  # the float64 run is the witness
        check(int(e.n_inliers) > ESS_TRACK_MIN_INLIERS * n_valid and rot_err(r) < ESS_TRACK_ROT_DEG,
              f"essential ({k}): {int(e.n_inliers)} of {n_valid} inliers, {rot_err(r)} deg")

    # The float64 witness: the 256 hypotheses of the CPU's sets, their MSAC
    # scores on the card, on the CPU and in float64 on the host, in units
    # of the threshold.
    s_c, s_h, s_64 = (essential._hypotheses(idx.to(a[0].device), pin, *a, 1.0)[2].cpu().double()
                      / thr for a in ([pts1, pts2, m], [x.cpu() for x in (pts1, pts2, m)],
                                      host64))
    win = {k: int(torch.argmin(s)) for k, s in (("card", s_c), ("CPU", s_h), ("float64", s_64))}
    dev_c, dev_h = (s_c - s_64).abs(), (s_h - s_64).abs()
    ratio = float(dev_c.median() / dev_h.median().clamp(min=1e-12))
    top = torch.argsort(s_64)[:5].tolist()
    log(f"[{smi}] essential, float64 witness on the CPU's sets (MSAC scores in units of the "
        f"threshold, of {n_valid}): winners card #{win['card']}, CPU #{win['CPU']}, float64 "
        f"#{win['float64']}; "
        + "; ".join(f"#{i} card {float(s_c[i]):.3f} CPU {float(s_h[i]):.3f} float64 "
                    f"{float(s_64[i]):.3f}" for i in dict.fromkeys(list(win.values()) + top))
        + f"; |score - float64| over the 256 hypotheses: card median {float(dev_c.median()):.4f} "
        f"max {float(dev_c.max()):.3f}, CPU median {float(dev_h.median()):.4f} max "
        f"{float(dev_h.max()):.3f} (ratio {ratio:.3f}, bound {ESS_ROUNDING_RATIO})")
    check(ratio <= ESS_ROUNDING_RATIO,
          f"essential: the card's hypothesis scores stray {ratio:.3f}x as far from float64 as "
          f"the CPU's")

    x1, x2, mx = _exact_correspondences(pts1.cpu().numpy(), depth0, T21, cam)
    (ec, rc), (eh, rh) = on_both(x1, x2, mx, sets(mx, 1))
    same_inl = bool(torch.equal(ec.inliers.cpu(), eh.inliers))
    r_err = float((rc.R.cpu() - rh.R).abs().max())
    t_err = float((rc.t.cpu() - rh.t).abs().max())
    log(f"[{smi}] essential, exact correspondences ({int(mx.sum())} grid points through the "
        f"depth oracle): inliers card {int(ec.n_inliers)}, CPU {int(eh.n_inliers)} (equal masks "
        f"{same_inl}); max |dR| {r_err:.2e} (bound {ESS_R_ATOL}), max |dt| {t_err:.2e} (bound "
        f"{ESS_T_ATOL}); rotation error card {rot_err(rc):.4f}, CPU {rot_err(rh):.4f} deg "
        f"(bound {ESS_ROT_DEG}, R = I would give {true_deg:.4f}); |t . t_gt| card "
        f"{t_dot(rc):.6f}, CPU {t_dot(rh):.6f}")
    check(ESS_ROT_DEG <= ESS_ROT_SHARE * true_deg,
          f"essential: the rotation bound {ESS_ROT_DEG} deg does not reject R = I "
          f"({true_deg} deg)")
    check(same_inl and int(ec.n_inliers) > 0.95 * int(mx.sum()),
          f"essential: inliers {int(ec.n_inliers)} on the card, {int(eh.n_inliers)} on the CPU")
    check(r_err <= ESS_R_ATOL and t_err <= ESS_T_ATOL,
          f"essential: card vs CPU |dR| {r_err}, |dt| {t_err}")
    check(rot_err(rc) < ESS_ROT_DEG and t_dot(rc) > 0.9999,
          f"essential: exact correspondences give {rot_err(rc)} deg, |t . t_gt| {t_dot(rc)}")
    return {"k1": k1, "ms": mono_ms, "inliers": int(er.n_inliers)}


# The multi-rank paths at world size 1 (phase multichip): config 5's
# shapes (BAConfig's window and landmarks, PGOConfig's poses, loop edges
# and 10 x 128 CG steps, KeyframeConfig's ring), a drifted circle of
# MC_POSES poses with three loop edges (``dryrun.circle_problem``), timed
# over MC_REPS warm calls each; the collectives' own cost over MC_OP_REPS
# calls back to back.
MC_POSES = 4500
MC_LOOPS = ((1500, 10), (3000, 1490), (4490, 2980))
MC_REPS = 2
MC_OP_REPS = 200


def _pgo_cost(T, args) -> float:
    """Sum of squared edge residuals of the pose graph `args` at poses T."""
    from ros_stereo_slam_tpu_torch.models import pose_graph

    _, n, Z, li, lj, lZ, lv = args
    r_o = pose_graph._edge_residual_jacobians(T[:n - 1], T[1:n], Z[1:n])[0]
    r_l = pose_graph._edge_residual_jacobians(T[li.long()], T[lj.long()], lZ)[0][lv]
    return float(r_o.double().square().sum() + r_l.double().square().sum())


def _collective_costs(torch, mesh, pgo, pc, dev) -> dict:
    """What the collectives cost at world size 1: per call, the host time to
    enqueue MC_OP_REPS calls back to back and the wall time once they ran,
    for a clone, ``mesh.psum`` and a bare in-place ``all_reduce`` on PGO's
    (F, 6) float32 CG vector and BA's (48, 48) float64 reduced system; and
    one Gauss-Newton step of PGO (``pc.cg_iters`` CG steps) per layout:
    wall time (host clock around a synchronised call), and under
    ``torch.profiler`` the device time summed over kernels, the host time
    summed over ops and the all-reduces made."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ros_stereo_slam_tpu_torch.models import pose_graph
    from ros_stereo_slam_tpu_torch.parallel import dist_pgo
    from ros_stereo_slam_tpu_torch.parallel.mesh import psum

    ops = {}
    for shape, dtype in (((pc.max_poses, 6), torch.float32), ((48, 48), torch.float64)):
        x = torch.randn(shape, dtype=dtype, device=dev)
        for name, fn in (("clone", lambda: x.clone()), ("psum", lambda: psum(x, mesh)),
                         ("all_reduce", lambda: dist.all_reduce(x))):
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(MC_OP_REPS):
                fn()
            host = (time.perf_counter() - t0) / MC_OP_REPS * 1e3
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / MC_OP_REPS * 1e3
            ops[f"{name} {'x'.join(map(str, shape))} {str(dtype)[6:]}"] = (host, wall)
    kw = dict(iters=1, cg_iters=pc.cg_iters, damping=pc.damping)
    gn = {}
    for name, fn in (("single", lambda: pose_graph.optimize(*pgo, **kw)),
                     ("edge_sharded", lambda: dist_pgo.optimize_sharded(mesh, *pgo, **kw)),
                     ("chain_sharded", lambda: dist_pgo.optimize_chain_sharded(mesh, *pgo, **kw))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ka = prof.key_averages()
        gn[name] = {
            "wall_ms": wall,
            "device_ms": sum(e.self_device_time_total for e in ka) / 1e3,
            "host_ops_ms": sum(e.self_cpu_time_total for e in ka
                               if e.key.startswith(("aten::", "c10d::"))) / 1e3,
            "all_reduces": sum(e.count for e in ka if e.key == "c10d::allreduce_"),
        }
    return {"ops": ops, "gn_step": gn}


def phase_multichip(torch, voc, rl, rr, cam, dev, ba_stream: dict, smi: str,
                    corridor: tuple) -> dict:
    """Config 5 at world size 1 on the card: a one-rank NCCL group (a
    HashStore, no environment, no port) from ``preset_distributed(1)`` and
    every sharded function at full width against its single-device call,
    bit for bit: the points-sharded odometry step on the corridor's frames
    0 -> 1 (`corridor`: their left and right images; 768 points, K1 on the
    rank's block) with identically seeded generators, the collectives it
    makes counted and its K1 launches counted on their own path;
    landmark-sharded BA (W = 8, N = 2,048), edge- and
    chain-sharded PGO (F = 4,608, L = 64, 10 x 128 CG), the sharded store
    (K = 512 x 1,536) rewritten and gathered, one float64 all-reduce of
    BA's reduced system (48 x 48), and StereoSLAM(preset_distributed(1),
    mesh=...) over world A's frames 0-BA_SLAM_FRAMES against phase ba's
    StereoSLAM (config 5 is config 4 with the mesh), with its K1/K2/K3
    launches and the bytes of its keyframe store on the rank.  Then what
    the collectives cost (``_collective_costs``)."""
    import numpy as np
    import torch.distributed as dist

    from ros_stereo_slam_tpu_torch.config import BAConfig, KeyframeConfig, PGOConfig
    from ros_stereo_slam_tpu_torch.config import preset_distributed
    from ros_stereo_slam_tpu_torch.models import bundle_adjust, pose_graph, slam
    from ros_stereo_slam_tpu_torch.models.state import KeyframeStore
    from ros_stereo_slam_tpu_torch.parallel import dist_ba, dist_map, dist_pgo, dryrun
    from ros_stereo_slam_tpu_torch.parallel.mesh import (
        COLLECTIVES, all_gather, mesh_from_config, psum,
    )

    def timed(fn, reps: int = MC_REPS):
        """The last result of `reps` warm calls (after one cold call) and
        their median milliseconds on the host clock."""
        out, times = fn(), []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return out, statistics.median(times)

    def same(a, b) -> bool:
        return all(torch.equal(x, y) for x, y in zip(a, b, strict=True))

    cfg = preset_distributed(1).replace(camera=cam)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=dev)
    try:
        mesh = mesh_from_config(cfg.parallel, dev)
        out, ms = {}, {}
        # -- the points-sharded odometry step ------------------------------
        (c_left, c_right) = corridor
        odo_in = dryrun.odometry_inputs(cfg, c_left[0], c_right[0], c_left[1], dev)
        odo_n = odo_in[2].pts2d.shape[0]
        _kernel_counts(reset=True)
        before = COLLECTIVES.copy()
        odo = dryrun.run_odometry(mesh, cfg, odo_in)
        torch.cuda.synchronize()
        odo_counts, odo_coll = _kernel_counts(), COLLECTIVES - before
        odo_single, ms["odometry_single"] = timed(lambda: dryrun.run_odometry(None, cfg, odo_in))
        odo_again, ms["odometry_sharded"] = timed(lambda: dryrun.run_odometry(mesh, cfg, odo_in))
        out["odometry"] = same(odo, odo_single) and same(odo_again, odo_single)
        check(int(odo_single.n_inliers) > 100 and bool(torch.isfinite(odo_single.T_wc).all()),
              f"multichip: the odometry step kept {int(odo_single.n_inliers)} inliers")
        # -- landmark-sharded BA -------------------------------------------
        bc = BAConfig()
        prob = dryrun.ba_problem(bc.window, bc.max_landmarks, 5, dev)
        kw = dict(iters=bc.iters, damping=bc.damping, huber_px=bc.huber_px)
        single, ms["ba_single"] = timed(lambda: bundle_adjust.ba_solve(*prob, **kw))
        shard, ms["ba_sharded"] = timed(lambda: dist_ba.ba_solve_sharded(mesh, *prob, **kw))
        out["ba"] = same(shard, single)
        check(bool(torch.isfinite(single.T_cw).all()) and float(single.rms_after) < 1.0,
              f"multichip: BA rms {float(single.rms_after)} px")
        S = torch.randn((6 * bc.window, 6 * bc.window), dtype=torch.float64, device=dev)
        ar_ms = cuda_ms(torch, lambda: psum(S, mesh), reps=100)
        out["allreduce"] = torch.equal(psum(S, mesh), S)
        # -- PGO, both layouts ---------------------------------------------
        pc = PGOConfig()
        args = dryrun.circle_problem(pc.max_poses, pc.max_loop_edges, MC_POSES, MC_LOOPS, dev)
        kw = dict(iters=pc.iters, cg_iters=pc.cg_iters, damping=pc.damping)
        opt, ms["pgo_single"] = timed(lambda: pose_graph.optimize(*args, **kw))
        edge, ms["pgo_edge"] = timed(lambda: dist_pgo.optimize_sharded(mesh, *args, **kw))
        chain, ms["pgo_chain"] = timed(lambda: dist_pgo.optimize_chain_sharded(mesh, *args, **kw))
        out["pgo_edge"], out["pgo_chain"] = torch.equal(edge, opt), torch.equal(chain, opt)
        n = MC_POSES
        cost0, cost1 = _pgo_cost(args[0], args), _pgo_cost(opt, args)
        check(cost1 < 0.1 * cost0, f"multichip: PGO took the cost from {cost0} to {cost1}")
        # -- the sharded store, rewritten and gathered ----------------------
        kc = KeyframeConfig()
        g = torch.Generator(device=dev).manual_seed(7)
        kf = KeyframeStore.empty(kc.max_keyframes, kc.map_block_points, dev)._replace(
            points=5 * torch.randn((kc.max_keyframes, kc.map_block_points, 3), generator=g,
                                   device=dev),
            frame_idx=torch.randint(0, n, (kc.max_keyframes,), generator=g, device=dev,
                                    dtype=torch.int32))
        rw, ms["rewrite_single"] = timed(lambda: pose_graph.rewrite_points(
            kf.points, kf.frame_idx, args[0], opt))
        sh = dist_map.shard_keyframes(mesh, kf)
        rws, ms["rewrite_sharded"] = timed(lambda: all_gather(dist_map.rewrite_points_sharded(
            sh.points, sh.frame_idx, args[0], opt), mesh))
        out["rewrite"] = torch.equal(rws, rw)
        out["store"] = same(dist_map.gather_keyframes(mesh, sh), kf)
        # -- StereoSLAM under the mesh --------------------------------------
        nf = BA_SLAM_FRAMES
        SL, SR = (torch.from_numpy(a[:nf + 1]).to(dev) for a in (rl, rr))

        def stream():
            s = slam.StereoSLAM(cfg, voc, mesh=mesh, device=dev)
            s.initialize(SL[0], SR[0])
            for i in range(1, nf + 1):
                s.process_frame(SL[i], SR[i])
            return s

        ba_run = ba_stream["run"]
        _kernel_counts(reset=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = stream()
        torch.cuda.synchronize()
        t_s = time.perf_counter() - t0
        counts = _kernel_counts()
        events = [(e.query, e.match, e.n_inliers) for e in s.loop_events]
        want = [(e.query, e.match, e.n_inliers) for e in ba_run.loop_events]
        out["slam_traj"] = np.array_equal(s.trajectory_array(), ba_run.trajectory_array())
        out["slam_events"] = events == want
        out["slam_map"] = same(s.keyframes, ba_run.keyframes)
        pts_m, _ = s.map_points()
        out["slam_points"] = len(pts_m) == len(ba_run.map_points()[0])
        store_mb = sum(t.numel() * t.element_size() for t in s._carry.keyframes) / 2**20
        cost = _collective_costs(torch, mesh, args, pc, dev)
    finally:
        dist.destroy_process_group()
    log(f"[{smi}] multichip odometry: dist_frontend.odometry_step_sharded on corridor frames "
        f"0 -> 1 at {c_left.shape[2]}x{c_left.shape[1]}, {odo_n} points, one-rank NCCL group, "
        f"sharded {ms['odometry_sharded']:.3f} ms / single frontend.odometry_step "
        f"{ms['odometry_single']:.3f} ms (median of {MC_REPS} warm calls, host clock); "
        f"collectives a step: {odo_coll['all_gather']} all_gather + {odo_coll['all_reduce']} "
        f"all_reduce ({sum(odo_coll.values())} in all); K1 launches on this path "
        f"{odo_counts['k1']}; n_tracked {int(odo.n_tracked)}, n_inliers {int(odo.n_inliers)}; "
        f"bitwise the single call (pose, tracked points, mask, counts): {out['odometry']}; "
        f"world size > 1 not run: NCCL takes one GPU per rank and this host has one")
    log(f"[{smi}] multichip: one-rank NCCL group; ms (median of {MC_REPS} warm calls, host "
        f"clock) sharded / single: BA W={bc.window} N={bc.max_landmarks} "
        f"{ms['ba_sharded']:.3f} / {ms['ba_single']:.3f}; PGO F={pc.max_poses} "
        f"L={pc.max_loop_edges} {pc.iters}x{pc.cg_iters} CG edge-sharded {ms['pgo_edge']:.3f}, "
        f"chain-sharded {ms['pgo_chain']:.3f} / {ms['pgo_single']:.3f}; rewrite "
        f"K={kc.max_keyframes}x{kc.map_block_points} (sharded: rewrite + gather) "
        f"{ms['rewrite_sharded']:.3f} / {ms['rewrite_single']:.3f}; one float64 all-reduce "
        f"of {6 * bc.window}x{6 * bc.window} {ar_ms * 1e3:.2f} us (CUDA events, median of 100)")
    log(f"[{smi}] multichip: BA rms {float(single.rms_before):.4f} -> "
        f"{float(single.rms_after):.4f} px; PGO cost {cost0:.6g} -> {cost1:.6g}; "
        f"StereoSLAM(preset_distributed(1), mesh) world A frames 0-{nf}: {t_s:.3f} s -> "
        f"{nf / t_s:.2f} fps (phase ba's run of the same frames: {ba_stream['fps']:.2f} "
        f"fps); closures {events}; {len(pts_m)} map points; keyframe store on the rank "
        f"{store_mb:.3f} MiB; launches K1 {counts['k1']}, K2 {counts['k2']}, K3 "
        f"{counts['k3']}; bitwise equal to the single-device calls: {json.dumps(out)}")
    log(f"[{smi}] multichip collectives, per call over {MC_OP_REPS} back to back "
        f"(host ms to enqueue, wall ms): "
        + "; ".join(f"{k} {h:.4f} / {w:.4f}" for k, (h, w) in cost["ops"].items()))
    log(f"[{smi}] multichip PGO, one GN step of {pc.cg_iters} CG steps: "
        + "; ".join(f"{k} wall {v['wall_ms']:.3f} ms, device {v['device_ms']:.3f} ms, host ops "
                    f"{v['host_ops_ms']:.3f} ms, {v['all_reduces']} all-reduces"
                    for k, v in cost["gn_step"].items()))
    for name, ok in out.items():
        check(ok, f"multichip: {name} differs from its single-device call")
    for k in ("k1", "k2", "k3"):
        check(counts[k] > 0, f"multichip: StereoSLAM(mesh=...) launched no {k} kernel")
    check(odo_counts["k1"] > 0, "multichip: the points-sharded odometry step launched no K1")
    return {"ms": ms, "allreduce_ms": ar_ms, "fps": nf / t_s, "counts": counts,
            "odometry_counts": odo_counts, "odometry_collectives": dict(odo_coll),
            "store_mb": store_mb, "cost": cost}


def _png_gray_or_rgb(img) -> bytes:
    """A stdlib-zlib PNG of an (H, W) or (H, W, 3) uint8 image, every row
    filter 0 (None)."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.hstack([np.zeros((h, 1), np.uint8), img.reshape(h, -1)])

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def write_kitti_tree(seq: str, lefts, rights, poses, rgbs=None) -> None:
    """uint8 frames -> KITTI_DIR/sequences/<seq>/image_{0,1[,2]}/%06d.png and
    KITTI_DIR/poses/<seq>.txt (threads: zlib releases the GIL)."""
    import numpy as np

    base = KITTI_DIR / "sequences" / seq
    jobs = []
    for d, frames in (("image_0", lefts), ("image_1", rights), ("image_2", rgbs)):
        if frames is None:
            continue
        (base / d).mkdir(parents=True, exist_ok=True)
        jobs += [(base / d / f"{i:06d}.png", f) for i, f in enumerate(frames)]
    with ThreadPoolExecutor(8) as ex:
        list(ex.map(lambda job: job[0].write_bytes(_png_gray_or_rgb(job[1])), jobs))
    (KITTI_DIR / "poses").mkdir(parents=True, exist_ok=True)
    np.savetxt(KITTI_DIR / "poses" / f"{seq}.txt",
               np.asarray(poses)[:, :3, :4].reshape(len(poses), 12), fmt="%.9g")


def _read_back(seq: str, lefts, rights, rgbs=None) -> str:
    """Every frame of the tree through KittiSequence, held to uint8 / 255
    bitwise (the native loader, where it builds, to its own v * (1.0f / 255),
    which round-trips to the same uint8); returns the route taken."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.data import kitti

    ks = kitti.KittiSequence(str(KITTI_DIR), seq)
    check(ks.available and len(ks) == len(lefts), f"sequence {seq}: {len(ks)} frames read")
    scale = (np.float32(1.0) / np.float32(255.0)) if ks.route == "native" else None
    for i in range(len(lefts)):
        for got, want in zip(ks.frame(i), (lefts[i], rights[i])):
            ref = (want.astype(np.float32) * scale if scale is not None
                   else want.astype(np.float32) / 255.0)
            check(got.dtype == np.float32 and np.array_equal(got, ref),
                  f"sequence {seq} frame {i}: the {ks.route} route does not give the PNG's "
                  "uint8 values")
            check(np.array_equal(np.clip(got * 255.0, 0, 255).astype(np.uint8), want),
                  f"sequence {seq} frame {i}: the scan mode's quantization loses values")
        if rgbs is not None:
            check(np.array_equal(ks.frame_rgb(i), rgbs[i].astype(np.float32) / 255.0),
                  f"sequence {seq} frame {i}: image_2 does not read back")
    return ks.route


def _cli(torch, main, argv: list) -> tuple[dict, str]:
    """One CLI's main(argv) in this process: its K1/K2/K3 launches (counts
    set to 0 just before, read just after) and its standard output."""
    import contextlib
    import io

    buf = io.StringIO()
    _kernel_counts(reset=True)
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    torch.cuda.synchronize()
    counts = _kernel_counts()
    out = buf.getvalue()
    check(rc == 0, f"{main.__module__} {' '.join(argv)} exited {rc}:\n{out[-2000:]}")
    return counts, out


def _lines(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


def _loop_edges(g2o) -> list:
    """(i, j) of the EDGE lines between non-consecutive vertices."""
    edges = []
    for line in _lines(g2o):
        f = line.split()
        if f[0].startswith("EDGE") and int(f[2]) != int(f[1]) + 1:
            edges.append((int(f[1]), int(f[2])))
    return edges


def phase_cli(torch, left, right, rgb8, poses, rl, rr, rgt, dev, smi: str) -> dict:
    """The four CLIs on the card, through their main(argv) in this process
    (stereo_depth through python -m in a child), over KITTI-layout trees
    written from the rendered frames: sequence 00 = the corridor (gray
    pairs and image_2), sequence 01 = world A's frames 0-255 (gray)."""
    import importlib.util
    import shutil

    import numpy as np

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.data import kitti, loader
    from ros_stereo_slam_tpu_torch.models import vocab
    from ros_stereo_slam_tpu_torch.models.pipeline import run_offline
    from ros_stereo_slam_tpu_torch.tools import build_vocab, run_kitti, run_synthetic
    from ros_stereo_slam_tpu_torch.utils import outputs, ply

    for d in (KITTI_DIR, CLI_OUT):
        shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    q = np.clip(left * 255.0 + 0.5, 0, 255).astype(np.uint8)
    qr = np.clip(right * 255.0 + 0.5, 0, 255).astype(np.uint8)
    n_lc = SLAM_FRAMES  # world A's frames 0-255
    ql = np.clip(rl[:n_lc] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    qlr = np.clip(rr[:n_lc] * 255.0 + 0.5, 0, 255).astype(np.uint8)
    write_kitti_tree("00", q, qr, poses, rgb8)
    write_kitti_tree("01", ql, qlr, rgt[:n_lc])
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    routes = {seq: _read_back(seq, *fr) for seq, fr in
              (("00", (q, qr, rgb8)), ("01", (ql, qlr)))}
    log(f"cli: trees written in {write_s:.2f} s (00: {len(q)} frames with image_2, 01: "
        f"{n_lc} gray frames; stdlib zlib PNGs), read back in {time.perf_counter() - t0:.2f} s; "
        f"gray frames read by the {routes} route(s) (native loader "
        f"{'builds' if loader.native_available() else 'unavailable: ' + loader.UNAVAILABLE}), "
        "colour by the numpy decoder; every frame equals uint8 / 255 bitwise")
    plots = importlib.util.find_spec("matplotlib") is not None
    flags = ["--device", str(dev)] + ([] if plots else ["--no-plots"])
    log(f"cli: matplotlib {'imports: the CLIs draw their PNGs' if plots else 'is absent: the CLIs run with --no-plots'}")
    root = ["--root", str(KITTI_DIR)]
    out, res = {}, {}

    # odometry, scan mode: string for string the library run on the same uint8
    o = CLI_OUT / "odometry"
    out["odometry"], _ = _cli(torch, run_kitti.main, root + [
        "--seq", "00", "--preset", "odometry", "--mode", "scan", "--frames", str(len(q)),
        "--out", str(o)] + flags)
    cam00 = kitti.camera_for_sequence("00")
    lib = run_offline(preset_odometry().replace(camera=cam00), q, qr, device=dev)
    rows = _lines(o / "trajectory.txt")
    check(rows == [outputs.pose_row_kitti(T) for T in lib.trajectory],
          "run_kitti --mode scan: trajectory.txt differs from run_offline on the same frames")
    check(len(_lines(o / "metrics.jsonl")) == len(q), "run_kitti: metrics.jsonl rows")
    summary = json.loads((o / "summary.json").read_text())
    log(f"cli odometry (run_kitti --mode scan, {len(q)} frames): trajectory.txt equals "
        f"run_offline's string for string; K1 {out['odometry']['k1']}; ATE "
        f"{summary['ate_rmse']:.4f} m (camera_for_sequence('00'): baseline {cam00.baseline} m; "
        f"the frames were rendered at 0.54 m, so no ATE bound is held)")

    # mapping, stream mode: colours from image_2
    o = CLI_OUT / "mapping"
    out["mapping"], _ = _cli(torch, run_kitti.main, root + [
        "--seq", "00", "--preset", "mapping", "--mode", "stream", "--frames",
        str(CLI_MAPPING_FRAMES), "--out", str(o)] + flags)
    pts, cols = ply.load_ply(str(o / "map.ply"))
    chroma = float(np.abs(cols.astype(np.int64) - cols.mean(1, keepdims=True)).mean())
    check(len(pts) > 0 and cols is not None and chroma > 1.0,
          f"mapping CLI map: {len(pts)} points, mean chroma {chroma:.3f}")
    log(f"cli mapping (run_kitti --mode stream, {CLI_MAPPING_FRAMES} frames): {len(pts)} PLY "
        f"points, mean |channel - gray| {chroma:.2f} / 255 (chromatic); K1 "
        f"{out['mapping']['k1']}")

    # vocabulary from sequence 01, then loop closure in scan mode
    vpath = CLI_OUT / "vocab_01.npz"
    CLI_OUT.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    out["build_vocab"], vtxt = _cli(torch, build_vocab.main, root + [
        "--seq", "01", "--frames", str(n_lc), "--stride", str(CLI_VOCAB["stride"]),
        "--k", str(CLI_VOCAB["k"]), "--levels", str(CLI_VOCAB["levels"]),
        "--out", str(vpath), "--device", str(dev)])
    vocab_s = time.perf_counter() - t0
    o = CLI_OUT / "loop_closure"
    t0 = time.perf_counter()
    out["loop_closure"], lc_txt = _cli(torch, run_kitti.main, root + [
        "--seq", "01", "--preset", "loop_closure", "--vocab", str(vpath), "--mode", "scan",
        "--frames", str(n_lc), "--out", str(o)] + flags)
    lc_s = time.perf_counter() - t0
    events = [tuple(int(x) for x in line.split()[2:5:2]) for line in lc_txt.splitlines()
              if line.startswith("[kitti] LOOP")]
    check(len(events) >= 1, "run_kitti loop_closure accepted no closure")
    for qf, mf in events:
        d = (qf - mf) % LAP
        check(min(d, LAP - d) <= REVISIT_TOL,
              f"CLI closure ({qf}, {mf}) is not within {REVISIT_TOL} frames of a true revisit")
    edges = _loop_edges(o / "poseGraph.g2o")
    check(len(edges) == len(events) and all(e[0] == qf for e, (qf, _) in zip(edges, events)),
          f"poseGraph.g2o loop edges {edges} do not carry the closures {events}")
    summary = json.loads((o / "summary.json").read_text())
    trainer = "train_batched" if CLI_VOCAB["k"] ** CLI_VOCAB["levels"] > 4096 else "train"
    log(f"cli build_vocab (k={CLI_VOCAB['k']}, L={CLI_VOCAB['levels']}, {trainer}, every "
        f"{CLI_VOCAB['stride']}th of {n_lc} frames): {vocab_s:.1f} s; K2 "
        f"{out['build_vocab']['k2']}, K3 {out['build_vocab']['k3']} (the IDF)")
    log(f"cli loop_closure (run_kitti --mode scan, {n_lc} frames): {lc_s:.1f} s; closures "
        f"(query, match) {events} at true revisits; g2o loop edges {edges}; ATE "
        f"{summary['ate_rmse']:.4f} m; K1 {out['loop_closure']['k1']}, K2 "
        f"{out['loop_closure']['k2']}, K3 {out['loop_closure']['k3']}")

    # the synthetic CLI: host-recursive training on the card, chunked SLAM
    o = CLI_OUT / "synthetic"
    out["synthetic"], syn_txt = _cli(torch, run_synthetic.main, [
        "--preset", "loop_closure", "--orbit", "--frames", str(CLI_SYNTH_FRAMES), "--mode",
        "chunked", "--out", str(o)] + flags)
    world, cfg = run_synthetic.world_and_config(CLI_SYNTH_FRAMES, True, 13, 2, "loop_closure")
    X, docs = run_synthetic.sequence_descriptors(
        [world.render(i)[0] if i % 4 == 0 else None for i in range(CLI_SYNTH_FRAMES)], cfg, dev)
    card = vocab.Vocabulary.load(str(o / "vocab.npz"), device="cpu")
    host = vocab.train(X, k=8, levels=3, doc_ids=docs, device="cpu")
    check(all(torch.equal(a, b) for a, b in zip(card.centers, host.centers))
          and torch.equal(card.idf, host.idf),
          "run_synthetic's vocabulary (trained on the card) differs from train on the CPU")
    summary = json.loads((o / "summary.json").read_text())
    syn_events = [line for line in syn_txt.splitlines() if line.startswith("[run] LOOP")]
    log(f"cli synthetic (run_synthetic --preset loop_closure --orbit, {CLI_SYNTH_FRAMES} "
        f"frames, chunked): vocab.train k=8 L=3 on the card equals the CPU's bitwise over "
        f"{len(X)} descriptors; {len(syn_events)} closures; ATE {summary['ate_rmse']:.4f} m; "
        f"K1 {out['synthetic']['k1']}, K2 {out['synthetic']['k2']}, K3 {out['synthetic']['k3']}")

    # stereo_depth through python -m in a child process
    o = CLI_OUT / "stereo"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", f"{PKG}.tools.stereo_depth", "--root",
         str(KITTI_DIR), "--seq", "00", "--frames", "1", "--out", str(o), "--device", str(dev)]
        + ([] if plots else ["--no-plots"]),
        capture_output=True, text=True, cwd=str(ROOT), timeout=300)
    child_s = time.perf_counter() - t0
    check(proc.returncode == 0, f"python -m stereo_depth exited {proc.returncode}: "
          f"{proc.stderr[-2000:]}")
    mods = [line.split("|")[-1].strip() for line in proc.stderr.splitlines()
            if line.startswith("import time:")]
    jaxy = [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "ros_stereo_slam_tpu")]
    check(not jaxy and f"{PKG}.ops.sgbm" in mods,
          f"the stereo_depth child imported {jaxy[:5]} ({len(mods)} modules)")
    cloud, _ = ply.load_ply(str(o / "StereoCloud.ply"))
    check(len(cloud) > 0 and bool(np.isfinite(cloud).all()), "StereoCloud.ply holds no points")
    log(f"cli stereo_depth (python -m in a child, {child_s:.1f} s): {len(cloud)} cloud "
        f"points, {len(mods)} modules imported, none of JAX")

    for name, kern in (("odometry", "k1"), ("mapping", "k1"), ("loop_closure", "k1"),
                       ("loop_closure", "k2"), ("loop_closure", "k3"), ("build_vocab", "k2"),
                       ("build_vocab", "k3"), ("synthetic", "k1"), ("synthetic", "k2"),
                       ("synthetic", "k3")):
        check(out[name][kern] > 0, f"the CLI run {name} launched no {kern.upper()} kernel")
    total = {k: sum(c[k] for c in out.values()) for k in ("k1", "k2", "k3")}
    log(f"[{smi}] cli: launches per run {out}; in all K1 {total['k1']}, K2 {total['k2']}, "
        f"K3 {total['k3']}")
    return {"counts": total, "runs": out}


def phase_endurance(torch, pending: PendingRender, dev, smi: str) -> dict:
    """The endurance CLI's functions at full width (1241x376, the k = 9,
    L = 6 vocabulary trained on the lap, preset_loop_closure()) at reduced
    depth: the plain lap tiled to ENDURANCE_FRAMES frames, detection on
    every frame, the scan posture, with both rings wrapping.  K1/K2/K3
    launches from the scan (counters set to 0 just before it)."""
    import dataclasses

    import numpy as np

    from ros_stereo_slam_tpu_torch.config import KeyframeConfig
    from ros_stereo_slam_tpu_torch.tools import endurance_run as er

    t0 = time.perf_counter()
    left, right, gt, lap_left = pending.frames()
    wait_s = time.perf_counter() - t0
    F, cam = left.shape[0], er.camera(1)
    check(left.shape == (ENDURANCE_FRAMES, cam.height, cam.width) and left.dtype == np.uint8,
          f"endurance frames {left.shape} {left.dtype}")
    check(bool((left[ENDURANCE_LAP] == left[0]).all()), "the tiled lap does not repeat")
    cfg = er.loop_config(1, ENDURANCE_DB, detect_every=1).replace(
        keyframes=dataclasses.replace(KeyframeConfig(), max_keyframes=ENDURANCE_KF))
    t0 = time.perf_counter()
    voc = er.train_vocab(lap_left, cfg, dev)
    torch.cuda.synchronize()
    vocab_s = time.perf_counter() - t0
    sc = er.run_postures(cfg, voc, left, right, gt, dev, ENDURANCE_LAP)["scan"]
    ring = er.bow_ring(F, cfg)
    events = [tuple(e) for e in sc["loop_events"]]
    offsets = [er.revisit_offset(q, m, ENDURANCE_LAP) for q, m, _ in events]
    counts = sc["launches"]
    log(f"endurance [{smi}]: {F} frames (lap {ENDURANCE_LAP} tiled) at {cam.width}x"
        f"{cam.height}, {wait_s:.1f} s waited for the render; vocabulary {voc.n_words} words "
        f"trained on the card in {vocab_s:.2f} s; scan {sc['wall_s']:.3f} s -> {sc['fps']:.2f} fps; loop events "
        f"(query, match, inliers) {events}, offsets {offsets}; ATE post-PGO "
        f"{sc['ate_rmse_m']:.4f} m, odometry only {sc['ate_rmse_odometry_m']:.4f} m; "
        f"keyframes inserted {sc['keyframes_inserted']} into {ENDURANCE_KF} slots "
        f"({sc['keyframe_ring_wraps']} wraps); BoW {ring}; tracking "
        f"{sc['tracking_ok_fraction']:.4f}; launches K1 {counts['k1']}, K2 {counts['k2']}, "
        f"K3 {counts['k3']}")
    check(len(events) >= ENDURANCE_MIN_CLOSURES,
          f"{len(events)} closures, fewer than {ENDURANCE_MIN_CLOSURES}")
    check(all(o <= REVISIT_TOL for o in offsets),
          f"closures {events} not all within {REVISIT_TOL} frames of a true revisit")
    check(sc["keyframes_inserted"] > ENDURANCE_KF,
          f"{sc['keyframes_inserted']} keyframes: the ring of {ENDURANCE_KF} did not wrap")
    check(ring["bow_inserts"] > ENDURANCE_DB and ring["bow_rows_overwritten"] > 0,
          f"BoW {ring}: the database of {ENDURANCE_DB} did not wrap")
    check(sc["ate_rmse_m"] < sc["ate_rmse_odometry_m"],
          f"post-PGO ATE {sc['ate_rmse_m']} m is not below odometry-only "
          f"{sc['ate_rmse_odometry_m']} m")
    check(bool(sc["tracking_ok"].all()),
          f"tracking lost on frames {np.nonzero(~sc['tracking_ok'])[0] + 1}")
    for k in ("k1", "k2", "k3"):
        check(counts[k] > 0, f"the endurance scan launched no {k} kernel")
    check(counts["k3"] == ring["bow_inserts"],
          f"K3 launched {counts['k3']} times over {ring['bow_inserts']} detection frames")
    return {"counts": counts}


def main() -> int:
    if not (ROOT / PKG / "__init__.py").is_file():
        log(f"FAIL: package {PKG}/ not found beside chip_smoke.py")
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke run needs a GPU")
        return 2
    import numpy as np

    import ros_stereo_slam_tpu_torch  # noqa: F401  (sets the float policy)

    dev = torch.device("cuda:0")
    from ros_stereo_slam_tpu_torch.config import preset_loop_closure

    slam_cfg = preset_loop_closure()
    phase_s = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"phase {name}: {phase_s[name]:.1f} s")
        return out

    pending = None
    try:
        smi = timed("toolchain", phase_toolchain, torch)
        timed("build", phase_build)
        (left, right, depths, poses, cam, rgb8), worlds, workers, pending = timed(
            "render", phase_render)
        rl, rr, rgt = worlds["A"]
        log(f"rendered {left.shape[0]} corridor + {len(worlds)} x {rl.shape[0]} revisit "
            f"frames with {workers} worker processes (host); the endurance lap renders "
            f"behind the phases in {pending.workers} processes of {os.cpu_count()} CPUs")
        slam_cfg = slam_cfg.replace(camera=cam)
        voc = timed("vocab", phase_vocab, torch, rl, slam_cfg, dev)
        from ros_stereo_slam_tpu_torch.ops import lk_cuda

        floor_ms = device_ms(torch, lk_cuda.empty_launch())
        log(f"launch floor: an empty kernel, launched and timed as the kernels' device_ms "
            f"is, takes {floor_ms * 1e3:.3f} us")
        k1 = timed("kernels_k1", phase_kernels, torch,
                   k1_cases(torch, left, depths, poses, cam, dev))
        probe = torch.from_numpy(rl[LAP + 2]).to(dev)  # a jittered revisit frame
        probes = torch.from_numpy(np.stack([worlds[n][0][LAP + 2] for n in REVISIT_SEEDS]))
        probes = probes.to(dev)
        corridor0 = torch.from_numpy(left[0]).to(dev)
        k2 = timed("kernels_k2", k2_phase, torch, probe, slam_cfg, corridor0)
        k3 = timed("kernels_k3", k3_phase, torch, probe, probes, voc, slam_cfg)
        k1b = timed("kernels_k1b", k1b_phase, torch, left, depths, poses, cam, dev)
        corridor_lanes = torch.from_numpy(np.stack(
            [left[b * (FRAMES // LANES)] for b in range(LANES)])).to(dev)
        k2b = timed("kernels_k2b", k2_phase, torch, probes, slam_cfg, corridor_lanes)
        sl = timed("slice", phase_slice, torch, left, right, poses, cam, dev)
        sm = timed("slam", phase_slam, torch, voc, rl, rr, rgt, slam_cfg, dev)
        bo = timed("batched_odo", phase_batched_odo, torch, left, right, poses, cam, dev)
        bs = timed("batched_slam", phase_batched_slam, torch, voc, worlds, slam_cfg, dev)
        po = timed("polish", phase_polish, torch, left, right, depths, poses, cam, dev, sl)
        lcd = timed("lane_cadences", phase_lane_cadences, torch, voc, left, right, poses, cam,
                    worlds, slam_cfg, dev, bo, bs)
        on = timed("online", phase_online, torch, voc, rl, rr, rgt, slam_cfg, dev, sm, smi)
        mp = timed("mapping", phase_mapping, torch, left, right, rgb8, cam, dev, sl, smi)
        ba = timed("ba", phase_ba, torch, voc, left, right, poses, cam, dev, sl, rl, rr, rgt, smi)
        rf = timed("reference_frontend", phase_frontend, torch, "reference_frontend",
                   REFERENCE_FRONTEND, left, right, poses, cam, dev, sl, smi)
        ob = timed("orb_stereo", phase_frontend, torch, "orb_stereo", ORB_STEREO, left, right,
                   poses, cam, dev, sl, smi)
        obl = timed("orb_stereo_lanes", phase_orb_stereo_lanes, torch, left, right, poses, cam,
                    dev, smi)
        sd = timed("stereo_depth", phase_stereo_depth, torch, left, right, depths[0], cam, dev,
                   smi)
        es = timed("essential", phase_essential, torch, left, depths[0], poses, cam, dev, smi)
        mc = timed("multichip", phase_multichip, torch, voc, rl, rr, cam, dev, ba["stream"], smi,
                   (left[:2], right[:2]))
        cl = timed("cli", phase_cli, torch, left, right, rgb8, poses, rl, rr, rgt, dev, smi)
        en = timed("endurance", phase_endurance, torch, pending, dev, smi)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    finally:
        if pending is not None:
            pending.close()
    log(f"phase seconds: {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}, "
        f"total {sum(phase_s.values()):.1f} s")
    log(f"single-lane vs batched on this card: odometry {sl['fps']:.2f} fps vs "
        f"{bo['fps']:.2f} fps aggregate over {LANES} lanes; full SLAM {sm['fps']:.2f} fps vs "
        f"{bs['fps']:.2f} fps aggregate")
    log(f"[{smi}] the three ported branches on this card: polish {po['fps']:.2f} fps against "
        f"slice {sl['fps']:.2f} fps ({po['fps'] / sl['fps']:.3f}x), K1 polish device_ms "
        f"{po['k1']['device_ms']:.4f} against {po['k1']['walk_device_ms']:.4f} walk-only, K1b "
        f"{po['k1b']['device_ms']:.4f} against {po['k1b']['walk_device_ms']:.4f}; aligned "
        f"lanes {lcd['align']['fps']:.2f} fps against batched_odo {bo['fps']:.2f} fps "
        f"({lcd['align']['fps'] / bo['fps']:.3f}x); interleaved full SLAM "
        f"{lcd['interleave']['fps']:.2f} fps (one run) against batched_slam {bs['fps']:.2f} "
        f"fps ({lcd['interleave']['fps'] / bs['fps']:.3f}x)")
    log(f"[{smi}] full SLAM per posture on this card: scan {sm['fps']:.2f} fps, streaming "
        f"{on['stream']['fps']:.2f} fps, chunked {on['chunked']['fps']:.2f} fps speculative "
        f"and {on['chunked']['fps_sequential']:.2f} fps sequential")
    log(f"[{smi}] configs 2 and 4 against odometry on this card: slice {sl['fps']:.2f} fps, "
        f"mapping {mp['fps']:.2f} fps ({mp['fps'] / sl['fps']:.3f}x), BA "
        f"{ba['offline']['fps']:.2f} fps ({ba['offline']['fps'] / sl['fps']:.3f}x, "
        f"{ba['offline']['ba_ms']:.3f} ms of BA per frame), BA 2 lanes "
        f"{ba['lanes']['fps']:.2f} fps aggregate; full SLAM with BA (StereoSLAM) "
        f"{ba['stream']['fps']:.2f} fps vs streaming without {on['stream']['fps']:.2f} fps")
    log(f"[{smi}] frontend choices against odometry on this card: slice {sl['fps']:.2f} fps, "
        f"reference_frontend {rf['fps']:.2f} fps ({rf['fps'] / sl['fps']:.3f}x), orb_stereo "
        f"{ob['fps']:.2f} fps ({ob['fps'] / sl['fps']:.3f}x), orb_stereo 2 lanes "
        f"{obl['fps']:.2f} fps aggregate; ATE slice {sl['ate']:.4f} m, reference_frontend "
        f"{rf['ate']:.4f} m, orb_stereo {ob['ate']:.4f} m; SGBM {sd['total_ms']:.3f} ms a pair")
    # (name, source, TPU kernel it replaces, launches on its own path, measures).
    # K1's launches are counted on the corridor slice, K2's and K3's on full
    # SLAM, K1b's on the batched odometry and K2b's on batched full SLAM.
    # No single PyTorch call computes any of them, so library_ms is null.
    # launches_by_path: each path's count, its counters set to 0 before it;
    # multichip adds phase multichip's two paths (StereoSLAM(mesh=) and the
    # points-sharded odometry step, multichip_odometry on its own);
    # endurance is phase endurance's 1,024-frame scan.
    # ms is the time of a wrapper call (CUDA events around it, host work
    # included), device_ms the kernel's own (bare launches back to back),
    # launch_floor_ms an empty kernel's, taken the same way; device_ms_spaced_hot
    # and device_ms_cold each launch behind a spin and behind a 64 MB write.
    # K1 and K1b add their freeze-polish call (phase polish, walk 3 of 8):
    # polish_device_ms beside polish_walk_device_ms, the same 8 steps as walk.
    table = [
        ("lk_level", "lk_level", "lk_pallas.py:120", sl["launches"], k1,
         {"slice": sl["launches"], "slam": sm["counts"]["lk_level"],
          "online_stream": on["stream"]["counts"]["k1"], "mapping": mp["launches"],
          "ba": ba["offline"]["counts"]["k1"], "ba_stream": ba["stream"]["counts"]["k1"],
          "reference_frontend": rf["counts"]["k1"], "orb_stereo": ob["counts"]["k1"],
          "essential": es["k1"],
          "multichip": mc["counts"]["k1"] + mc["odometry_counts"]["k1"],
          "multichip_odometry": mc["odometry_counts"]["k1"], "cli": cl["counts"]["k1"],
          "polish": po["counts"]["k1"], "lane_cadences": lcd["counts"]["k1"],
          "endurance": en["counts"]["k1"]}),
        ("orb_desc", "orb_desc", "orb_pallas.py:84", sm["counts"]["orb_desc"], k2,
         {"slam": sm["counts"]["orb_desc"], "online_stream": on["stream"]["counts"]["k2"],
          "ba_stream": ba["stream"]["counts"]["k2"], "orb_stereo": ob["counts"]["k2"],
          "multichip": mc["counts"]["k2"], "cli": cl["counts"]["k2"],
          "lane_cadences": lcd["counts"]["k2"], "endurance": en["counts"]["k2"]}),
        ("vocab_descend", "vocab_descend", "vocab_pallas.py:72",
         sm["counts"]["vocab_descend"], k3,
         {"slam": sm["counts"]["vocab_descend"], "online_stream": on["stream"]["counts"]["k3"],
          "ba_stream": ba["stream"]["counts"]["k3"], "multichip": mc["counts"]["k3"],
          "cli": cl["counts"]["k3"], "lane_cadences": lcd["counts"]["k3"],
          "endurance": en["counts"]["k3"]}),
        ("lk_level_batch", "lk_level", "lk_pallas.py:361", bo["launches"], k1b,
         {"batched_odo": bo["launches"], "batched_slam": bs["counts"]["k1b"],
          "ba_lanes": ba["lanes"]["k1b"], "orb_stereo_lanes": obl["counts"]["k1b"],
          "polish": po["counts"]["k1b"], "lane_cadences": lcd["counts"]["k1b"]}),
        ("orb_desc_batch", "orb_desc", "orb_pallas.py:207", bs["counts"]["k2b"], k2b,
         {"batched_slam": bs["counts"]["k2b"], "orb_stereo_lanes": obl["counts"]["k2b"],
          "lane_cadences": lcd["counts"]["k2b"]}),
    ]
    rows = []
    for name, src, replaces, launches, meas, by_path in table:
        row = {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{src}.cu",
               "replaces": f"ros_stereo_slam_tpu/ops/{replaces}", "launches": launches,
               "max_abs_err": meas["max_abs_err"], "ms": meas["ms"],
               "plain_ms": meas["plain_ms"], "bound_ms": meas["bound_ms"],
               "bound_by": meas["bound_by"], "library_ms": None,
               "device_ms": meas["device_ms"], "launch_floor_ms": floor_ms,
               "launches_by_path": by_path}
        for key in ("mismatches", "device_ms_spaced_hot", "device_ms_cold", "whole_descent_ms",
                    "int8_bound_ms"):
            if key in meas:
                row[key] = meas[key]
        if name in ("lk_level", "lk_level_batch"):
            pol = po["k1" if name == "lk_level" else "k1b"]
            row.update(polish_max_abs_err=pol["max_abs_err"], polish_ms=pol["ms"],
                       polish_plain_ms=pol["plain_ms"], polish_device_ms=pol["device_ms"],
                       polish_walk_device_ms=pol["walk_device_ms"],
                       polish_device_ms_spaced_hot=pol["device_ms_spaced_hot"],
                       polish_device_ms_cold=pol["device_ms_cold"])
        rows.append(row)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
