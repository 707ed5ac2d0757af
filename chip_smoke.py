#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``ros_stereo_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. toolchain: the card's name and power limit, torch and its CUDA build,
   ``nvcc --version``, whether ``triton`` imports;
2. build: every kernel of the odometry path, from ``csrc/`` (timed);
3. kernels: each kernel against its plain PyTorch version on the card, at
   the main path's shapes, with median times from CUDA events;
4. slice: the stereo-odometry main path (``run_offline`` on ``cuda:0``) over
   the bench corridor at full KITTI geometry (1241x376), checked against
   ground truth, with the kernels' launch counts from that run; then the
   streaming driver (``StereoOdometry``) against ``run_offline``.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "ros_stereo_slam_tpu_torch"

# K1 against its plain version: the bounds of the JAX package's own
# kernel-vs-oracle test (tests/test_lk_pallas.py).
K1_PTS_ATOL = 5e-3  # px
K1_RESID_ATOL = 1e-2
K1_BORDER_PX = 10.0  # compare where both results stay this far inside

# The slice's reference: the JAX package's run_offline on the same 48
# corridor frames, measured on a host CPU (NOT on any GPU): ATE 0.040 m,
# 22 keyframes, every frame tracked, >= 161 PnP inliers on every frame;
# ~30 s for the first call, ~1.0 s per warm run.  The port's bound allows
# 2.5x that ATE because its RANSAC draws are not JAX's random streams.
JAX_CPU_ATE_M = 0.040
ATE_BOUND_M = 0.10
FRAMES = 48  # frames after frame 0: the run the JAX numbers above describe


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


def phase_toolchain(torch) -> None:
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


def phase_build() -> None:
    from ros_stereo_slam_tpu_torch.kernels import build

    for name in ("lk_level",):
        t0 = time.perf_counter()
        build.load(name)
        dt = time.perf_counter() - t0
        log(f"build {name}: {dt:.2f} s ({build.library_path(name).name})")
        if name in build.BUILD_LOG:
            for line in build.BUILD_LOG[name][1].splitlines():
                if any(k in line for k in ("entry function", "registers", "spill")):
                    log(f"  ptxas: {line.strip()}")


def render_corridor(n_frames: int):
    """The bench corridor (bench.py::_render_world): seed 11, half_w 18 m,
    full KITTI geometry.  Returns (left, right, depth0, poses)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.config import CameraConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    world = SyntheticWorld(camera=CameraConfig(), n_frames=n_frames, seed=11,
                           half_w=18.0)
    lefts, rights, depth0 = [], [], None
    for i in range(n_frames):
        left, right, depth = world.render(i)
        lefts.append(left)
        rights.append(right)
        if i == 0:
            depth0 = depth
    return np.stack(lefts), np.stack(rights), depth0, world.poses, world.camera


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


def k1_cases(torch, left, depth0, poses, cam, dev):
    """K1 inputs at the main path's shapes: corridor frames 0 and 1, N = 768
    points whose true position stays >= 40 px inside both frames.  Guesses
    are the true flow plus noise, as the path hands them over: up to 1 px
    for the seeded temporal track (level 0, 6 iters), up to 2 px for the
    rescue's level 0 after the coarse levels (10 iters), and the level-2
    (311x94) rescue pass at 1/4 scale (10 iters)."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.ops import lk, pyramid

    rng = np.random.default_rng(0)
    H, W = left.shape[1:]
    n, S, m = 768, 15, 40
    cand = np.stack([rng.uniform(m, W - m, 8 * n), rng.uniform(m, H - m, 8 * n)],
                    axis=1)
    # True flow from frame 0 to 1: back-project with the rendered depth.
    z = depth0[cand[:, 1].astype(int), cand[:, 0].astype(int)].astype(np.float64)
    pc = np.stack([(cand[:, 0] - cam.cx) / cam.fx * z,
                   (cand[:, 1] - cam.cy) / cam.fy * z, z], axis=1)
    T01 = np.linalg.inv(poses[1]) @ poses[0]
    q = pc @ T01[:3, :3].T + T01[:3, 3]
    uv1 = np.stack([cam.fx * q[:, 0] / q[:, 2] + cam.cx,
                    cam.fy * q[:, 1] / q[:, 2] + cam.cy], axis=1)
    keep = np.nonzero((uv1[:, 0] >= m) & (uv1[:, 0] < W - m)
                      & (uv1[:, 1] >= m) & (uv1[:, 1] < H - m))[0][:n]
    check(keep.size == n, f"only {keep.size} interior K1 points")
    pts = cand[keep].astype(np.float32)
    uv1 = uv1[keep]

    def seed(noise_px, scale=1.0):
        g = (uv1 + rng.uniform(-noise_px, noise_px, uv1.shape)) / scale
        return torch.from_numpy(g.astype(np.float32)).to(dev)

    ref_pyr = pyramid.build_pyramid(torch.from_numpy(left[0]).to(dev), 4)
    cur_pyr = pyramid.build_pyramid(torch.from_numpy(left[1]).to(dev), 4)
    p = torch.from_numpy(pts).to(dev)
    base = lk.LKParams(window=S, levels=4, iters=10)
    return [
        ("L0 1241x376 iters=6", ref_pyr[0], cur_pyr[0], p, seed(1.0),
         base._replace(iters=6)),
        ("L0 1241x376 iters=10", ref_pyr[0], cur_pyr[0], p, seed(2.0), base),
        ("L2 311x94 iters=10", ref_pyr[2], cur_pyr[2], (p / 4.0).contiguous(),
         seed(2.0, 4.0), base),
    ]


def phase_kernels(torch, cases) -> dict:
    """K1 against lk._track_level on the card.  The two routes clamp tile
    reads differently at image borders (by design, as the JAX kernel and
    its oracle do), so points and residuals are compared where both
    results stay K1_BORDER_PX inside the image; that must be >= 95 % of N."""
    from ros_stereo_slam_tpu_torch.ops import interp, lk, lk_cuda

    worst, rows = 0.0, []
    for name, ref, cur, pts, guess, params in cases:
        kg, kr, kok = lk_cuda.track_level(ref, cur, pts, guess, params)
        pg, pr, pok = lk._track_level(ref, cur, pts, guess, params)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(kg).all()), f"K1 {name}: non-finite points")
        H, W = ref.shape
        inner = (interp.in_bounds(kg, H, W, K1_BORDER_PX)
                 & interp.in_bounds(pg, H, W, K1_BORDER_PX))
        n, n_in = pts.shape[0], int(inner.sum())
        n_ok_diff = int((kok != pok).sum())
        err = float((kg - pg)[inner].abs().max())
        rerr = float((kr - pr)[inner].abs().max())
        ms = cuda_ms(torch, lambda: lk_cuda.track_level(ref, cur, pts, guess, params))
        plain_ms = cuda_ms(torch, lambda: lk._track_level(ref, cur, pts, guess, params))
        log(f"K1 {name}: N={n} ok={int(kok.sum())} ok_mismatch={n_ok_diff} "
            f"compared={n_in} max|dpts|={err:.3e} px max|dresid|={rerr:.3e} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (median of 25)")
        check(n_ok_diff == 0, f"K1 {name}: ok differs on {n_ok_diff} points")
        check(n_in >= 0.95 * n, f"K1 {name}: only {n_in}/{n} points stay interior")
        check(err <= K1_PTS_ATOL, f"K1 {name}: points differ by {err} px")
        check(rerr <= K1_RESID_ATOL, f"K1 {name}: resid differs by {rerr}")
        worst = max(worst, err)
        rows.append((ms, plain_ms))
    # The headline time is the seeded temporal track (the per-frame call).
    return {"max_abs_err": worst, "ms": rows[0][0], "plain_ms": rows[0][1]}


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
    return {"launches": launches, "fps": F / med, "ate": ate}


def main() -> int:
    if not (ROOT / PKG / "__init__.py").is_file():
        log(f"FAIL: package {PKG}/ not found beside chip_smoke.py")
        return 2
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this smoke run needs a GPU")
        return 2
    import ros_stereo_slam_tpu_torch  # noqa: F401  (sets the float policy)

    dev = torch.device("cuda:0")
    try:
        phase_toolchain(torch)
        phase_build()
        t0 = time.perf_counter()
        left, right, depth0, poses, cam = render_corridor(FRAMES + 1)
        log(f"rendered {FRAMES + 1} corridor frames in "
            f"{time.perf_counter() - t0:.1f} s (host)")
        k1 = phase_kernels(torch, k1_cases(torch, left, depth0, poses, cam, dev))
        sl = phase_slice(torch, left, right, poses, cam, dev)
    except SmokeFailure as e:
        log(f"FAIL: {e}")
        return 1
    print(json.dumps({"kernels": [{
        "name": "lk_level",
        "route": "cuda",
        "source": f"{PKG}/csrc/lk_level.cu",
        "replaces": "ros_stereo_slam_tpu/ops/lk_pallas.py:120",
        "launches": sl["launches"],
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
