"""Reference-scale endurance run: thousands of frames, many loop closures.

Port of the JAX package's ``tools/endurance_run.py``.  The reference loops
4,500 frames with a 4,500-entry keyframe history
(``reference/src/VisualSLAM.cpp:54,37``) and fires a loop closure whenever
its accept rule passes (query - match > 100, cooldown 100,
``src/optimizationStuff.cpp:59-63``).  This runs the same regime end to
end: a multi-lap circular trajectory (each lap revisits every pose of the
previous one) rendered at full KITTI resolution, through scan-mode full
SLAM (config 3) with the reference-scale vocabulary (k = 9, L = 6) and a
4,096-frame database, then optionally through the two online postures
(``--compare-chunked``: 32-frame chunks; ``--compare-streaming``:
:class:`.slam.StereoSLAM` frame by frame) on the same frames.

Frames stage as uint8 (3.8 GB for 2 x 4,097 x 376 x 1241).  The plain lap
renders once and is tiled; ``--jitter`` renders every lap with its own
pose perturbation and gives laps 2+ a brightness and per-frame sensor
noise, so revisits are not pixel-identical.  Frames render in worker
processes, bitwise equal to the serial recipe: the parent walks the one
noise generator in the recipe's order and hands each worker the
generator's state at its frame.

Writes ``<out>/metrics.jsonl`` (one line per scan frame after frame 0)
and ``<out>/summary.json`` (rewritten after each posture, so a run cut
short keeps what finished).  Exit code 1 when the scan accepts fewer than
3 closures, 2 when ``--device`` names a card this host does not have.

  python -m ros_stereo_slam_tpu_torch.tools.endurance_run --jitter \\
      --compare-streaming --compare-chunked --frame-cache
  python -m ros_stereo_slam_tpu_torch.tools.endurance_run --device cpu \\
      --frames 16 --lap 32 --radius 5 --scale 4 --out runs/endurance_cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

WORLD_SEED = 11
JITTER_SEED = 17
NOISE_SIGMA = 0.02
JOB_FRAMES = 8  # frames per render job
CHUNK = 32  # the chunked posture's frames per chunk


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ros_stereo_slam_tpu_torch.tools.endurance_run")
    ap.add_argument("--frames", type=int, default=4096, help="total frames incl. frame 0")
    ap.add_argument("--lap", type=int, default=512, help="unique poses per lap")
    ap.add_argument("--radius", type=float, default=20.0)
    ap.add_argument("--out", default="runs/endurance")
    ap.add_argument("--scale", type=int, default=1,
                    help="resolution divisor (1 = full KITTI res)")
    ap.add_argument("--jitter", action="store_true",
                    help="perturb every lap's poses (~0.1 m / 1 deg) and give laps 2+ a "
                    "brightness and sensor noise, so revisits are not identical")
    ap.add_argument("--compare-streaming", action="store_true",
                    help="also run StereoSLAM frame by frame (a PGO and a map rewrite "
                    "per closure) on the same frames")
    ap.add_argument("--compare-chunked", action="store_true",
                    help="also run run_online_slam in 32-frame chunks (a correction per "
                    "chunk that accepts a closure) on the same frames")
    ap.add_argument("--frame-cache", action="store_true",
                    help="cache the rendered frame stack under --cache-dir, keyed by "
                    "every render parameter")
    ap.add_argument("--cache-dir", default="runs/endurance_cache",
                    help="where the frame stack and the vocabulary are cached")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return ap


def camera(scale: int = 1):
    """KITTI 00's pinhole at 1/`scale` resolution."""
    from ros_stereo_slam_tpu_torch.config import CameraConfig

    s = scale
    return CameraConfig(fx=718.856 / s, fy=718.856 / s, cx=607.1928 / s, cy=185.2157 / s,
                        width=1241 // s, height=376 // s)


def lap_poses(lap: int, radius: float) -> np.ndarray:
    """(lap, 4, 4) world-from-camera poses of one circular lap in the x-z
    plane, heading tangential; every lap revisits these poses exactly."""
    poses = np.zeros((lap, 4, 4))
    for i in range(lap):
        th = 2 * np.pi * i / lap
        c, sn = np.cos(th), np.sin(th)
        poses[i] = np.eye(4)
        poses[i, :3, :3] = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]])
        poses[i, :3, 3] = np.array([radius * (1 - c), 0.0, radius * sn])
    return poses


def world_kw(radius: float) -> dict:
    """The corridor around the circle (x in [0, 2r]) with wall clearance."""
    return dict(half_w=max(3.0 * radius, 18.0), end_z=max(6.0 * radius, 260.0))


def _render_job(cam, world: dict, indices: list, post: list) -> list:
    """Worker: frames `indices` of one SyntheticWorld as uint8 (left, right)
    pairs.  `post[k]` is None or (brightness, noise generator state): the
    recipe's photometric jitter, drawn from that state."""
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    sw = SyntheticWorld(camera=cam, **world)
    out = []
    for i, pp in zip(indices, post):
        l_im, r_im, _ = sw.render(i)
        if pp is not None:
            b, state = pp
            rng = np.random.default_rng()
            rng.bit_generator.state = state
            noise = rng.normal(0, NOISE_SIGMA, l_im.shape).astype(l_im.dtype)
            l_im = np.clip(l_im * b + noise, 0, 1)
            r_im = np.clip(r_im * b + noise, 0, 1)
        out.append(((l_im * 255).astype(np.uint8), (r_im * 255).astype(np.uint8)))
    return out


def _job(args):
    return _render_job(*args)


def render_plan(frames: int, lap: int, radius: float = 20.0, scale: int = 1,
                jitter: bool = False, gt: list | None = None):
    """The render jobs of the recipe in frame order (a generator of
    ``_render_job`` argument tuples, JOB_FRAMES frames each).  Plain: the
    lap once (the caller tiles it).  Jittered: every lap's frames up to
    `frames`, the noise generator (seed 17) walked in the recipe's order:
    each later lap draws its pose jitter, then one brightness, then one
    noise image per frame.  Appends each frame's ground-truth pose to `gt`."""
    from ros_stereo_slam_tpu_torch.data.synthetic import jitter_poses

    cam = camera(scale)
    base = lap_poses(lap, radius)
    kw = world_kw(radius)
    shape = (cam.height, cam.width)
    gt = [] if gt is None else gt
    if not jitter:
        gt.extend(base[np.arange(frames) % lap])
        for s in range(0, lap, JOB_FRAMES):
            idx = list(range(s, min(s + JOB_FRAMES, lap)))
            yield (cam, dict(n_frames=lap, seed=WORLD_SEED, custom_poses=base, **kw), idx,
                   [None] * len(idx))
        return
    rng = np.random.default_rng(JITTER_SEED)
    done = 0
    for lap_i in range(-(-frames // lap)):
        poses_l = base if lap_i == 0 else jitter_poses(base, rng, trans_m=0.1, rot_deg=1.0)
        world = dict(n_frames=lap, seed=WORLD_SEED, custom_poses=poses_l, **kw)
        b = rng.uniform(0.85, 1.15) if lap_i > 0 else 1.0
        n = min(lap, frames - done)
        post = []
        for i in range(n):
            gt.append(poses_l[i])
            if lap_i > 0:
                post.append((b, rng.bit_generator.state))
                rng.normal(0, NOISE_SIGMA, shape)  # advance past this frame's noise
            else:
                post.append(None)
        for s in range(0, n, JOB_FRAMES):
            yield (cam, world, list(range(s, min(s + JOB_FRAMES, n))), post[s:s + JOB_FRAMES])
        done += n


def render_frames(frames: int, lap: int, radius: float = 20.0, scale: int = 1,
                  jitter: bool = False, workers: int = 0):
    """(left, right) uint8 (frames, H, W) stacks, ground truth (frames, 4, 4)
    and the first lap's left frames, rendered by `workers` processes (0:
    min(8, CPUs), at most one per job).  Bitwise the serial recipe's frames."""
    import multiprocessing

    gt: list = []
    plan = list(render_plan(frames, lap, radius, scale, jitter, gt))
    workers = workers or max(1, min(8, os.cpu_count() or 1, len(plan)))
    with multiprocessing.get_context("spawn").Pool(workers) as pool:
        parts = pool.map(_job, plan)
    return assemble(parts, gt, frames, lap, jitter)


def assemble(parts: list, gt: list, frames: int, lap: int, jitter: bool):
    """The render jobs' results (in plan order) -> (left, right, gt, first
    lap's left frames); the plain lap is tiled to `frames`."""
    pairs = [p for part in parts for p in part]
    left = np.stack([p[0] for p in pairs])
    right = np.stack([p[1] for p in pairs])
    if not jitter:
        idx = np.arange(frames) % lap
        return left[idx], right[idx], np.stack(gt), left
    return left, right, np.stack(gt), left[:lap]


def loop_config(scale: int = 1, db_capacity: int = 4096, **loop):
    """``preset_loop_closure()`` at the run's camera with a `db_capacity`
    database (and any other LoopClosureConfig fields in `loop`)."""
    from ros_stereo_slam_tpu_torch.config import LoopClosureConfig, preset_loop_closure

    return preset_loop_closure().replace(
        camera=camera(scale),
        loop=dataclasses.replace(LoopClosureConfig(), db_capacity=db_capacity, **loop))


def train_vocab(lap_left: np.ndarray, cfg, device, stride: int = 8):
    """The run's vocabulary: ORB of every `stride`-th first-lap frame on
    `device`, then ``train_batched`` at (vocab_k, vocab_levels)."""
    import torch

    from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
    from ros_stereo_slam_tpu_torch.ops import orb

    lcc = cfg.loop
    descs, docs = [], []
    for i in range(0, lap_left.shape[0], stride):
        img = torch.from_numpy(lap_left[i]).to(device).to(torch.float32) / 255.0
        f = orb.detect_and_compute(img, lcc.orb_features, n_levels=lcc.orb_levels)
        descs.append(f.desc_sign[f.valid])
        docs.append(np.full(int(f.valid.sum()), i))
    return vocab_mod.train_batched(torch.cat(descs), k=lcc.vocab_k, levels=lcc.vocab_levels,
                                   doc_ids=np.concatenate(docs), device=device)


def revisit_offset(q: int, m: int, lap: int) -> int:
    """Frames between a closure's match and the query's pose one or more
    laps back: |((q - m + lap/2) mod lap) - lap/2|."""
    half = lap // 2
    return abs((q - m + half) % lap - half)


def _counts(reset: bool = False) -> dict:
    """K1/K2/K3 launches so far (set to 0 first with `reset`)."""
    from ros_stereo_slam_tpu_torch.ops import lk_cuda, orb_cuda, vocab_cuda

    if reset:
        lk_cuda.LAUNCHES = orb_cuda.LAUNCHES = vocab_cuda.LAUNCHES = 0
    return dict(k1=lk_cuda.LAUNCHES, k2=orb_cuda.LAUNCHES, k3=vocab_cuda.LAUNCHES)


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _posture(name: str, traj, events, keyframes, ok, wall: float, lap: int, gt,
             counts: dict) -> dict:
    """What each posture reports (keys without the posture's prefix)."""
    from ros_stereo_slam_tpu_torch.utils import metrics

    F = traj.shape[0]
    n_kf = int(keyframes.count)
    offsets = [revisit_offset(q, m, lap) for q, m, _ in events]
    return {
        "name": name,
        "loop_events": [[int(q), int(m), int(n)] for q, m, n in events],
        "ate_rmse_m": float(metrics.ate_rmse(traj, gt)),
        "true_revisit_max_offset": max(offsets) if offsets else None,
        "keyframes_inserted": n_kf,
        "keyframe_ring_wraps": max(n_kf - 1, 0) // keyframes.capacity,
        "tracking_ok_fraction": float(np.mean(ok)),
        "wall_s": wall,
        "fps": (F - 1) / wall,
        "launches": counts,
    }


def run_postures(cfg, voc, left, right, gt, device, lap: int, streaming: bool = False,
                 chunked: bool = False, on_posture=None) -> dict:
    """The scan posture, then (optionally) the chunked and the streaming
    ones, on the same uint8 frames.  Returns {posture: report}; the scan's
    report also holds its per-frame stats and odometry-only ATE.
    `on_posture(results)` is called after each posture.  The streaming
    posture is fed float32 frames made on the host as ``x / 255``, as the
    JAX tool feeds them."""
    import torch

    from ros_stereo_slam_tpu_torch.models import slam, slam_chunked, slam_scan
    from ros_stereo_slam_tpu_torch.utils import metrics

    out = {}
    L = torch.from_numpy(np.ascontiguousarray(left)).to(device)
    R = torch.from_numpy(np.ascontiguousarray(right)).to(device)

    def done(rep):
        out[rep["name"]] = rep
        if on_posture is not None:
            on_posture(out)

    print(f"[endurance] running scan-mode full SLAM on {device}...", flush=True)
    _counts(reset=True)
    _sync(device)
    t0 = time.perf_counter()
    res = slam_scan.run_offline_slam(cfg, voc, L, R, device=device)
    _sync(device)
    rep = _posture("scan", res.trajectory, res.loop_events, res.keyframes, res.tracking_ok,
                   time.perf_counter() - t0, lap, gt, _counts())
    rep.update(ate_rmse_odometry_m=float(metrics.ate_rmse(res.trajectory_odo, gt)),
               n_inliers=res.n_inliers, is_keyframe=res.is_keyframe,
               tracking_ok=res.tracking_ok)
    done(rep)

    if chunked:
        print(f"[endurance] chunked-online comparison run (chunk {CHUNK})...", flush=True)
        _counts(reset=True)
        _sync(device)
        t0 = time.perf_counter()
        cres = slam_chunked.run_online_slam(cfg, voc, L, R, chunk=CHUNK, device=device)
        _sync(device)
        rep = _posture("chunked", cres.trajectory, cres.loop_events, cres.keyframes,
                       cres.tracking_ok, time.perf_counter() - t0, lap, gt, _counts())
        rep["corrections"] = cres.n_corrections
        done(rep)

    if streaming:
        print("[endurance] streaming-driver comparison run...", flush=True)
        _counts(reset=True)
        _sync(device)
        t0 = time.perf_counter()
        def pair(i):
            return left[i].astype(np.float32) / 255.0, right[i].astype(np.float32) / 255.0

        s = slam.StereoSLAM(cfg, voc, device=device)
        s.initialize(*pair(0))
        ok = []
        for i in range(1, left.shape[0]):
            info = s.process_frame(*pair(i))
            ok.append(info.tracking_ok)
            if i % 256 == 0:
                print(f"  streaming {i}/{left.shape[0]} ({time.perf_counter() - t0:.0f}s)",
                      flush=True)
        _sync(device)
        events = [(e.query, e.match, e.n_inliers) for e in s.loop_events]
        rep = _posture("streaming", s.trajectory_array(), events, s.keyframes, np.asarray(ok),
                       time.perf_counter() - t0, lap, gt, _counts())
        done(rep)
    return out


def bow_ring(frames: int, cfg) -> dict:
    """Inserts into the BoW database ring (slot ``frame_id % db_capacity``,
    one per detection frame, frame 0 included), the times its slot index
    came round again, and the rows overwritten."""
    lcc = cfg.loop
    every, cap = max(lcc.detect_every, 1), lcc.db_capacity
    fids = range(0, frames, every)
    return {"bow_inserts": len(fids), "bow_ring_wraps": fids[-1] // cap,
            "bow_rows_overwritten": sum(1 for f in fids if f >= cap)}


def platform_of(device) -> str:
    """The card's name and power limit as nvidia-smi prints them (the
    torch device name if nvidia-smi fails), or the device type."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def summary_of(results: dict, args, cfg, voc, platform: str) -> dict:
    """The JAX tool's summary keys, then the port's (per-posture offsets,
    ring counts, launches, posture parity)."""
    sc = results["scan"]
    F = args.frames
    s = {
        "frames": F,
        "lap": args.lap,
        "resolution": f"{cfg.camera.width}x{cfg.camera.height}",
        "vocab_words": voc.n_words,
        "db_capacity": cfg.loop.db_capacity,
        "loop_events": sc["loop_events"],
        "n_loop_closures": len(sc["loop_events"]),
        "ate_rmse_odometry_m": round(sc["ate_rmse_odometry_m"], 4),
        "ate_rmse_post_pgo_m": round(sc["ate_rmse_m"], 4),
        "n_keyframes": int(np.sum(sc["is_keyframe"])),
        "tracking_ok_fraction": round(sc["tracking_ok_fraction"], 4),
        "wall_s_incl_compile": round(sc["wall_s"], 1),
        "fps_incl_compile": round(sc["fps"], 2),
        "platform": platform,
        "jitter": bool(args.jitter),
        "detect_every": cfg.loop.detect_every,
    }
    st = results.get("streaming")
    if st is not None:
        s.update(ate_rmse_streaming_m=round(st["ate_rmse_m"], 4),
                 streaming_loop_closures=len(st["loop_events"]),
                 streaming_wall_s=round(st["wall_s"], 1),
                 deferred_vs_immediate_ate_delta_m=round(sc["ate_rmse_m"] - st["ate_rmse_m"],
                                                         4))
    ch = results.get("chunked")
    if ch is not None:
        s.update(ate_rmse_chunked_m=round(ch["ate_rmse_m"], 4),
                 chunked_loop_closures=len(ch["loop_events"]),
                 chunked_corrections=ch["corrections"],
                 chunked_wall_s=round(ch["wall_s"], 1),
                 chunked_fps_incl_compile=round(ch["fps"], 2))
    s.update(max_keyframes=cfg.keyframes.max_keyframes, max_poses=cfg.pgo.max_poses,
             max_loop_edges=cfg.pgo.max_loop_edges, device=str(args.device),
             **bow_ring(F, cfg))
    for name, rep in results.items():
        pre = "" if name == "scan" else f"{name}_"
        s[f"{pre}true_revisit_max_offset"] = rep["true_revisit_max_offset"]
        s[f"{pre}keyframes_inserted"] = rep["keyframes_inserted"]
        s[f"{pre}keyframe_ring_wraps"] = rep["keyframe_ring_wraps"]
        s[f"{pre}launches"] = rep["launches"]
        if name != "scan":
            s[f"{name}_loop_events"] = rep["loop_events"]
            s[f"{name}_tracking_ok_fraction"] = round(rep["tracking_ok_fraction"], 4)
            s[f"{name}_fps"] = round(rep["fps"], 2)
    sets = {name: [e[:2] for e in rep["loop_events"]] for name, rep in results.items()}
    s["postures_run"] = list(results)
    s["posture_sets_identical"] = all(v == sets["scan"] for v in sets.values())
    return s


def write_metrics(path: str, scan: dict) -> None:
    with open(path, "w") as f:
        for i in range(scan["n_inliers"].shape[0]):
            f.write(json.dumps({
                "frame": i + 1,
                "n_inliers": int(scan["n_inliers"][i]),
                "is_keyframe": bool(scan["is_keyframe"][i]),
                "tracking_ok": bool(scan["tracking_ok"][i]),
            }) + "\n")


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
    from ros_stereo_slam_tpu_torch.tools import device_of

    dev = device_of(args.device)
    if dev is None:
        return 2
    F, L, r, s = args.frames, args.lap, args.radius, args.scale
    cfg = loop_config(s)
    cam = cfg.camera
    os.makedirs(args.cache_dir, exist_ok=True)
    t0 = time.perf_counter()
    cache_path = os.path.join(
        args.cache_dir, f"endurance_frames_{F}_{L}_{r:g}_{s}_{'j' if args.jitter else 'p'}.npz")
    if args.frame_cache and os.path.exists(cache_path):
        print(f"[endurance] loading cached frames ({cache_path})...", flush=True)
        with np.load(cache_path) as z:
            left, right, gt = z["l"], z["r"], z["gt"]
        lap_left = left[:L]
    else:
        print(f"[endurance] rendering {F} {'JITTERED' if args.jitter else 'tiled'} frames "
              f"(lap {L}) at {cam.width}x{cam.height}...", flush=True)
        left, right, gt, lap_left = render_frames(F, L, r, s, args.jitter)
        print(f"[endurance] rendered in {time.perf_counter() - t0:.1f} s", flush=True)
        if args.frame_cache:
            np.savez(cache_path, l=left, r=right, gt=gt)
            print(f"[endurance] cached frames to {cache_path}", flush=True)
    print(f"[endurance] staged {left.nbytes * 2 / 1e9:.2f} GB (uint8)", flush=True)

    lcc = cfg.loop
    vocab_cache = os.path.join(
        args.cache_dir, f"endurance_vocab_{L}_{r:g}_{s}_{'j' if args.jitter else 'p'}_"
        f"{lcc.orb_features}_{lcc.orb_levels}_{lcc.vocab_k}_{lcc.vocab_levels}.npz")
    if os.path.exists(vocab_cache):
        voc = vocab_mod.Vocabulary.load(vocab_cache, device=dev)
    else:
        print(f"[endurance] training k={cfg.loop.vocab_k} L={cfg.loop.vocab_levels} "
              f"vocabulary on {dev}...", flush=True)
        voc = train_vocab(lap_left, cfg, dev)
        voc.save(vocab_cache)
        print(f"[endurance] vocabulary cached to {vocab_cache}", flush=True)
    print(f"[endurance] vocabulary: {voc.n_words} words", flush=True)

    os.makedirs(args.out, exist_ok=True)
    platform = platform_of(dev)

    def write(results):
        if len(results) == 1:
            write_metrics(os.path.join(args.out, "metrics.jsonl"), results["scan"])
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary_of(results, args, cfg, voc, platform), f, indent=2)

    results = run_postures(cfg, voc, left, right, gt, dev, L, streaming=args.compare_streaming,
                           chunked=args.compare_chunked, on_posture=write)
    summary = summary_of(results, args, cfg, voc, platform)
    print(json.dumps(summary, indent=2), flush=True)
    if summary["n_loop_closures"] < 3:
        print("[endurance] FAIL: fewer than 3 loop closures", flush=True)
        return 1
    print("[endurance] OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
