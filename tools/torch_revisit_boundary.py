#!/usr/bin/env python3
"""Per-frame PnP inliers of the port's single-lane odometry across the
revisit world's lap boundary, for several (plan, world) seed pairs.

    python3 tools/torch_revisit_boundary.py [--first 240] [--pairs 17,11 53,59 ...]

Frame 256 of ``chip_smoke.py``'s 257-frame revisit worlds starts a third
lap with a fresh pose jitter and brightness.  For each seed pair this
renders frames FIRST..256 at full KITTI geometry with the world's own
noise (``chip_smoke.revisit_frames``, one worker process per pair), runs
``run_offline`` at ``preset_odometry()`` on the card from frame FIRST and
prints one JSON line: the brightness of frames 255 and 256, and the
inliers and tracking flag of every frame.  The same probe at half
resolution, through the JAX package and the port, is
``tests/test_torch_revisit_boundary.py``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_PAIRS = [f"{p},{w}" for p in (17, 23, 53) for w in (11, 13, 29, 59)]


def _frames(seeds: tuple[int, int], first: int):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    from ros_stereo_slam_tpu_torch.config import CameraConfig

    frames = list(range(first, chip_smoke.SLAM_FRAMES + 1))
    cam = CameraConfig()  # the noise's shape sets the later laps' draws
    _, post, _ = chip_smoke._revisit_plan(chip_smoke.SLAM_FRAMES + 1, (cam.height, cam.width),
                                          *seeds, keep_noise=False)
    bright = [post[f][0] if post[f] else 1.0 for f in frames[-2:]]
    return chip_smoke.revisit_frames(seeds, frames), bright


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--first", type=int, default=240)
    ap.add_argument("--pairs", nargs="+", default=DEFAULT_PAIRS)
    ap.add_argument("--workers", type=int, default=8)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from ros_stereo_slam_tpu_torch.config import preset_odometry
    from ros_stereo_slam_tpu_torch.models import pipeline

    pairs = [tuple(int(v) for v in p.split(",")) for p in args.pairs]
    with multiprocessing.get_context("spawn").Pool(min(args.workers, len(pairs))) as pool:
        rendered = pool.starmap(_frames, [(p, args.first) for p in pairs])
    cfg = preset_odometry()
    for seeds, ((left, right), bright) in zip(pairs, rendered):
        res = pipeline.run_offline(cfg, torch.from_numpy(left).cuda(),
                                   torch.from_numpy(right).cuda(), device="cuda")
        print(json.dumps({
            "seeds": list(seeds), "first": args.first, "brightness_255_256": bright,
            "inliers": res.n_inliers.tolist(), "tracked": res.tracking_ok.astype(int).tolist(),
            "used_retry": res.used_retry.astype(int).tolist()}), flush=True)


if __name__ == "__main__":
    main()
