"""Run the SLAM pipeline on a KITTI odometry sequence.

Port of ``tools/run_kitti.py``: the reference's main entry
(``reference/src/VisualSLAM.cpp:217-237``) without its hardcoded paths.

  python -m ros_stereo_slam_tpu_torch.tools.run_kitti --root /data/kitti \
      --seq 00 --preset loop_closure --vocab vocab_00.npz --frames 4500
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ros_stereo_slam_tpu_torch.tools.run_kitti")
    ap.add_argument("--root", default=None, help="KITTI odometry root")
    ap.add_argument("--seq", default="00")
    ap.add_argument("--preset", default="odometry",
                    choices=["odometry", "mapping", "loop_closure", "ba"])
    ap.add_argument("--vocab", default=None, help="vocabulary .npz (required for loop_closure)")
    ap.add_argument("--frames", type=int, default=4500)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--mode", default="stream",
                    choices=["stream", "chunked", "scan"],
                    help="stream = per-frame dispatch (models/slam.py); "
                    "chunked = 32-frame chunks with per-chunk PGO correction "
                    "(models/slam_chunked.py; requires --preset loop_closure + "
                    "--vocab); scan = the whole-sequence offline posture "
                    "(models/slam_scan for loop_closure, models/pipeline."
                    "run_offline otherwise): frames staged on the device as "
                    "uint8, correction deferred to the epilogue")
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--no-plots", action="store_true",
                    help="skip trajectory.png / error_curve.png (they need matplotlib)")
    return ap


def main(argv=None) -> int:
    """Run the CLI; the program's spans record throughout, and their
    summary per name goes to ``stages.json`` in the run's directory."""
    from ros_stereo_slam_tpu_torch.utils import profiling

    args = _parser().parse_args(argv)
    profiling.reset()
    with profiling.tracing():
        return _main(args)


def _main(args) -> int:
    import numpy as np
    import torch

    from ros_stereo_slam_tpu_torch.config import PRESETS
    from ros_stereo_slam_tpu_torch.data import kitti
    from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
    from ros_stereo_slam_tpu_torch.models.pipeline import FrameInfo
    from ros_stereo_slam_tpu_torch.tools import device_of
    from ros_stereo_slam_tpu_torch.utils.outputs import RunOutputs, ScanRun
    from ros_stereo_slam_tpu_torch.utils import profiling

    dev = device_of(args.device)
    if dev is None:
        return 2
    root = args.root or kitti.find_kitti_root()
    if root is None:
        print("ERROR: no KITTI dataset found (set --root or KITTI_ROOT)", file=sys.stderr)
        return 2
    seq = kitti.KittiSequence(root, args.seq)
    if not seq.available:
        print(f"ERROR: sequence {args.seq} not found under {root}", file=sys.stderr)
        return 2
    n = min(len(seq), args.frames)
    cfg = PRESETS[args.preset]().replace(camera=seq.camera)
    vocab = vocab_mod.Vocabulary.load(args.vocab, device=dev) if args.vocab else None
    if cfg.loop.enabled and vocab is None:
        print("ERROR: --vocab required for loop_closure preset "
              "(build one with ros_stereo_slam_tpu_torch.tools.build_vocab)", file=sys.stderr)
        return 2
    print(f"[kitti] {n} frames of sequence {args.seq} on {dev}; gray frames read by the "
          f"{seq.route} decoder, colour by the numpy decoder"
          f"{'' if seq.rgb_available else ' (no image_2: gray replicated)'}")

    out = RunOutputs(args.out or f"runs/kitti_{args.seq}_{args.preset}")
    fps = profiling.FpsMeter()

    def on_dev(pair):
        return tuple(torch.as_tensor(x).to(dev) for x in pair)

    if args.mode == "scan":
        with profiling.span("io"):
            # uint8 staging: 4x less device memory than f32
            fr = [seq.frame(i) for i in range(n)]
            lefts = np.stack([
                np.clip(f[0] * 255.0, 0, 255).astype(np.uint8) for f in fr])
            rights = np.stack([
                np.clip(f[1] * 255.0, 0, 255).astype(np.uint8) for f in fr])
            del fr
            rgb = (np.stack([
                np.clip(seq.frame_rgb(i) * 255.0, 0, 255).astype(np.uint8)
                for i in range(n)])
                if (cfg.export_map and seq.rgb_available) else None)
        with profiling.span("scan"):
            if cfg.loop.enabled:
                from ros_stereo_slam_tpu_torch.models.slam_scan import run_offline_slam

                res = run_offline_slam(cfg, vocab, lefts, rights, device=dev, rgb_seq=rgb)
            else:
                from ros_stereo_slam_tpu_torch.models.pipeline import run_offline

                res = run_offline(cfg, lefts, rights, device=dev, rgb_seq=rgb)
        slam = ScanRun(res, cfg)
        for info in slam.frame_infos():
            out.log_frame(info)
        for q, m, n_inl in slam.loop_events:
            print(f"[kitti] LOOP {q} -> {m} ({n_inl} inliers)")
    elif args.mode == "chunked":
        if vocab is None:
            print("ERROR: --mode chunked needs --preset loop_closure + "
                  "--vocab (in-scan detection requires a vocabulary)", file=sys.stderr)
            return 2
        from ros_stereo_slam_tpu_torch.models.slam_chunked import ChunkedSLAM

        slam = ChunkedSLAM(cfg, vocab, dev)
        with profiling.span("initialize"):
            l0, r0 = seq.frame(0)
            rgb0 = seq.frame_rgb(0) if seq.rgb_available else None
            slam.initialize(l0, r0, rgb0=rgb0)
        out.log_frame(FrameInfo(
            frame=0, T_wc=np.eye(4, dtype=np.float32), n_tracked=0,
            n_inliers=0, is_keyframe=True, tracking_ok=True,
            used_retry=False,
        ))
        C = args.chunk
        for s in range(1, n, C):
            e = min(s + C, n)
            with profiling.span("io"):
                fr = [seq.frame(i) for i in range(s, e)]
                lefts = np.stack([f[0] for f in fr])
                rights = np.stack([f[1] for f in fr])
                rg = (np.stack([seq.frame_rgb(i) for i in range(s, e)])
                      if seq.rgb_available else None)
            t0 = time.perf_counter()
            with profiling.span("chunk"):
                info = slam.process_chunk(
                    lefts, rights, rgbs=rg,
                    query_frames=lambda fid: on_dev(seq.frame(fid)),
                )
            chunk_fps = round((e - s) / (time.perf_counter() - t0), 2)
            # per-frame rows from the chunk's stats (fps: the chunk's mean rate)
            for k2 in range(e - s):
                out.log_frame(FrameInfo(
                    frame=s + k2, T_wc=info.T_wc[k2],
                    n_tracked=int(info.n_tracked[k2]),
                    n_inliers=int(info.n_inliers[k2]),
                    is_keyframe=bool(info.is_keyframe[k2]),
                    tracking_ok=bool(info.tracking_ok[k2]),
                    used_retry=False,
                ), {"fps": chunk_fps})
            if (s - 1) // C % 4 == 0:
                print(f"[kitti] {e}/{n} "
                      f"inl_med={int(np.median(info.n_inliers))} "
                      f"accepted={info.n_accepted}")
        for q, m, n_inl in slam.loop_events:
            print(f"[kitti] LOOP {q} -> {m} ({n_inl} inliers)")
    else:
        from ros_stereo_slam_tpu_torch.models.slam import StereoSLAM

        slam = StereoSLAM(cfg, vocab=vocab, device=dev)
        with profiling.span("initialize"):
            l0, r0 = seq.frame(0)
            rgb0 = seq.frame_rgb(0) if seq.rgb_available else None
            info = slam.initialize(l0, r0, left_rgb=rgb0)
        out.log_frame(info)
        for i in range(1, n):
            with profiling.span("io"):
                left, right = seq.frame(i)
                rgb = seq.frame_rgb(i) if seq.rgb_available else None
            with profiling.span("frame"):
                info = slam.process_frame(left, right, left_rgb=rgb)
            out.log_frame(info, {"fps": round(fps.tick(), 2)})
            if i % 100 == 0:
                print(f"[kitti] {i}/{n} fps={fps.fps:.1f} "
                      f"inl={info.n_inliers}")
        for ev in slam.loop_events:
            print(f"[kitti] LOOP {ev.query} -> {ev.match} "
                  f"({ev.n_inliers} inliers)")

    summary = out.finalize(slam, gt_poses=seq.gt_poses(), plots=not args.no_plots)
    profiling.dump(os.path.join(out.out_dir, "stages.json"))
    print(f"[kitti] summary: {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
