"""Run a SLAM preset over the synthetic ground-truth world.

Port of ``tools/run_synthetic.py``: the synthetic analog of the
reference's ``rosrun fusion SLAM`` (``reference/src/VisualSLAM.cpp:217-237``),
with trajectory (KITTI + CSV + PNG), map.ply, poseGraph.g2o,
metrics.jsonl and an ATE/RPE summary.  Loop-closure presets train their
vocabulary (k = 8, L = 3) from the sequence with the host-recursive
``vocab.train`` and also write it to ``vocab.npz``.

  python -m ros_stereo_slam_tpu_torch.tools.run_synthetic --preset odometry --frames 32
  python -m ros_stereo_slam_tpu_torch.tools.run_synthetic --preset loop_closure \
      --orbit --frames 80
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ros_stereo_slam_tpu_torch.tools.run_synthetic")
    ap.add_argument("--preset", default="odometry",
                    choices=["odometry", "mapping", "loop_closure", "ba"])
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--orbit", action="store_true",
                    help="closed circular trajectory (enables loop closure)")
    ap.add_argument("--out", default="runs/synthetic")
    ap.add_argument("--scale", type=int, default=2, help="resolution divisor")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--mode", default="stream",
                    choices=["stream", "chunked", "scan"],
                    help="stream = per-frame dispatch (models/slam.py); "
                    "chunked = 16-frame chunks with per-chunk PGO correction "
                    "(models/slam_chunked.py; requires a loop-closure preset); "
                    "scan = the whole-sequence offline posture, correction "
                    "deferred to the epilogue")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--no-plots", action="store_true",
                    help="skip trajectory.png / error_curve.png (they need matplotlib)")
    return ap


def world_and_config(frames: int, orbit: bool, seed: int, scale: int, preset: str):
    """The synthetic world and the preset scaled to it (the reference
    tool's rules: grid and inlier trigger by resolution, loop gates by
    sequence length)."""
    from ros_stereo_slam_tpu_torch.config import PRESETS
    from ros_stereo_slam_tpu_torch.data.synthetic import loop_trajectory, small_world

    poses = loop_trajectory(frames) if orbit else None
    world = small_world(n_frames=frames, seed=seed, scale=scale, custom_poses=poses)
    if orbit:
        world.half_w = 10.0
    cfg = PRESETS[preset]().replace(camera=world.camera)
    # Scale sampling density and triggers with resolution (the defaults
    # target full KITTI 1241x376).
    cfg = cfg.replace(
        frontend=dataclasses.replace(
            cfg.frontend, grid_step=max(8, cfg.frontend.grid_step // scale)
        ),
        keyframes=dataclasses.replace(
            cfg.keyframes, min_pnp_inliers=cfg.keyframes.min_pnp_inliers // scale
        ),
    )
    if cfg.loop.enabled:
        # The reference's acceptance gates target 4,500-frame KITTI runs
        # (query-match > 100, cooldown 100, skip 20 recent); scale them to
        # the demo's sequence length so a short orbit can actually close.
        cfg = cfg.replace(
            loop=dataclasses.replace(
                cfg.loop,
                dislocal=min(cfg.loop.dislocal, max(4, frames // 8)),
                min_separation=min(cfg.loop.min_separation, frames // 2),
                cooldown=min(cfg.loop.cooldown, frames // 4),
            )
        )
    return world, cfg


def sequence_descriptors(lefts: list, cfg, device):
    """ORB sign descriptors of every 4th left frame, and their frame ids."""
    import numpy as np
    import torch

    from ros_stereo_slam_tpu_torch.ops import orb

    descs, docs = [], []
    for i in range(0, len(lefts), 4):
        f = orb.detect_and_compute(torch.as_tensor(lefts[i]).to(device),
                                   cfg.loop.orb_features, n_levels=cfg.loop.orb_levels)
        v = f.valid.cpu().numpy()
        descs.append(f.desc_sign.cpu().numpy()[v])
        docs.append(np.full(int(v.sum()), i))
    return np.concatenate(descs), np.concatenate(docs)


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

    from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
    from ros_stereo_slam_tpu_torch.models.pipeline import FrameInfo
    from ros_stereo_slam_tpu_torch.tools import device_of
    from ros_stereo_slam_tpu_torch.utils.outputs import RunOutputs, ScanRun
    from ros_stereo_slam_tpu_torch.utils import profiling

    dev = device_of(args.device)
    if dev is None:
        return 2
    world, cfg = world_and_config(args.frames, args.orbit, args.seed, args.scale, args.preset)
    if args.mode == "chunked" and not cfg.loop.enabled:
        print("ERROR: --mode chunked needs a loop-closure preset "
              "(in-scan detection requires a vocabulary)", file=sys.stderr)
        return 2

    print(f"[run] rendering {world.n_frames} frames...")
    frames = [world.render(i)[:2] for i in range(world.n_frames)]
    # RGB source for map colors when exporting a map (config 2)
    rgbs = (
        [world.render_rgb(i) for i in range(world.n_frames)]
        if cfg.export_map else [None] * world.n_frames
    )

    vocab = None
    if cfg.loop.enabled:
        print(f"[run] training vocabulary from sequence frames on {dev}...")
        X, docs = sequence_descriptors([f[0] for f in frames], cfg, dev)
        # 8^3 = 512 words: enough leaves that unrelated frames stop
        # saturating the L1 scores (a 64-word tree scores everything ~0.8
        # on the self-similar synthetic texture, drowning true revisits).
        vocab = vocab_mod.train(X, k=8, levels=3, doc_ids=docs, device=dev)

    out = RunOutputs(args.out)
    if vocab is not None:
        vocab.save(os.path.join(args.out, "vocab.npz"))
    fps = profiling.FpsMeter()

    if args.mode == "scan":
        lefts = np.stack([f[0] for f in frames])
        rights = np.stack([f[1] for f in frames])
        rgb = (np.stack(rgbs) if rgbs[0] is not None else None)
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
            print(f"[run] LOOP {q} -> {m} ({n_inl} inliers)")
    elif args.mode == "chunked":
        import torch

        from ros_stereo_slam_tpu_torch.models.slam_chunked import ChunkedSLAM

        slam = ChunkedSLAM(cfg, vocab, dev)
        with profiling.span("initialize"):
            slam.initialize(frames[0][0], frames[0][1], rgb0=rgbs[0])
        out.log_frame(FrameInfo(
            frame=0, T_wc=np.eye(4, dtype=np.float32), n_tracked=0,
            n_inliers=0, is_keyframe=True, tracking_ok=True,
            used_retry=False,
        ))
        C = args.chunk
        for s in range(1, world.n_frames, C):
            e = min(s + C, world.n_frames)
            lefts = np.stack([frames[i][0] for i in range(s, e)])
            rights = np.stack([frames[i][1] for i in range(s, e)])
            rg = (np.stack([rgbs[i] for i in range(s, e)])
                  if rgbs[0] is not None else None)
            with profiling.span("chunk"):
                info = slam.process_chunk(
                    lefts, rights, rgbs=rg,
                    query_frames=lambda fid: tuple(
                        torch.as_tensor(x).to(dev) for x in frames[fid][:2]),
                )
            for k2 in range(e - s):
                out.log_frame(FrameInfo(
                    frame=s + k2, T_wc=info.T_wc[k2],
                    n_tracked=int(info.n_tracked[k2]),
                    n_inliers=int(info.n_inliers[k2]),
                    is_keyframe=bool(info.is_keyframe[k2]),
                    tracking_ok=bool(info.tracking_ok[k2]),
                    used_retry=False,
                ))
            print(f"[run] chunk {s}..{e - 1}: "
                  f"inl_med={int(np.median(info.n_inliers))} "
                  f"kf={int(info.is_keyframe.sum())} "
                  f"accepted={info.n_accepted} corrected={info.corrected}")
        for q, m, n_inl in slam.loop_events:
            print(f"[run] LOOP {q} -> {m} ({n_inl} inliers)")
    else:
        from ros_stereo_slam_tpu_torch.models.slam import StereoSLAM

        slam = StereoSLAM(cfg, vocab=vocab, device=dev)
        with profiling.span("initialize"):
            info = slam.initialize(*frames[0], left_rgb=rgbs[0])
        out.log_frame(info)
        for i in range(1, world.n_frames):
            with profiling.span("frame"):
                info = slam.process_frame(*frames[i], left_rgb=rgbs[i])
            out.log_frame(info, {"fps": round(fps.tick(), 2)})
            if info.is_keyframe or not info.tracking_ok:
                print(f"[run] f{info.frame}: inl={info.n_inliers} "
                      f"kf={info.is_keyframe} ok={info.tracking_ok}")
        for ev in slam.loop_events:
            print(f"[run] LOOP {ev.query} -> {ev.match} "
                  f"({ev.n_inliers} inliers)")

    summary = out.finalize(slam, gt_poses=world.poses, plots=not args.no_plots)
    profiling.dump(os.path.join(args.out, "stages.json"))
    print(f"[run] summary: {summary}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
