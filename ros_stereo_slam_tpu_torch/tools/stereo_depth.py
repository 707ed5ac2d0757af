"""Standalone dense-disparity node (reference C18 — the ``stereo`` exe,
``reference/src/StereoCV.cpp:252-273``): SGBM disparity -> depth cloud ->
SOR -> PLY (+ disparity PNGs per frame, which need matplotlib).

Port of ``tools/stereo_depth.py`` over ``ops/sgbm.py::depth_cloud``.

  python -m ros_stereo_slam_tpu_torch.tools.stereo_depth --synthetic --frames 8 \
      --out runs/stereo
  python -m ros_stereo_slam_tpu_torch.tools.stereo_depth --root /data/kitti --seq 00 \
      --frames 100
"""

from __future__ import annotations

import argparse
import os
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ros_stereo_slam_tpu_torch.tools.stereo_depth")
    ap.add_argument("--root", default=None)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--max-disp", type=int, default=96)
    ap.add_argument("--out", default="runs/stereo")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--no-plots", action="store_true",
                    help="skip the disparity PNGs (they need matplotlib)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from ros_stereo_slam_tpu_torch.data import kitti
    from ros_stereo_slam_tpu_torch.data.synthetic import small_world
    from ros_stereo_slam_tpu_torch.ops import sgbm
    from ros_stereo_slam_tpu_torch.tools import device_of
    from ros_stereo_slam_tpu_torch.utils import ply
    from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

    dev = device_of(args.device)
    if dev is None:
        return 2
    if args.synthetic:
        world = small_world(n_frames=args.frames, seed=5)
        camc = world.camera

        def pair(i):
            L, R, _ = world.render(i)
            return L, R
        n = args.frames
    else:
        root = args.root or kitti.find_kitti_root()
        if root is None:
            print("ERROR: no KITTI root", file=sys.stderr)
            return 2
        seq = kitti.KittiSequence(root, args.seq)
        camc = seq.camera
        pair = seq.frame
        n = min(len(seq), args.frames)
        print(f"[stereo] sequence {args.seq}: frames read by the {seq.route} decoder")

    draw = None
    if not args.no_plots:
        from ros_stereo_slam_tpu_torch.viz import draw
    cam = Pinhole(fx=float(camc.fx), fy=float(camc.fy), cx=float(camc.cx), cy=float(camc.cy))
    os.makedirs(args.out, exist_ok=True)
    all_pts = []
    for i in range(n):
        L, R = (torch.as_tensor(x).to(dev) for x in pair(i))
        res, pts = sgbm.depth_cloud(L, R, cam, float(camc.baseline), max_disp=args.max_disp)
        if draw is not None:
            draw.draw_disparity(res.disparity.cpu().numpy(),
                                os.path.join(args.out, f"disp_{i:04d}.png"),
                                max_disp=args.max_disp)
        all_pts.append(pts.cpu().numpy())
        print(f"[stereo] frame {i}: {len(all_pts[-1])} cloud points")
    cloud = np.concatenate(all_pts)
    n_out = ply.save_ply(os.path.join(args.out, "StereoCloud.ply"), cloud)
    print(f"[stereo] wrote {n_out} points to {args.out}/StereoCloud.ply")
    return 0


if __name__ == "__main__":
    sys.exit(main())
