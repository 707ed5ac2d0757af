"""Result streaming / export adapter (reference C15 + C20).

Port of ``ros_stereo_slam_tpu/utils/outputs.py``.  The reference
publishes ROS topics (``SLAM/map``, ``SLAM/pose``, ``SLAM/trajectory`` —
``src/rosFuncs.cpp:41-98``) and dumps CSVs (``appendData/createData/
dumpOptimized`` ``include/monoUtils.h:23-70``); the adapter streams the
same payloads to files:

- per-frame pose rows -> ``trajectory.txt`` (KITTI 3x4) and
  ``trajectory.csv``
- map cloud -> ``map.ply`` (binary, with colors) and ``map.html``
- pose graph -> ``poseGraph.g2o``
- structured per-frame metrics -> ``metrics.jsonl``
- ATE/RPE -> ``summary.json``; with plots, ``trajectory.png`` and
  ``error_curve.png`` (:mod:`..viz.draw`, which needs matplotlib).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

import numpy as np

from ros_stereo_slam_tpu_torch.utils import ply as ply_mod


def pose_row_kitti(T: np.ndarray) -> str:
    """KITTI odometry format: the 3x4 [R|t] row-major."""
    return " ".join(f"{v:.9g}" for v in np.asarray(T)[:3, :4].reshape(-1))


def save_trajectory_kitti(path: str, poses: np.ndarray) -> None:
    with open(path, "w") as f:
        for T in poses:
            f.write(pose_row_kitti(T) + "\n")


def save_trajectory_csv(path: str, poses: np.ndarray) -> None:
    """CSV x,y,z rows (the reference's appendData layout)."""
    with open(path, "w") as f:
        f.write("frame,x,y,z\n")
        for i, T in enumerate(poses):
            t = T[:3, 3]
            f.write(f"{i},{t[0]:.6f},{t[1]:.6f},{t[2]:.6f}\n")


@dataclass
class RunOutputs:
    """Streaming sink for a SLAM run (one directory per run)."""

    out_dir: str
    _metrics_f: object = field(init=False, default=None)

    def __post_init__(self):
        os.makedirs(self.out_dir, exist_ok=True)
        self._metrics_f = open(os.path.join(self.out_dir, "metrics.jsonl"), "w")

    def log_frame(self, info, extra: dict | None = None) -> None:
        row = {
            "frame": info.frame,
            "n_tracked": info.n_tracked,
            "n_inliers": info.n_inliers,
            "is_keyframe": info.is_keyframe,
            "tracking_ok": info.tracking_ok,
            "used_retry": info.used_retry,
            "t": [float(v) for v in np.asarray(info.T_wc)[:3, 3]],
        }
        if extra:
            row.update(extra)
        self._metrics_f.write(json.dumps(row) + "\n")

    def finalize(self, slam, gt_poses: np.ndarray | None = None, plots: bool = True) -> dict:
        """Write trajectory/map/graph artifacts; returns summary stats.

        `slam`: a :class:`~ros_stereo_slam_tpu_torch.models.slam.StereoSLAM`,
        a :class:`~ros_stereo_slam_tpu_torch.models.slam_chunked.ChunkedSLAM`
        or a :class:`ScanRun`.  `plots` false skips the two PNGs (and the
        matplotlib import they need).
        """
        from ros_stereo_slam_tpu_torch.utils import metrics as metrics_mod
        from ros_stereo_slam_tpu_torch.viz import web

        est = slam.trajectory_array()
        save_trajectory_kitti(os.path.join(self.out_dir, "trajectory.txt"), est)
        save_trajectory_csv(os.path.join(self.out_dir, "trajectory.csv"), est)
        summary: dict = {"frames": int(est.shape[0])}
        pts, cols = slam.map_points()
        if hasattr(slam, "save_map"):
            summary["map_points"] = slam.save_map(os.path.join(self.out_dir, "map.ply"))
        else:
            summary["map_points"] = ply_mod.save_ply(
                os.path.join(self.out_dir, "map.ply"), pts, cols
            )
        if hasattr(slam, "save_graph"):
            slam.save_graph(os.path.join(self.out_dir, "poseGraph.g2o"))
        web.export_html(
            os.path.join(self.out_dir, "map.html"),
            est, pts, cols,
            keyframe_idx=getattr(slam, "keyframe_frames", None),
        )
        draw = None
        if plots:
            from ros_stereo_slam_tpu_torch.viz import draw
        if gt_poses is not None:
            summary["ate_rmse"] = metrics_mod.ate_rmse(est, gt_poses)
            rpe_t, rpe_r = metrics_mod.rpe(est, gt_poses)
            summary["rpe_trans"] = rpe_t
            summary["rpe_rot_deg"] = rpe_r
            if draw is not None:
                draw.draw_error_curve(
                    est, gt_poses, os.path.join(self.out_dir, "error_curve.png")
                )
        if draw is not None:
            draw.draw_trajectory(
                est,
                os.path.join(self.out_dir, "trajectory.png"),
                gt_poses=gt_poses,
                keyframe_idx=getattr(slam, "keyframe_frames", None),
                loop_events=getattr(slam, "loop_events", None),
            )
        self._metrics_f.close()
        with open(os.path.join(self.out_dir, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
        return summary


@dataclass
class ScanRun:
    """Adapts a whole-sequence scan result to the streaming-driver
    surface :meth:`RunOutputs.finalize` expects.

    Wraps either a :class:`~ros_stereo_slam_tpu_torch.models.pipeline.
    OfflineResult` (odometry/mapping/ba presets) or a
    :class:`~ros_stereo_slam_tpu_torch.models.slam_scan.ScanSlamResult`
    (loop-closure preset), so the CLIs' ``--mode scan`` produces the same
    artifact set (trajectory/map/g2o/metrics) as the streaming and
    chunked modes.
    """

    result: object
    config: object

    def trajectory_array(self) -> np.ndarray:
        return np.asarray(self.result.trajectory)

    @property
    def loop_events(self) -> list:
        return getattr(self.result, "loop_events", []) or []

    @property
    def keyframe_frames(self) -> list:
        kf = self.result.keyframes
        idx = kf.frame_idx.cpu().numpy()[kf.valid.cpu().numpy()]
        return sorted(int(i) for i in np.unique(idx))

    def map_points(self):
        from ros_stereo_slam_tpu_torch.models.pipeline import map_points_of

        return map_points_of(self.result.keyframes)

    def save_map(self, path: str) -> int:
        pts, cols = self.map_points()
        return ply_mod.save_ply(path, pts, cols)

    def save_graph(self, path: str) -> None:
        """g2o export: odometry-chain edges from the RAW odometry
        trajectory (the measured relative motions, as the reference's
        ``saveStructure``) plus any accepted loop edges; vertices at the
        final (post-PGO) trajectory.  The graph lives on the run's device."""
        import torch

        from ros_stereo_slam_tpu_torch.models import pose_graph as pg_mod

        dev = self.result.keyframes.poses.device
        traj = self.trajectory_array()
        traj_odo = np.asarray(getattr(self.result, "trajectory_odo", traj))
        g = pg_mod.PoseGraph(self.config.pgo, device=dev)
        g.initialize()
        Zs = pg_mod.chain_measurements(torch.as_tensor(traj_odo, dtype=torch.float32,
                                                       device=dev))
        g.add_odometry_batch(Zs[1:])
        for (i, j, Z) in (getattr(self.result, "loop_edges", None) or []):
            g.add_loop(int(i), int(j), Z)
        g.save(path, traj)

    def frame_infos(self) -> list:
        """Per-frame FrameInfo rows (frame 0 = bootstrap) for
        :meth:`RunOutputs.log_frame` — scan runs emit the same
        metrics.jsonl schema as the per-frame drivers."""
        from ros_stereo_slam_tpu_torch.models.pipeline import FrameInfo

        res = self.result
        traj = self.trajectory_array()
        n_tracked = getattr(res, "n_tracked", None)
        infos = [FrameInfo(
            frame=0, T_wc=traj[0], n_tracked=0, n_inliers=0,
            is_keyframe=True, tracking_ok=True, used_retry=False,
        )]
        used_retry = getattr(res, "used_retry", None)
        for i in range(len(res.n_inliers)):
            infos.append(FrameInfo(
                frame=i + 1,
                T_wc=traj[i + 1],
                n_tracked=int(n_tracked[i]) if n_tracked is not None
                else int(res.n_inliers[i]),
                n_inliers=int(res.n_inliers[i]),
                is_keyframe=bool(res.is_keyframe[i]),
                tracking_ok=bool(res.tracking_ok[i]),
                used_retry=bool(used_retry[i])
                if used_retry is not None else False,
            ))
        return infos
