"""Host-side odometry drivers.

Port of ``ros_stereo_slam_tpu/models/pipeline.py``:

- :class:`StereoOdometry` — streaming driver: one frame step per call;
  the host reads a handful of scalars per frame.
- :func:`run_offline` — throughput driver: the sequence is staged on the
  device once, stepped frame by frame, and the stats come back at the end.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import step as step_mod
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore
from ros_stereo_slam_tpu_torch.ops import grid
from ros_stereo_slam_tpu_torch.utils import profiling


@dataclass
class FrameInfo:
    """Host-visible per-frame result (a few scalars + the pose)."""

    frame: int
    T_wc: np.ndarray  # (4, 4)
    n_tracked: int
    n_inliers: int
    is_keyframe: bool
    tracking_ok: bool
    used_retry: bool


@dataclass
class OfflineResult:
    """Result of a whole-sequence run."""

    trajectory: np.ndarray  # (F, 4, 4) incl. frame 0
    n_tracked: np.ndarray  # (F-1,)
    n_inliers: np.ndarray  # (F-1,)
    is_keyframe: np.ndarray  # (F-1,) bool
    tracking_ok: np.ndarray  # (F-1,) bool
    used_retry: np.ndarray  # (F-1,) bool
    keyframes: KeyframeStore  # final device-side store
    ba_rms: np.ndarray | None = None  # (F-1,) post-BA reprojection RMS (0: BA off)


def _grid_for(cfg: PipelineConfig, device) -> tuple[torch.Tensor, torch.Tensor]:
    c, fe = cfg.camera, cfg.frontend
    pts, mask = grid.grid_points(c.height, c.width, fe.grid_step, fe.max_points)
    return torch.from_numpy(pts).to(device), torch.from_numpy(mask).to(device)


@dataclass
class StereoOdometry:
    """Streaming odometry driver over the frame step."""

    config: PipelineConfig
    device: torch.device | str = "cuda"
    frame_count: int = field(init=False, default=0)

    def __post_init__(self):
        self.grid_pts, self.grid_mask = _grid_for(self.config, self.device)
        self._carry = None
        self.trajectory: list[np.ndarray] = []
        self.keyframe_frames: list[int] = []
        self.tracking_failed = False

    def _frame(self, img) -> torch.Tensor:
        return torch.as_tensor(img, dtype=torch.float32).to(self.device).contiguous()

    # -- public API --------------------------------------------------------

    def initialize(self, left, right, left_rgb=None) -> FrameInfo:
        """Frame 0: triangulate the initial feature set (coloured from
        `left_rgb` (H, W, 3) float32 or uint8, if given)."""
        self._carry = step_mod.init_carry(
            self._frame(left), self._frame(right), self.grid_pts,
            self.grid_mask, self.config.seed, self.config,
            rgb_frame(left_rgb, self.device),
        )
        n = int(self._carry.track.mask.sum())
        self.trajectory.append(self._carry.T_wc.cpu().numpy())
        self.keyframe_frames.append(0)
        self.frame_count = 1
        return FrameInfo(
            frame=0, T_wc=self.trajectory[-1], n_tracked=n, n_inliers=n,
            is_keyframe=True, tracking_ok=True, used_retry=False,
        )

    def process_frame(self, left, right, left_rgb=None) -> FrameInfo:
        """One odometry frame; `left_rgb` colours a keyframe's points."""
        self._carry, stats = step_mod.slam_frame_step(
            self._carry, self._frame(left), self._frame(right),
            self.grid_pts, self.grid_mask, self.config,
            rgb_frame(left_rgb, self.device),
        )
        frame_idx = self.frame_count
        self.frame_count += 1
        info = FrameInfo(
            frame=frame_idx,
            T_wc=stats.T_wc.cpu().numpy(),
            n_tracked=int(stats.n_tracked),
            n_inliers=int(stats.n_inliers),
            is_keyframe=bool(stats.is_keyframe),
            tracking_ok=bool(stats.tracking_ok),
            used_retry=bool(stats.used_retry),
        )
        self.trajectory.append(info.T_wc)
        if info.is_keyframe:
            self.keyframe_frames.append(frame_idx)
        if not info.tracking_ok:
            self.tracking_failed = True
        return info

    @property
    def keyframes(self) -> KeyframeStore:
        return self._carry.keyframes

    # -- outputs -----------------------------------------------------------

    def trajectory_array(self) -> np.ndarray:
        return np.stack(self.trajectory, axis=0)

    def map_points(self) -> tuple[np.ndarray, np.ndarray]:
        """(M, 3) world points + (M, 3) colors from all keyframe blocks."""
        return map_points_of(self.keyframes)


def map_points_of(kf: KeyframeStore) -> tuple[np.ndarray, np.ndarray]:
    pm = (kf.point_mask & kf.valid[:, None]).cpu().numpy()
    return kf.points.cpu().numpy()[pm], kf.colors.cpu().numpy()[pm]


def _stage(seq, device) -> torch.Tensor:
    """(F, H, W) (or RGB (F, H, W, 3)) numpy or tensor -> tensor on
    `device`; uint8 stays uint8 (scaled per frame in the step), anything
    else becomes float32."""
    t = torch.as_tensor(seq)
    if t.dtype != torch.uint8:
        t = t.to(torch.float32)
    return t.to(device).contiguous()


def rgb_frame(img, device) -> torch.Tensor | None:
    """An (H, W, 3) RGB frame for the step, or None: staged as
    :func:`_stage` stages a sequence."""
    return None if img is None else _stage(img, device)


def run_offline(
    cfg: PipelineConfig,
    left_seq,
    right_seq,
    device: torch.device | str = "cuda",
    rgb_seq=None,
    block: bool = True,
) -> OfflineResult:
    """Run a full sequence: frame-0 bootstrap, then every frame.

    left_seq/right_seq: (F, H, W) float32 OR uint8 stacks (frame 0
    included), numpy arrays or tensors; they are staged on `device` once.
    rgb_seq: optional (F, H, W, 3) float32 or uint8 colour stack that
    colours the keyframe map points (the RGB map path; uint8 is staged as
    uint8 and scaled per keyframe).
    `block` is accepted as the reference accepts it: reading the stats to
    the host always waits for the device.
    """
    del block
    with profiling.span("driver.session", driver="run_offline", frames=len(left_seq),
                        lanes=1):
        grid_pts, grid_mask = _grid_for(cfg, device)
        left = _stage(left_seq, device)
        right = _stage(right_seq, device)
        rgb = rgb_frame(rgb_seq, device)
        carry = step_mod.init_carry(left[0], right[0], grid_pts, grid_mask, cfg.seed, cfg,
                                    None if rgb is None else rgb[0])
        carry, stats = step_mod.run_sequence(
            left[1:], right[1:], carry, grid_pts, grid_mask, cfg,
            None if rgb is None else rgb[1:])
        with profiling.span("host_read", site="run_offline.stats"):
            host = [f.cpu().numpy() for f in stats]
        stats = step_mod.FrameStats(*host)
        traj = np.concatenate([np.eye(4, dtype=np.float32)[None], stats.T_wc], axis=0)
        return OfflineResult(
            trajectory=traj,
            n_tracked=stats.n_tracked,
            n_inliers=stats.n_inliers,
            is_keyframe=stats.is_keyframe,
            tracking_ok=stats.tracking_ok,
            used_retry=stats.used_retry,
            keyframes=carry.keyframes,
            ba_rms=stats.ba_rms,
        )
