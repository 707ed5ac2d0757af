"""SLAM state as fixed-capacity NamedTuples of tensors.

Port of ``ros_stereo_slam_tpu/models/state.py`` (``TrackState``,
``KeyframeStore`` and ``TrajectoryStore``).  Every store has a static capacity plus a validity
mask or count, as in the reference.  The batched-lane drivers stack B
lanes on a leading axis of every field (``lanes=B`` in ``empty``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class TrackState(NamedTuple):
    """Live feature set tracked frame-to-frame (world-frame landmarks)."""

    pts2d: torch.Tensor  # (N, 2) f32 — positions in the *reference* image
    pts3d: torch.Tensor  # (N, 3) f32 — world-frame landmark positions
    colors: torch.Tensor  # (N, 3) f32 — intensity sampled at triangulation
    mask: torch.Tensor  # (N,) bool

    @staticmethod
    def empty(capacity: int, device: torch.device | str, lanes: int | None = None) -> "TrackState":
        f32 = dict(dtype=torch.float32, device=device)
        ln = () if lanes is None else (lanes,)
        return TrackState(
            pts2d=torch.zeros((*ln, capacity, 2), **f32),
            pts3d=torch.zeros((*ln, capacity, 3), **f32),
            colors=torch.zeros((*ln, capacity, 3), **f32),
            mask=torch.zeros((*ln, capacity), dtype=torch.bool, device=device),
        )


class KeyframeStore(NamedTuple):
    """Ring buffer of keyframes with their map-cloud blocks.

    ``retrack`` mirrors the reference's flag: keyframes whose cloud
    re-enters the map after a loop-closure rewrite.
    """

    poses: torch.Tensor  # (K, 4, 4) f32 — world-from-cam at insertion
    frame_idx: torch.Tensor  # (K,) i32 — source frame index
    points: torch.Tensor  # (K, P, 3) f32 — world-frame cloud block
    colors: torch.Tensor  # (K, P, 3) f32
    point_mask: torch.Tensor  # (K, P) bool
    retrack: torch.Tensor  # (K,) bool
    valid: torch.Tensor  # (K,) bool — slot occupied
    count: torch.Tensor  # () i32 — number of keyframes inserted (may exceed K)

    @staticmethod
    def empty(capacity: int, block: int, device: torch.device | str,
              lanes: int | None = None) -> "KeyframeStore":
        f32 = dict(dtype=torch.float32, device=device)
        ln = () if lanes is None else (lanes,)
        return KeyframeStore(
            poses=torch.eye(4, **f32).repeat(*ln, capacity, 1, 1),
            frame_idx=torch.zeros((*ln, capacity), dtype=torch.int32, device=device),
            points=torch.zeros((*ln, capacity, block, 3), **f32),
            colors=torch.zeros((*ln, capacity, block, 3), **f32),
            point_mask=torch.zeros((*ln, capacity, block), dtype=torch.bool, device=device),
            retrack=torch.zeros((*ln, capacity), dtype=torch.bool, device=device),
            valid=torch.zeros((*ln, capacity), dtype=torch.bool, device=device),
            count=torch.zeros(ln, dtype=torch.int32, device=device),
        )

    @property
    def capacity(self) -> int:
        return self.poses.shape[-3]


class TrajectoryStore(NamedTuple):
    """Per-frame pose chain (reference ``isoVector`` + canvas trajectory)."""

    poses: torch.Tensor  # (F, 4, 4) f32 — world-from-cam per frame
    valid: torch.Tensor  # (F,) bool
    count: torch.Tensor  # () i32

    @staticmethod
    def empty(capacity: int, device: torch.device | str) -> "TrajectoryStore":
        return TrajectoryStore(
            poses=torch.eye(4, dtype=torch.float32, device=device).repeat(capacity, 1, 1),
            valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
            count=torch.zeros((), dtype=torch.int32, device=device),
        )


class KeyframeShard(NamedTuple):
    """A rank's block of a keyframe ring sharded over a mesh
    (:func:`ros_stereo_slam_tpu_torch.parallel.dist_map.keyframe_shardings`):
    it holds slots ``[base, base + K/D)`` of a ring of `capacity` slots."""

    base: int
    capacity: int  # the whole ring's
