"""Pinhole camera model on tensors.

Port of ``ros_stereo_slam_tpu/utils/camera.py``.  The intrinsics stay
Python floats: they are configuration, and a float folds into every
kernel launch instead of costing a device tensor per use.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Pinhole(NamedTuple):
    """Intrinsics as a NamedTuple of scalars."""

    fx: float
    fy: float
    cx: float
    cy: float

    def K(self, device: torch.device | str = "cpu") -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32, device=device,
        )

    @staticmethod
    def from_K(K) -> "Pinhole":
        K = torch.as_tensor(K, dtype=torch.float32)
        return Pinhole(fx=float(K[0, 0]), fy=float(K[1, 1]),
                       cx=float(K[0, 2]), cy=float(K[1, 2]))


def kitti_default() -> Pinhole:
    """KITTI odometry grayscale cam intrinsics used by the reference."""
    return Pinhole(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)


def project(cam: Pinhole, pts_cam: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Project (N, 3) camera-frame points to (N, 2) pixels.

    Returns (uv, valid) where valid marks points with z > 0 (projection of
    non-positive depth points is extrapolated but flagged invalid).
    """
    z = pts_cam[..., 2]
    valid = z > 1e-6
    zs = torch.where(valid, z, torch.ones_like(z))
    u = cam.fx * pts_cam[..., 0] / zs + cam.cx
    v = cam.fy * pts_cam[..., 1] / zs + cam.cy
    return torch.stack([u, v], dim=-1), valid


def backproject(cam: Pinhole, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Lift (N, 2) pixels with (N,) depths to (N, 3) camera-frame points."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def normalize(cam: Pinhole, uv: torch.Tensor) -> torch.Tensor:
    """Pixels -> normalized image coordinates (z=1 plane)."""
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], dim=-1)
