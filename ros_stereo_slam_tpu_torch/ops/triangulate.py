"""Stereo triangulation on a rectified rig.

Port of ``ros_stereo_slam_tpu/ops/triangulate.py``: the closed-form
rectified triangulation of the fast path and the general two-view DLT
(``cv::triangulatePoints``'s formulation) for verification.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


class TriangulationResult(NamedTuple):
    points: torch.Tensor  # (N, 3) camera-frame 3D points (left cam)
    valid: torch.Tensor  # (N,) bool
    depth: torch.Tensor  # (N,)


def triangulate_rectified(
    cam: Pinhole,
    baseline: float,
    uv_left: torch.Tensor,
    uv_right: torch.Tensor,
    mask: torch.Tensor,
    min_depth: float = 0.5,
    max_depth: float = 500.0,
    max_vertical_px: float = 2.0,
) -> TriangulationResult:
    """Closed-form depth from x-disparity on a rectified rig.

    The right camera sits +baseline along x, so disparity d = uL - uR > 0
    and z = fx * b / d.  |vL - vR| gates rectification violations.
    """
    d = uv_left[..., 0] - uv_right[..., 0]
    dv = torch.abs(uv_left[..., 1] - uv_right[..., 1])
    safe_d = torch.clamp(d, min=1e-6)
    z = cam.fx * baseline / safe_d
    x = (uv_left[..., 0] - cam.cx) / cam.fx * z
    y = (uv_left[..., 1] - cam.cy) / cam.fy * z
    pts = torch.stack([x, y, z], dim=-1)
    valid = (
        mask
        & (d > 1e-3)
        & (dv < max_vertical_px)
        & (z > min_depth)
        & (z < max_depth)
    )
    return TriangulationResult(points=pts, valid=valid, depth=z)


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """General two-view homogeneous DLT, batched over N points: (N, 3).

    Same formulation as ``cv::triangulatePoints``: each pair's 4x4 system,
    rows normalized, null vector from a batched SVD, de-homogenized.
    """
    A = torch.stack([
        uv1[:, 0:1] * P1[2] - P1[0],
        uv1[:, 1:2] * P1[2] - P1[1],
        uv2[:, 0:1] * P2[2] - P2[0],
        uv2[:, 1:2] * P2[2] - P2[1],
    ], dim=1)  # (N, 4, 4)
    # Row-normalize then SVD (f32 conditioning; eigh(A^T A) is too lossy).
    A = A / torch.linalg.norm(A, dim=2, keepdim=True)
    X = torch.linalg.svd(A).Vh[:, -1]
    w = X[:, 3:4]
    return X[:, :3] / torch.where(torch.abs(w) > 1e-12, w, torch.full_like(w, 1e-12))
