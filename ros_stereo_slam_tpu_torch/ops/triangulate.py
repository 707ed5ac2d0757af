"""Stereo triangulation on a rectified rig.

Port of ``triangulate_rectified`` from
``ros_stereo_slam_tpu/ops/triangulate.py``.
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
