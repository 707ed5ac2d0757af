"""Multi-rank windowed bundle adjustment (config 5).

Port of ``ros_stereo_slam_tpu/parallel/dist_ba.py``.  The landmarks and
their observation columns are sharded over the ranks of a
:class:`~.mesh.Mesh`; each rank eliminates its own landmark blocks (the
batched 3x3 inverses) and the sums over landmarks that build the reduced
camera system are all-reduced inside
:func:`..models.bundle_adjust.ba_solve` (its `mesh`).  The poses are
replicated: W x 16 floats against the landmark blocks, so the traffic of
one Gauss-Newton step is one all-reduce of the 6W x 6W reduced system
with U, bp and the right-hand side (float64).
"""

from __future__ import annotations

import torch

from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba_mod
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, shard_bounds
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


def ba_solve_sharded(
    mesh: Mesh,
    cam: Pinhole,
    T_cw: torch.Tensor,  # (W, 4, 4)
    landmarks: torch.Tensor,  # (N, 3), N divisible by the mesh size
    obs: torch.Tensor,  # (W, N, 2)
    obs_mask: torch.Tensor,  # (W, N)
    fixed: torch.Tensor,  # (W,)
    iters: int = 10,
    damping: float = 1e-4,
    huber_px: float = 2.0,
) -> ba_mod.BAResult:
    """Landmark-sharded BA: every rank passes the whole window and solves
    on its block of N / D landmarks.  Returns the poses and both RMS values
    (the same on every rank) and this rank's (N / D, 3) block of
    landmarks."""
    blk = shard_bounds(landmarks.shape[0], mesh, "landmarks")
    return ba_mod.ba_solve(cam, T_cw, landmarks[blk], obs[:, blk], obs_mask[:, blk], fixed,
                           iters=iters, damping=damping, huber_px=huber_px, mesh=mesh)
