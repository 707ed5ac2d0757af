"""The points-sharded odometry step (config 5, data-parallel over points).

Counterpart of step 1 of the JAX package's
``__graft_entry__.dryrun_multichip``: ``frontend.odometry_step`` under
``jax.jit`` with the tracked-point axis sharded over the mesh and the pose
replicated, where XLA's partitioner inserts the collectives.  Here every
rank passes the whole inputs (as :func:`.dist_ba.ba_solve_sharded` does)
and works on its block of N / D points (``shard_bounds``):

- LK (``lk.track``; kernel K1 on the card) on the rank's points, then one
  ``all_gather`` of the tracked points and their validity;
- the minimal sets drawn on every rank from the gathered mask (identically
  seeded generators draw the same sets), the 8-point and P6P fits, the
  normalisation, the F refit and its guard, and the argmax over
  hypotheses, replicated on whole rows;
- the (K, N) Sampson and reprojection scoring on the rank's columns, the
  counts summed over the ranks (int64); the best F hypothesis' errors
  gathered (one ``all_gather``); PnP's Gauss-Newton normal equations
  (float64) summed over the ranks, one all-reduce a step.

Only integer counts and float64 normal equations cross ranks as sums, so
the inlier sets are the single call's; at world size 1 the whole result
is the single call's bit for bit.  A step makes 2 all_gathers and
3 + 2 x ``refine_iters`` all-reduces.
"""

from __future__ import annotations

import torch

from ros_stereo_slam_tpu_torch.config import FrontendConfig, PnPConfig
from ros_stereo_slam_tpu_torch.models.frontend import (
    Draw, OdometryOut, _draw_from, _lk_params,
)
from ros_stereo_slam_tpu_torch.models.state import TrackState
from ros_stereo_slam_tpu_torch.ops import lk, pnp, ransac
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, all_gather, shard_bounds
from ros_stereo_slam_tpu_torch.utils import lie
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


def odometry_step_sharded(mesh: Mesh, ref_pyr: tuple, cur_pyr: tuple, track: TrackState,
                          gen: torch.Generator, cam: Pinhole, pnp_thresh, fe: FrontendConfig,
                          pc: PnPConfig) -> OdometryOut:
    """``frontend.odometry_step`` with the points sharded over `mesh`.

    `gen` is seeded alike on every rank.  `T_cw`, `T_wc`, `n_tracked` and
    `n_inliers` are the same on every rank; `tracked` and `mask` are this
    rank's (N / D, ...) block.
    """
    return odometry_from_sets_sharded(mesh, ref_pyr, cur_pyr, track, _draw_from(gen), cam,
                                      pnp_thresh, fe, pc)


def odometry_from_sets_sharded(mesh: Mesh, ref_pyr: tuple, cur_pyr: tuple, track: TrackState,
                               draw: Draw, cam: Pinhole, pnp_thresh, fe: FrontendConfig,
                               pc: PnPConfig) -> OdometryOut:
    """:func:`odometry_step_sharded` with its minimal sets from `draw`
    (``frontend.odometry_from_sets``' form), called on every rank with the
    whole (gathered) mask."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.mesh.Mesh (make_mesh), not "
                        f"{type(mesh).__name__}")
    blk = shard_bounds(track.pts2d.shape[0], mesh, "points")
    res = lk.track(ref_pyr, cur_pyr, track.pts2d[blk], None, _lk_params(fe))
    both = all_gather(torch.cat([res.points, res.valid[:, None].to(res.points.dtype)], 1), mesh)
    tracked, valid = both[:, :2].contiguous(), both[:, 2] > 0
    m = track.mask & valid
    fres = ransac._fmat_from_sets(draw(m, fe.fmat_iters, 8), track.pts2d, tracked, m,
                                  thresh_px=fe.fmat_thresh_px, mesh=mesh)
    m = m & fres.inliers
    n_tracked = m.sum()
    pres = pnp._solve(
        draw(m, pc.iters, 6), None, cam, track.pts3d, tracked, m,
        thresh_px=pnp_thresh, refine_iters=pc.refine_iters, huber_px=pc.refine_huber_px,
        mesh=mesh,
    )
    return OdometryOut(
        T_cw=pres.T_cw,
        T_wc=lie.inv_se3(pres.T_cw),
        tracked=res.points,
        mask=pres.inliers,
        n_tracked=n_tracked,
        n_inliers=pres.n_inliers,
    )
