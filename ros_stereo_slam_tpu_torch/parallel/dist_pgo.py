"""Multi-rank pose-graph optimization (config 5).

Port of ``ros_stereo_slam_tpu/parallel/dist_pgo.py``.  Two layouts, both
the single-device solve (:func:`..models.pose_graph.optimize`) spread over
the ranks of a :class:`~.mesh.Mesh`; every rank calls them with the same
full arrays:

- :func:`optimize_sharded`, EDGE-sharded: ``pose_graph.optimize`` with
  the mesh (rank d takes the odometry edges of its block and rank 0 the
  loop edges, the poses stay replicated, the normal-equation terms are
  summed over the ranks).  O(F) state per rank.
- :func:`optimize_chain_sharded`, CHAIN-partitioned: rank d owns poses
  ``[d*B, (d+1)*B)`` and the odometry edges ending in them.  Per
  Gauss-Newton and CG step the only traffic is a one-row ring halo (the
  left neighbour's last pose or CG vector), the boundary edge's share sent
  back to the left neighbour, one all-reduce of the L loop edges' endpoint
  rows and one per CG dot product.  O(F/D) state per rank: the pose and
  edge blocks, their Jacobians and the CG vectors are (F/D, ...).  The
  solve is ``pose_graph.gauss_newton`` on the block.

At world size 1 both are the single-device solve bit for bit (the halo and
the send-back then stay on the rank; each sum adds the same terms in the
same order).
"""

from __future__ import annotations

import torch

from ros_stereo_slam_tpu_torch.models import pose_graph as pg_mod
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, ppermute, psum, shard_bounds


def optimize_sharded(
    mesh: Mesh,
    poses: torch.Tensor,  # (F, 4, 4); F divisible by the mesh size
    n_poses: int,
    odo_Z: torch.Tensor,  # (F, 4, 4)
    loop_i: torch.Tensor, loop_j: torch.Tensor, loop_Z: torch.Tensor,
    loop_valid: torch.Tensor,
    iters: int = 10,
    cg_iters: int = 64,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Edge-sharded PGO; returns the optimized (F, 4, 4) on every rank."""
    return pg_mod.optimize(poses, n_poses, odo_Z, loop_i, loop_j, loop_Z, loop_valid,
                           iters=iters, cg_iters=cg_iters, damping=damping, mesh=mesh)


def optimize_chain_sharded(
    mesh: Mesh,
    poses: torch.Tensor,  # (F, 4, 4); F divisible by the mesh size
    n_poses: int,
    odo_Z: torch.Tensor,  # (F, 4, 4); odo_Z[e] measures edge (e-1 -> e)
    loop_i: torch.Tensor, loop_j: torch.Tensor,  # (L,)
    loop_Z: torch.Tensor,  # (L, 4, 4)
    loop_valid: torch.Tensor,  # (L,) bool
    iters: int = 10,
    cg_iters: int = 64,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Chain-partitioned PGO; returns this rank's optimized (F/D, 4, 4)
    block of poses ``[d*B, (d+1)*B)``."""
    blk = shard_bounds(poses.shape[0], mesh, "poses")
    base, B = blk.start, blk.stop - blk.start
    dev, dt = poses.device, poses.dtype
    e = torch.arange(base, blk.stop, device=dev)  # global vertex (and edge) ids
    li, lj = loop_i.to(torch.int64), loop_j.to(torch.int64)
    L = li.shape[0]
    w_o = ((e >= 1) & (e < n_poses)).to(dt)
    w_l = loop_valid.to(dt)
    free = ((e > 0) & (e < n_poses)).to(dt)
    # Loop endpoints: the rank that owns each row, and its local index.
    own = torch.cat([(li >= base) & (li < blk.stop), (lj >= base) & (lj < blk.stop)]).to(dt)
    li_loc, lj_loc = (li - base).clamp(0, B - 1), (lj - base).clamp(0, B - 1)

    def vertex_ok(v):
        return ((v > 0) & (v < n_poses)).to(dt)[:, None, None]

    def prev_rows(x):
        """Rows e - 1 of the global x for the block's edges: the left
        neighbour's last row (one ring hop), then the block's own rows.
        Global edge 0 has no left vertex: it reads row 0, as the
        single-device solve does, and is masked."""
        halo = ppermute(x[-1], mesh, 1)
        return torch.cat([(halo if base > 0 else x[0])[None], x[:-1]])

    def gather_rows(x):
        """x at the loop endpoints' global rows, on every rank: each owner
        contributes its rows, one all-reduce adds them."""
        rows = torch.cat([x[li_loc], x[lj_loc]])
        g = psum(rows * own.view((-1,) + (1,) * (x.dim() - 1)), mesh)
        return g[:L], g[L:]

    def ends(x):
        return (prev_rows(x), x) + gather_rows(x)

    def scatter_block(ci, cj, cli, clj):
        """Per-vertex sums in the single-device order: ci[e] lands on row
        e - 1 (ci[0], the boundary edge's left vertex, goes back to the
        left neighbour's last row), cj[e] on row e, then the loop rows this
        rank owns."""
        out = torch.zeros((B,) + ci.shape[1:], dtype=ci.dtype, device=dev)
        out[:-1] += ci[1:]
        out[-1] += ppermute(ci[0], mesh, -1)
        out += cj
        o = own.view((-1,) + (1,) * (ci.dim() - 1))
        out.index_add_(0, li_loc, cli * o[:L])
        out.index_add_(0, lj_loc, clj * o[L:])
        return out

    def dot(a, b):
        return psum((a * b).sum(), mesh)

    ok = (vertex_ok(e - 1), vertex_ok(e), vertex_ok(li), vertex_ok(lj))
    return pg_mod.gauss_newton(poses[blk], odo_Z[blk], loop_Z, w_o, w_l, ok, free, ends,
                               scatter_block, dot, iters, cg_iters, damping)
