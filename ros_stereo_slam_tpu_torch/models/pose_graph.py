"""SE(3) pose-graph optimization over the odometry chain and loop edges.

Port of ``optimize``, ``chain_measurements`` and ``rewrite_points`` from
``ros_stereo_slam_tpu/models/pose_graph.py``: Gauss-Newton with
right-perturbation Jacobians (second-order inverse right Jacobian),
vertex 0 fixed, identity information, and the normal equations solved
by block-Jacobi-preconditioned conjugate gradient whose matvec is an
edge-wise gather and scatter.  The ``PoseGraph`` class, g2o I/O and the
edge-sharded layout are not ported yet.
"""

from __future__ import annotations

import torch

from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.utils import lie


def _ad_se3(xi: torch.Tensor) -> torch.Tensor:
    """Little adjoint of (..., 6) twists (rho, phi): [[phi^, rho^], [0, phi^]]."""
    ph = lie.hat_so3(xi[..., 3:])
    rh = lie.hat_so3(xi[..., :3])
    top = torch.cat([ph, rh], dim=-1)
    bot = torch.cat([torch.zeros_like(ph), ph], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _jr_inv(r: torch.Tensor) -> torch.Tensor:
    """Second-order inverse right Jacobian of SE(3) at twists r (..., 6)."""
    ad = _ad_se3(r)
    eye = torch.eye(6, dtype=r.dtype, device=r.device)
    return eye + 0.5 * ad + (1.0 / 12.0) * (ad @ ad)


def _edge_residual_jacobians(Ti, Tj, Z):
    """r = log(Z^-1 Ti^-1 Tj) and the right-perturbation Jacobians (Ji, Jj)."""
    Tij = lie.inv_se3(Ti) @ Tj
    r = lie.log_se3(lie.inv_se3(Z) @ Tij)
    Jri = _jr_inv(r)
    return r, -Jri @ lie.adjoint_se3(lie.inv_se3(Tij)), Jri


def optimize(
    poses: torch.Tensor,  # (F, 4, 4) current estimates
    n_poses: int,  # number of valid poses
    odo_Z: torch.Tensor,  # (F, 4, 4); measurement of edge (idx-1 -> idx)
    loop_i: torch.Tensor,  # (L,) int edge endpoints
    loop_j: torch.Tensor,  # (L,)
    loop_Z: torch.Tensor,  # (L, 4, 4) loop measurements
    loop_valid: torch.Tensor,  # (L,) bool
    iters: int = 10,
    cg_iters: int = 64,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Gauss-Newton over the pose chain; returns the optimized (F, 4, 4)."""
    F = poses.shape[0]
    dev, dt = poses.device, poses.dtype
    idx = torch.arange(F, device=dev)
    prev = torch.clamp(idx - 1, min=0)
    loop_i, loop_j = loop_i.to(torch.int64), loop_j.to(torch.int64)
    # Odometry edge e connects (e-1, e), valid for 1 <= e < n_poses.
    w_o = ((idx >= 1) & (idx < n_poses)).to(dt)
    w_l = loop_valid.to(dt)
    # Gauge: vertex 0 is constant.
    free = ((idx > 0) & (idx < n_poses)).to(dt)

    def vertex_ok(vid):
        return ((vid > 0) & (vid < n_poses)).to(dt)[:, None, None]

    def scatter(rows, vals, out):
        return out.index_add_(0, rows, vals)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    T = poses
    for _ in range(iters):
        r_o, Ji_o, Jj_o = _edge_residual_jacobians(T[prev], T, odo_Z)
        r_l, Ji_l, Jj_l = _edge_residual_jacobians(T[loop_i], T[loop_j], loop_Z)
        Ji_o = Ji_o * vertex_ok(idx - 1) * w_o[:, None, None]
        Jj_o = Jj_o * vertex_ok(idx) * w_o[:, None, None]
        Ji_l = Ji_l * vertex_ok(loop_i) * w_l[:, None, None]
        Jj_l = Jj_l * vertex_ok(loop_j) * w_l[:, None, None]
        r_o_w = r_o * w_o[:, None]
        r_l_w = r_l * w_l[:, None]

        def jt(J, r):
            return torch.einsum("eab,ea->eb", J, r)

        # right-hand side b = -sum J^T r, scattered per vertex
        b = torch.zeros((F, 6), dtype=dt, device=dev)
        for rows, J, r in ((prev, Ji_o, r_o_w), (idx, Jj_o, r_o_w),
                           (loop_i, Ji_l, r_l_w), (loop_j, Jj_l, r_l_w)):
            scatter(rows, -jt(J, r), b)

        # block diagonal of H for the Jacobi preconditioner
        D = torch.zeros((F, 6, 6), dtype=dt, device=dev)
        for rows, J in ((prev, Ji_o), (idx, Jj_o), (loop_i, Ji_l), (loop_j, Jj_l)):
            scatter(rows, torch.einsum("eab,eac->ebc", J, J), D)
        D_inv = linalg.spd_inverse_small(D + (damping + 1e-8) * eye6)

        def hx(x):
            """H @ x by edge-wise gather and scatter (x: (F, 6))."""
            t_o = (torch.einsum("eab,eb->ea", Ji_o, x[prev])
                   + torch.einsum("eab,eb->ea", Jj_o, x))
            t_l = (torch.einsum("eab,eb->ea", Ji_l, x[loop_i])
                   + torch.einsum("eab,eb->ea", Jj_l, x[loop_j]))
            out = torch.zeros_like(x)
            for rows, J, t in ((prev, Ji_o, t_o), (idx, Jj_o, t_o),
                               (loop_i, Ji_l, t_l), (loop_j, Jj_l, t_l)):
                scatter(rows, jt(J, t), out)
            return out + damping * x

        def precond(v):
            return torch.einsum("fab,fb->fa", D_inv, v)

        def safe(v):
            return torch.where(v.abs() > 1e-20, v, torch.full_like(v, 1e-20))

        # preconditioned CG from x = 0
        x = torch.zeros((F, 6), dtype=dt, device=dev)
        r = b - hx(x)
        z = precond(r)
        p = z
        rz = (r * z).sum()
        for _ in range(cg_iters):
            Ap = hx(p)
            alpha = rz / safe((p * Ap).sum())
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = (r * z).sum()
            p = z + (rz_new / safe(rz)) * p
            rz = rz_new
        # right update: T <- T exp(x^)
        T = T @ lie.exp_se3(x * free[:, None])
    return T


def chain_measurements(poses: torch.Tensor) -> torch.Tensor:
    """Odometry measurements of a trajectory: Z[i] = T_{i-1}^-1 T_i (Z[0] = I)."""
    prev = torch.cat([poses[:1], poses[:-1]], dim=0)
    return lie.inv_se3(prev) @ poses


def rewrite_points(
    points: torch.Tensor,  # (K, P, 3) keyframe cloud blocks (world frame)
    kf_frame_idx: torch.Tensor,  # (K,) pose index of each keyframe
    old_poses: torch.Tensor,  # (F, 4, 4)
    new_poses: torch.Tensor,  # (F, 4, 4)
) -> torch.Tensor:
    """Re-express keyframe clouds after PGO: p' = T_new T_old^-1 p."""
    fi = kf_frame_idx.to(torch.int64)
    delta = new_poses[fi] @ lie.inv_se3(old_poses[fi])
    return (torch.einsum("kij,kpj->kpi", delta[:, :3, :3], points)
            + delta[:, None, :3, 3])
