"""SE(3) pose-graph optimization in plain PyTorch, float64: the work of the
program's pose graph after a full-SLAM session's closures.

The graph is the odometry chain, edge (i - 1, i) measuring
``Z = T_{i-1}^-1 T_i`` of the starting poses, and the loop edges
``(i, j, Z)``.  The cost is the sum over edges of
``|log(Z^-1 T_i^-1 T_j)|^2`` (identity information, twists as
(translation, rotation) with the translation through the inverse left
Jacobian), vertex 0 is held fixed, and each pose moves on the right,
``T <- T exp(d)``.  Each Gauss-Newton iteration takes the Jacobians by
central differences and solves the damped normal equations exactly.
"""

from __future__ import annotations

import torch

F64 = torch.float64
STEP = 1e-6  # central-difference step on each twist component


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew matrices."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _coeffs(th: torch.Tensor):
    """sin(t)/t, (1 - cos t)/t^2, (t - sin t)/t^3, series near 0."""
    small = th < 1e-4
    t = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th**2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - th**2 / 24, (1 - torch.cos(t)) / t**2)
    c = torch.where(small, 1 / 6 - th**2 / 120, (t - torch.sin(t)) / t**3)
    return a, b, c


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twists (rho, phi) -> (..., 4, 4) transforms."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = phi.norm(dim=-1)[..., None, None]
    K = hat(phi)
    a, b, c = _coeffs(th)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + a * K + b * (K @ K)
    V = eye + b * K + c * (K @ K)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = (V @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def log(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transforms (rotations well below pi) -> (..., 6) twists."""
    R = T[..., :3, :3]
    cos = ((R.diagonal(dim1=-2, dim2=-1).sum(-1) - 1) / 2).clamp(-1, 1)
    th = torch.arccos(cos)
    a, _, _ = _coeffs(th[..., None, None])
    W = (R - R.transpose(-1, -2)) / (2 * a)
    phi = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)
    _, b, c = _coeffs(phi.norm(dim=-1)[..., None, None])
    K = hat(phi)
    V = torch.eye(3, dtype=T.dtype, device=T.device) + b * K + c * (K @ K)
    rho = torch.linalg.solve(V, T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], -1)


def inv(T: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(T)
    Rt = T[..., :3, :3].transpose(-1, -2)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -(Rt @ T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1
    return out


def residuals(T, ii, jj, Zinv, di=None, dj=None):
    """(E, 6) residuals log(Z^-1 T_i^-1 T_j), each end perturbed on the
    right by the (E, 6) twists `di` / `dj` if given."""
    Ti, Tj = T[ii], T[jj]
    if di is not None:
        Ti, Tj = Ti @ exp(di), Tj @ exp(dj)
    return log(Zinv @ inv(Ti) @ Tj)


def _graph(chain, loop_edges):
    """The edges' ends and inverse measurements of the chain of starting
    poses (float64) and the loop edges."""
    T = torch.as_tensor(chain).to(F64)
    dev = T.device
    ii = torch.arange(T.shape[0] - 1, device=dev)
    jj = ii + 1
    Zs = [inv(T[:-1]) @ T[1:]]
    if loop_edges:
        ii = torch.cat([ii, torch.tensor([i for i, _, _ in loop_edges], device=dev)])
        jj = torch.cat([jj, torch.tensor([j for _, j, _ in loop_edges], device=dev)])
        Zs.append(torch.stack([torch.as_tensor(Z).to(F64) for _, _, Z in loop_edges]).to(dev))
    return ii, jj, inv(torch.cat(Zs))


def cost(poses, chain, loop_edges) -> float:
    """The graph's cost at (F, 4, 4) `poses`: the chain of starting poses
    `chain` gives the odometry edges."""
    ii, jj, Zinv = _graph(chain, loop_edges)
    return float((residuals(torch.as_tensor(poses).to(F64).to(ii.device), ii, jj, Zinv) ** 2).sum())


def optimize(poses, loop_edges, iters: int, damping: float = 1e-6) -> torch.Tensor:
    """(F, 4, 4) starting poses and [(i, j, (4, 4) Z)] loop edges -> the
    (F, 4, 4) float64 poses after `iters` Gauss-Newton iterations."""
    T = torch.as_tensor(poses).to(F64)
    F_, dev = T.shape[0], T.device
    ii, jj, Zinv = _graph(T, loop_edges)
    E, n = ii.shape[0], 6 * (F_ - 1)  # unknowns: the twists of vertices 1 .. F-1
    eye6 = torch.eye(6, dtype=F64, device=dev)
    zero = torch.zeros((E, 6), dtype=F64, device=dev)
    rows = torch.arange(6 * E, device=dev).reshape(E, 6)
    for _ in range(iters):
        r = residuals(T, ii, jj, Zinv)
        J = torch.zeros((6 * E, n), dtype=F64, device=dev)
        for end, idx in ((0, ii), (1, jj)):
            free = idx > 0
            cols = 6 * (idx - 1)
            for k in range(6):
                d = eye6[k] * STEP
                plus = (zero + d, zero) if end == 0 else (zero, zero + d)
                minus = (zero - d, zero) if end == 0 else (zero, zero - d)
                col = (residuals(T, ii, jj, Zinv, *plus)
                       - residuals(T, ii, jj, Zinv, *minus)) / (2 * STEP)
                J[rows[free], (cols[free] + k)[:, None].expand(-1, 6)] += col[free]
        H = J.T @ J + damping * torch.eye(n, dtype=F64, device=dev)
        x = torch.linalg.solve(H, -(J.T @ r.reshape(-1)))
        d = torch.cat([torch.zeros(6, dtype=F64, device=dev), x]).reshape(F_, 6)
        T = T @ exp(d)
    return T
