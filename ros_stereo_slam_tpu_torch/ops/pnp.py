"""Batched PnP-RANSAC localization with SE(3) Gauss-Newton polish.

Port of ``ros_stereo_slam_tpu/ops/pnp.py``: K minimal 6-point DLT
hypotheses solved as one batch, an optional family of prior-seeded GN
hypotheses on random 8-point subsets, all-hypotheses-vs-all-points
reprojection scoring, the folded 1 px -> 8 px retry ladder, and two
Huber-IRLS Gauss-Newton polish rounds.

Sampling is split from solving: :func:`pnp_ransac` draws the index sets
from a ``torch.Generator`` and hands them to :func:`_pnp_from_sets`, so a
test can feed the solver index sets drawn by the JAX reference.

Lanes: :func:`_pnp_from_sets` solves B lanes at once (every input has a
leading lane axis; the retry ladder and ``used_retry`` are per lane), and
:func:`_solve` hands it a single-lane call as B = 1.  In lane form
:func:`pnp_ransac` takes one generator per lane, and each lane draws its
own index sets, as its single-lane call would.

Points sharded over a mesh (config 5, ``parallel/dist_frontend.py``):
:func:`_pnp_from_sets` with a `mesh` splits the scoring and the
Gauss-Newton normal equations by points; see its docstring.

Every solve goes through :func:`_solve` and PnP's graph family
(:data:`..utils.cuda_graph.PNP`): on the card without a mesh it replays a
CUDA graph of :func:`_pnp_from_sets`, captured once per input signature
(the same kernels on the same shapes, one launch for some 2,900); the CPU
and a mesh (collectives inside) solve eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.ops.ransac import _sample_minimal_sets
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, psum, psum_many, shard_bounds
from ros_stereo_slam_tpu_torch.utils import cuda_graph, lie
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


class PnPResult(NamedTuple):  # single-lane shapes; lane form adds a leading B
    T_cw: torch.Tensor  # (4, 4) cam-from-world
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int
    errors: torch.Tensor  # (N,) reprojection error (px) under final pose
    used_retry: torch.Tensor  # () bool — loose-threshold ladder engaged


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the point (or hypothesis) axis, lane by lane: x has a
    leading lane axis and lane b of `idx` indexes lane b of x."""
    flat = idx.reshape((x.shape[0], -1) + (1,) * (x.dim() - 2))
    flat = flat.expand(flat.shape[:2] + x.shape[2:])
    return torch.gather(x, 1, flat).reshape(idx.shape + x.shape[2:])


def _p6p_dlt(X: torch.Tensor, xn: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 6, 3) world points + (..., 6, 2) normalized coords -> R, t.

    Solves x_n ~ [R|t] X_h with the 12-dof projective DLT, then projects
    onto SE(3): orthogonal Procrustes on the rotation block, scale from its
    singular values, cheirality by majority positive depth.
    """
    mean = X.mean(-2)
    scale = torch.sqrt(((X - mean[..., None, :]) ** 2).sum(-1).mean(-1)) / (3.0 ** 0.5)
    scale = torch.clamp(scale, min=1e-6)
    Xn = (X - mean[..., None, :]) / scale[..., None, None]
    ones = torch.ones(X.shape[:-1] + (1,), dtype=X.dtype, device=X.device)
    Xh = torch.cat([Xn, ones], dim=-1)  # (..., 6, 4)
    zeros = torch.zeros_like(Xh)
    rows_u = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
    A = torch.cat([rows_u, rows_v], dim=-2)  # (..., 12, 12)
    Mn = linalg.null_vector(A).reshape(X.shape[:-2] + (3, 4))
    # Denormalize: x ~ Mn @ N @ X_h with N = [[I/s, -mean/s], [0, 1]].
    inv_s = (1.0 / scale)[..., None, None]
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    N = lie.make_se3(eye3 * inv_s, -mean / scale[..., None])
    M = Mn @ N
    # Cheirality: fix the projective sign so most sample depths are positive.
    z = (torch.cat([X, ones], dim=-1) @ M[..., 2, :, None])[..., 0]
    flip = (z > 0).sum(-1) < 3
    M = torch.where(flip[..., None, None], -M, M)
    B = M[..., :, :3]
    # Orthogonal Procrustes from eigh of B^T B (ascending eigenvalues).
    lam, V = linalg.eigh3x3(B.transpose(-1, -2) @ B)
    s_desc = torch.sqrt(torch.clamp(lam.flip(-1), min=1e-24))  # s0 >= s1 >= s2
    v0 = V[..., :, 2]
    v1 = V[..., :, 1]
    Vd = torch.stack([v0, v1, torch.linalg.cross(v0, v1, dim=-1)], dim=-1)

    def unit(v):
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               min=1e-12)

    u0 = unit((B @ v0[..., None])[..., 0] / s_desc[..., 0:1])
    u1 = (B @ v1[..., None])[..., 0] / s_desc[..., 1:2]
    u1 = unit(u1 - (u1 * u0).sum(-1, keepdim=True) * u0)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    U = torch.stack([u0, u1, u2], dim=-1)
    detB = linalg.det3x3(B)
    detuv = torch.sign(detB) + (detB == 0.0).to(X.dtype)
    d = torch.stack([torch.ones_like(detuv), torch.ones_like(detuv), detuv], dim=-1)
    R = (U * d[..., None, :]) @ Vd.transpose(-1, -2)
    scale = 3.0 / torch.clamp(s_desc[..., 0] + s_desc[..., 1] + s_desc[..., 2] * detuv,
                              min=1e-12)
    t = M[..., :, 3] * scale[..., None]
    return R, t


def _reproj_errors(cam: Pinhole, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor,
                   uv: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) R, (..., 3) t vs (N, 3) X, (N, 2) uv -> (..., N) px errors."""
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    pos = z > 1e-3
    zs = torch.where(pos, z, torch.ones_like(z))
    u = cam.fx * pc[..., 0] / zs + cam.cx
    v = cam.fy * pc[..., 1] / zs + cam.cy
    err = torch.sqrt((u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2)
    return torch.where(pos, err, torch.full_like(err, 1e9))


def _gn_refine(
    cam: Pinhole,
    T0: torch.Tensor,
    X: torch.Tensor,
    uv: torch.Tensor,
    weights_mask: torch.Tensor,
    iters: int,
    huber_px: float = 2.0,
    damping: float = 1e-4,
    mesh: Mesh | None = None,
) -> torch.Tensor:
    """Huber-IRLS Gauss-Newton on SE(3), batched over leading dimensions:
    T0 (..., 4, 4), X (..., N, 3), uv (..., N, 2), weights_mask (..., N).

    The steps run in float64 and the result is rounded back to T0's type:
    the card's reductions and batched products sum in an order that
    depends on the batch shape (one lane or several), and RANSAC turns a
    last-bit difference into a different inlier set a few frames later.
    In float64 those differences stay far below float32's rounding, so a
    lane's pose does not depend on how many lanes run beside it.

    With a `mesh`, X, uv and weights_mask are this rank's points: the
    normal equations (H, b) are summed over the ranks in one all-reduce
    a step, and the solve runs replicated.
    """
    out_dtype = T0.dtype
    T0, X, uv, weights_mask = (a.to(torch.float64) for a in (T0, X, uv, weights_mask))
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    T = T0
    for _ in range(iters):
        R, t = T[..., :3, :3], T[..., :3, 3]
        pc = X @ R.transpose(-1, -2) + t[..., None, :]
        z = torch.clamp(pc[..., 2], min=1e-3)
        u = cam.fx * pc[..., 0] / z + cam.cx
        v = cam.fy * pc[..., 1] / z + cam.cy
        r = torch.stack([u - uv[..., 0], v - uv[..., 1]], dim=-1)  # (..., N, 2)
        # 2x3 projection Jacobian wrt the camera-frame point
        inv_z = 1.0 / z
        zero = torch.zeros_like(z)
        Ju = torch.stack([cam.fx * inv_z, zero, -cam.fx * pc[..., 0] * inv_z * inv_z], dim=-1)
        Jv = torch.stack([zero, cam.fy * inv_z, -cam.fy * pc[..., 1] * inv_z * inv_z], dim=-1)
        # dp/dxi for a left-multiplied twist: [I | -hat(p)]  (..., N, 3, 6)
        Jp = torch.cat([eye3.expand(pc.shape[:-1] + (3, 3)), -lie.hat_so3(pc)], dim=-1)
        J = torch.stack([(Ju[..., None, :] @ Jp)[..., 0, :],
                         (Jv[..., None, :] @ Jp)[..., 0, :]], dim=-2)  # (..., N, 2, 6)
        # Huber IRLS weights on the residual norm
        rn = torch.linalg.vector_norm(r, dim=-1)
        wh = torch.where(rn <= huber_px, torch.ones_like(rn),
                         huber_px / torch.clamp(rn, min=1e-9))
        wgt = wh * weights_mask
        Jw = J * wgt[..., None, None]
        # Normal equations as products and sums over (point, row): two
        # launches each, where einsum's batched product also copies its
        # operands into the product's layout.
        H = (Jw[..., :, None] * J[..., None, :]).sum((-4, -3))
        b = (Jw * r[..., None]).sum((-3, -2))
        if mesh is not None:
            H, b = psum_many(mesh, H, b)
        dxi = linalg.spd_solve(H + damping * eye6, -b)
        T = lie.exp_se3(dxi) @ T
    return T.to(out_dtype)


def _pnp_from_sets(
    idx: torch.Tensor,
    idx2: torch.Tensor | None,
    cam: Pinhole,
    pts3d: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    thresh_px: float = 1.0,
    refine_iters: int = 8,
    T_init: torch.Tensor | None = None,
    retry_thresh_px: float | None = None,
    min_inliers: int = 0,
    huber_px: float = 0.5,
    mesh: Mesh | None = None,
) -> PnPResult:
    """The PnP solve of B lanes on given minimal sets: `idx` (B, K, 6) for
    the DLT family, `idx2` (B, K2, 8) for the prior-seeded GN family (used
    iff `T_init` is given), pts3d (B, N, 3), uv (B, N, 2), mask (B, N),
    T_init (B, 4, 4).

    With a `mesh` every rank passes the whole point set; the hypotheses
    are fitted replicated, each rank scores and refines on its block of
    points (``shard_bounds``), the counts are summed over the ranks, and
    `inliers` and `errors` are this rank's block.
    """
    cols = slice(None) if mesh is None else shard_bounds(mask.shape[-1], mesh, "points")
    # this rank's points (all of them without a mesh)
    X, x2, m = pts3d[..., cols, :], uv[..., cols, :], mask[..., cols]
    # the GN steps' float64 points, converted once for the three GN calls
    X64, uv64 = pts3d.to(torch.float64), uv.to(torch.float64)
    xn = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    Rk, tk = _p6p_dlt(_rows(pts3d, idx), _rows(xn, idx))  # (B, K, 3, 3), (B, K, 3)
    if T_init is not None:
        T_gn = _gn_refine(
            cam, T_init.unsqueeze(-3).expand(idx2.shape[:-1] + (4, 4)),
            _rows(X64, idx2), _rows(uv64, idx2),
            torch.ones(idx2.shape, dtype=torch.float64, device=pts3d.device), 5,
        )
        Rk = torch.cat([Rk, T_gn[..., :3, :3]], dim=-3)
        tk = torch.cat([tk, T_gn[..., :3, 3]], dim=-2)

    # (B, K, N) errors of every hypothesis at every point
    err = _reproj_errors(cam, Rk, tk, X[:, None], x2[:, None])
    inl = (err < thresh_px) & m[..., None, :]
    counts = inl.sum(-1)
    if mesh is not None:
        counts = psum(counts, mesh)
    best = torch.argmax(counts, dim=-1)
    # Retry ladder folded into one pass: if the tight threshold starves,
    # pick (and gate) by the loose one over the SAME hypothesis set.
    use_thresh = thresh_px
    starved = torch.zeros(best.shape, dtype=torch.bool, device=pts3d.device)
    if retry_thresh_px is not None:
        inl_r = (err < retry_thresh_px) & m[..., None, :]
        counts_r = inl_r.sum(-1)
        if mesh is not None:
            counts_r = psum(counts_r, mesh)
        best_r = torch.argmax(counts_r, dim=-1)
        starved = _rows(counts, best) < min_inliers
        best = torch.where(starved, best_r, best)
        use_thresh = torch.where(starved, float(retry_thresh_px),
                                 float(thresh_px)).unsqueeze(-1)
        inl = torch.where(starved[..., None, None], inl_r, inl)
    T = lie.make_se3(_rows(Rk, best), _rows(tk, best))

    # GN polish on the best hypothesis' inliers (Huber tighter than the
    # gate), re-score, one more round on the expanded set, final score.
    X64, uv64 = X64[..., cols, :], uv64[..., cols, :]
    T = _gn_refine(cam, T, X64, uv64, _rows(inl, best).to(torch.float64), refine_iters,
                   huber_px=huber_px, mesh=mesh)
    final_err = _reproj_errors(cam, T[..., :3, :3], T[..., :3, 3], X, x2)
    final_inl = (final_err < use_thresh) & m
    T = _gn_refine(cam, T, X64, uv64, final_inl.to(torch.float64), refine_iters,
                   huber_px=huber_px, mesh=mesh)
    final_err = _reproj_errors(cam, T[..., :3, :3], T[..., :3, 3], X, x2)
    final_inl = (final_err < use_thresh) & m
    n_inliers = final_inl.sum(-1)
    return PnPResult(
        T_cw=T,
        inliers=final_inl,
        n_inliers=n_inliers if mesh is None else psum(n_inliers, mesh),
        errors=final_err,
        used_retry=starved,
    )


def _solve(
    idx: torch.Tensor,
    idx2: torch.Tensor | None,
    cam: Pinhole,
    pts3d: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    T_init: torch.Tensor | None = None,
    mesh: Mesh | None = None,
    **kw,
) -> PnPResult:
    """:func:`_pnp_from_sets` (its scalars as keywords) through PnP's graph
    family: replayed on the card without a mesh, else eager.  A single-lane
    call (mask (N,)) solves as one lane and returns that lane."""
    one = mask.dim() == 1
    if one:
        idx, idx2, pts3d, uv, mask, T_init = (
            None if t is None else t[None] for t in (idx, idx2, pts3d, uv, mask, T_init))
    res = cuda_graph.PNP(_pnp_from_sets, mesh=mesh, idx=idx, idx2=idx2, cam=cam, pts3d=pts3d,
                         uv=uv, mask=mask, T_init=T_init, **kw)
    return PnPResult(*(t[0] for t in res)) if one else res


def pnp_ransac(
    gen: torch.Generator | list,
    cam: Pinhole,
    pts3d: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    thresh_px: float = 1.0,
    iters: int = 256,
    refine_iters: int = 8,
    T_init: torch.Tensor | None = None,
    retry_thresh_px: float | None = None,
    min_inliers: int = 0,
    huber_px: float = 0.5,
) -> PnPResult:
    """RANSAC + GN PnP on (N, 3) world points vs (N, 2) observations.

    `T_init` (optional 4x4 prior, e.g. the previous frame's pose) adds the
    prior-seeded GN hypothesis family, which stays alive on planar scenes
    where the P6P DLT degenerates.  Lane form: `gen` is a list of B
    generators and every tensor has a leading lane axis; lane b draws from
    gen[b] exactly what its single-lane call would.
    """
    def draw(g, m):
        idx = _sample_minimal_sets(g, m, iters, 6)
        idx2 = (_sample_minimal_sets(g, m, max(iters // 4, 16), 8)
                if T_init is not None else None)
        return idx, idx2

    if mask.dim() == 2:
        sets = [draw(g, m) for g, m in zip(gen, mask, strict=True)]
        idx = torch.stack([a for a, _ in sets])
        idx2 = torch.stack([b for _, b in sets]) if T_init is not None else None
    else:
        idx, idx2 = draw(gen, mask)
    return _solve(
        idx, idx2, cam, pts3d, uv, mask, thresh_px=thresh_px,
        refine_iters=refine_iters, T_init=T_init,
        retry_thresh_px=retry_thresh_px, min_inliers=min_inliers,
        huber_px=huber_px,
    )
