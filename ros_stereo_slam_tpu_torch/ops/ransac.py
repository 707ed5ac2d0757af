"""Minimal-set sampling and the batched 8-point fundamental-matrix RANSAC.

Port of ``ros_stereo_slam_tpu/ops/ransac.py``: K minimal sets of 8 by
Gumbel top-k over the validity mask, a normalized 8-point solve per
hypothesis (null vector by inverse iteration, rank 2 by the analytic
3x3 eigh), Sampson scoring of all points against all hypotheses, and a
least-squares refit on the best inlier set.

Sampling is split from solving, as for PnP: :func:`fmat_ransac` draws
the index sets from a ``torch.Generator`` and hands them to
:func:`_fmat_from_sets`, so a test can feed the solver index sets drawn
by the JAX reference (whose random streams torch cannot reproduce).

Points sharded over a mesh (config 5, ``parallel/dist_frontend.py``):
:func:`_fmat_from_sets` with a `mesh` splits only the (K, N) Sampson
scoring by points; see its docstring.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, all_gather, psum, shard_bounds


class FRansacResult(NamedTuple):
    F: torch.Tensor  # (3, 3) best fundamental matrix
    inliers: torch.Tensor  # (N,) bool (subset of the validity mask)
    n_inliers: torch.Tensor  # () int
    errors: torch.Tensor  # (N,) Sampson distance under the best F


def _sample_minimal_sets(gen: torch.Generator, mask: torch.Tensor, k_hyp: int,
                         m: int) -> torch.Tensor:
    """(k_hyp, m) indices of valid points, sampled w/o replacement per row."""
    n = mask.shape[0]
    u = torch.rand((k_hyp, n), generator=gen, device=mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    scores = torch.where(mask[None, :], g, torch.full_like(g, -torch.inf))
    return torch.topk(scores, m, dim=1).indices


def _normalization_stats(pts: torch.Tensor, mask: torch.Tensor):
    """Hartley normalization (mean (2,), scale ()) of a masked point set."""
    wsum = torch.clamp(mask.sum().to(pts.dtype), min=1.0)
    mean = torch.where(mask[:, None], pts, 0.0).sum(0) / wsum
    d = torch.sqrt(((pts - mean) ** 2).sum(1))
    mean_d = torch.where(mask, d, 0.0).sum() / wsum
    s = (2.0 ** 0.5) / torch.clamp(mean_d, min=1e-6)
    return mean, s


def _build_T(mean: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    zero = torch.zeros_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * mean[0]]),
        torch.stack([zero, s, -s * mean[1]]),
        torch.stack([zero, zero, torch.ones_like(s)]),
    ])


def _epipolar_design(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., N, 2) x (..., N, 2) -> (..., N, 9) rows of the epipolar system."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """Nearest rank-2 matrix: F (I - v3 v3^T), v3 the smallest right
    singular vector (analytic 3x3 eigh of F^T F)."""
    _, V = linalg.eigh3x3(F.transpose(-1, -2) @ F)
    v3 = V[..., :, 0]
    return F - (F @ v3[..., :, None]) * v3[..., None, :]


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """8-point solve, batched: (..., 8, 2) + (..., 8, 2) -> (..., 3, 3) F
    (pre-normalized coordinates)."""
    A = _epipolar_design(p1, p2)
    return _rank2(linalg.null_vector(A).reshape(A.shape[:-2] + (3, 3)))


def _weighted_refit(p1: torch.Tensor, p2: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Least-squares F refit over all points with weights w (N,)."""
    A = _epipolar_design(p1, p2) * w[:, None]
    return _rank2(linalg.null_vector(A).reshape(3, 3))


def sampson_distance(F: torch.Tensor, p1h: torch.Tensor, p2h: torch.Tensor) -> torch.Tensor:
    """Sampson distance of (N, 3) homogeneous pairs under (..., 3, 3) F: (..., N)."""
    Fx1 = torch.einsum("...ij,nj->...ni", F, p1h)
    Ftx2 = torch.einsum("...ji,nj->...ni", F, p2h)
    x2Fx1 = torch.einsum("ni,...ni->...n", p2h, Fx1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return x2Fx1**2 / torch.clamp(denom, min=1e-12)


def _fmat_from_sets(idx: torch.Tensor, pts1: torch.Tensor, pts2: torch.Tensor,
                    mask: torch.Tensor, thresh_px: float = 1.0,
                    mesh: Mesh | None = None) -> FRansacResult:
    """The F-matrix solve on given (K, 8) minimal sets.

    With a `mesh` every rank passes the whole point set and scores only
    its block of columns (``shard_bounds``); the per-hypothesis counts are
    summed over the ranks and the best hypothesis' errors gathered, so the
    normalisation, the fits, the refit and its guard run replicated on
    whole rows and every rank returns the single call's result.
    """
    n = pts1.shape[0]
    cols = slice(None) if mesh is None else shard_bounds(n, mesh, "points")
    T1 = _build_T(*_normalization_stats(pts1, mask))
    T2 = _build_T(*_normalization_stats(pts2, mask))
    p1n = pts1 * T1[0, 0] + T1[:2, 2][None, :]
    p2n = pts2 * T2[0, 0] + T2[:2, 2][None, :]
    Fn = _eight_point(p1n[idx], p2n[idx])  # (K, 3, 3) normalized coordinates
    F = torch.einsum("ji,kjl,lm->kim", T2, Fn, T1)  # denormalize: T2^T Fn T1

    ones = torch.ones((n, 1), dtype=pts1.dtype, device=pts1.device)
    p1h = torch.cat([pts1, ones], dim=1)
    p2h = torch.cat([pts2, ones], dim=1)
    thr2 = thresh_px**2
    err = sampson_distance(F, p1h[cols], p2h[cols])  # (K, N), a mesh: (K, N / D)
    inl = (err < thr2) & mask[None, cols]
    counts = inl.sum(1)
    if mesh is not None:
        counts = psum(counts, mesh)
    best = torch.argmax(counts)
    err_best, inl_best = err[best], inl[best]
    if mesh is not None:
        err_best = all_gather(err_best, mesh)
        inl_best = (err_best < thr2) & mask

    # Least-squares refit on the best inlier set, kept only if it loses no
    # inliers (the reference's degenerate guard).
    Fn_refit = _weighted_refit(p1n, p2n, inl_best.to(pts1.dtype))
    F_refit = T2.T @ Fn_refit @ T1
    err_refit = sampson_distance(F_refit, p1h, p2h)
    inl_refit = (err_refit < thr2) & mask
    better = inl_refit.sum() >= counts[best]
    best_inl = torch.where(better, inl_refit, inl_best)
    return FRansacResult(
        F=torch.where(better, F_refit, F[best]),
        inliers=best_inl,
        n_inliers=best_inl.sum(),
        errors=torch.where(better, err_refit, err_best),
    )


def fmat_ransac(gen: torch.Generator, pts1: torch.Tensor, pts2: torch.Tensor,
                mask: torch.Tensor, thresh_px: float = 1.0,
                iters: int = 256) -> FRansacResult:
    """RANSAC F-matrix on (N, 2) correspondences with validity `mask`."""
    idx = _sample_minimal_sets(gen, mask, iters, 8)
    return _fmat_from_sets(idx, pts1, pts2, mask, thresh_px)
