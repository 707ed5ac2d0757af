"""Small batched linear-algebra primitives.

Port of ``ros_stereo_slam_tpu/ops/linalg.py``.  The JAX module unrolls
every scalar of its Cholesky to dodge a serial TPU custom call; here each
Cholesky column is one vectorized step (n steps instead of n^2 scalar
ops), which keeps the launch count of the batched RANSAC solves small on
the GPU while computing the same factorization (same 1e-30 pivot clamp).
Triangular solves are exact substitutions either way.
"""

from __future__ import annotations

import torch


def cholesky_small(B: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of (..., n, n) SPD matrices, one column per step.

    Non-positive pivots are clamped to 1e-30 (as the reference does), so a
    semi-definite input yields a finite factor instead of NaNs.
    """
    n = B.shape[-1]
    L = torch.zeros_like(B)
    for j in range(n):
        Lj = L[..., j, :j]  # (..., j)
        d = B[..., j, j] - (Lj * Lj).sum(-1)
        dj = torch.sqrt(torch.clamp(d, min=1e-30))
        L[..., j, j] = dj
        if j + 1 < n:
            s = B[..., j + 1:, j] - (L[..., j + 1:, :j] @ Lj[..., :, None])[..., 0]
            L[..., j + 1:, j] = s / dj[..., None]
    return L


def chol_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) x = b; L (..., n, n) lower-triangular, b (..., n)."""
    y = torch.linalg.solve_triangular(L, b[..., :, None], upper=False)
    x = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    return x[..., 0]


def spd_solve(B: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD solve via :func:`cholesky_small`."""
    return chol_solve_small(cholesky_small(B), b)


def spd_inverse_small(B: torch.Tensor) -> torch.Tensor:
    """Inverse of (..., n, n) SPD matrices: L^-T L^-1 from :func:`cholesky_small`."""
    L = cholesky_small(B)
    eye = torch.eye(B.shape[-1], dtype=B.dtype, device=B.device).expand(B.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return Linv.transpose(-1, -2) @ Linv


def null_vector(A: torch.Tensor, iters: int = 4) -> torch.Tensor:
    """Smallest right singular vector of each (..., m, n) matrix (m >= n-1).

    Inverse iteration on A^T A with a tiny relative shift; unit-norm
    output.
    """
    AtA = A.transpose(-1, -2) @ A
    n = A.shape[-1]
    tr = torch.diagonal(AtA, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    B = AtA + (1e-7 / n) * tr * torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_small(B)
    x = torch.ones(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    for _ in range(iters):
        x = chol_solve_small(L, x)
        norm = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        # A pivot clamped to 1e-30 (the shift lost to f32 rounding on an
        # exactly rank-deficient system) scales x by ~1e30 and its squared
        # norm overflows; rescale by the largest entry first there.
        big = x / torch.clamp(x.abs().amax(-1, keepdim=True), min=1e-30)
        x = torch.where(torch.isfinite(norm), x / torch.clamp(norm, min=1e-30),
                        big / torch.clamp(torch.linalg.vector_norm(big, dim=-1, keepdim=True),
                                          min=1e-30))
    return x


def det3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form determinant of (..., 3, 3)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def inv3x3(M: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    """Adjugate inverse of (..., 3, 3), the determinant guarded as in the
    reference: ``|det| <= eps`` divides by `eps`.

    Row i of the cofactor matrix is the cross product of the two rows after
    row i, so the adjugate is three cross products (one launch) instead of
    the reference's 18 unrolled scalar expressions.
    """
    rows1 = torch.cat([M[..., 1:, :], M[..., :1, :]], dim=-2)  # rows 1, 2, 0
    rows2 = torch.cat([M[..., 2:, :], M[..., :2, :]], dim=-2)  # rows 2, 0, 1
    cof = torch.linalg.cross(rows1, rows2, dim=-1)
    det = torch.linalg.vecdot(M[..., 0, :], cof[..., 0, :])
    det.masked_fill_(det.abs() <= eps, eps)
    return cof.transpose(-1, -2) / det[..., None, None]


def eigh3x3(S: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic eigendecomposition of batched symmetric (..., 3, 3).

    Returns (eigvals ascending (..., 3), eigvecs (..., 3, 3) with
    ``eigvecs[..., :, i]`` the i-th eigenvector): trigonometric
    eigenvalues and the (S - l_j I)(S - l_k I) column-product
    eigenvectors (Eberly's method); the max-norm column pick keeps
    near-degenerate cases finite.
    """
    eye = torch.eye(3, dtype=S.dtype, device=S.device)
    q = torch.diagonal(S, dim1=-2, dim2=-1).sum(-1) / 3.0
    A = S - q[..., None, None] * eye
    p2 = (A * A).sum((-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detA = det3x3(A)
    r = torch.clamp(detA / (2.0 * p * p * p + 1e-38), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)  # smallest
    l2 = q + 2.0 * p * torch.cos(phi)  # largest
    l1 = 3.0 * q - l0 - l2
    lam = torch.stack([l0, l1, l2], dim=-1)

    def vec_for(lj, lk):
        # Columns of (S - lj I)(S - lk I) span the remaining eigenspace.
        P = (S - lj[..., None, None] * eye) @ (S - lk[..., None, None] * eye)
        norms = (P * P).sum(-2)
        best = torch.argmax(norms, dim=-1)
        v = torch.gather(P, -1, best[..., None, None].expand(P.shape[:-1] + (1,)))
        v = v[..., 0]
        return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               min=1e-30)

    v0 = vec_for(l1, l2)
    v2 = vec_for(l0, l1)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    return lam, torch.stack([v0, v1, v2], dim=-1)
