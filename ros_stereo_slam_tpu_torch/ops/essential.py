"""Essential-matrix RANSAC and monocular pose recovery.

Port of ``ros_stereo_slam_tpu/ops/essential.py``, the monocular utilities
of the reference's dense-disparity node (``monocularTriangulate``,
``reference/src/StereoCV.cpp:123-189``: ``cv::findEssentialMat`` +
``cv::recoverPose`` + triangulation):

- K minimal sets of 8 by Gumbel top-k, a batched 8-point solve in
  camera-normalized coordinates, each hypothesis projected onto the
  essential manifold (singular values (1, 1, 0)) through the analytic
  3x3 eigendecomposition, Sampson scoring of every point against every
  hypothesis, MSAC selection and three rounds of IRLS polish;
- pose disambiguation by the four-candidate cheirality vote (``argmax``
  takes the first maximum, as ``jnp.argmax`` does), with closed-form
  two-ray midpoint triangulation.

Sampling is split from solving, as for the F-matrix and PnP:
:func:`essential_ransac` draws the index sets from a ``torch.Generator``
and hands them to :func:`_essential_from_sets`, so a test can feed the
solver index sets drawn by the JAX reference.  Everything is float32, as
in the reference; the analytic eigendecomposition rounds differently
from XLA's, so E and the pose agree with the reference to a tolerance
(the tests state theirs), not bitwise.  As in the reference's monocular
path, ``t`` is recovered up to scale (unit norm).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.ops.ransac import (_epipolar_design, _sample_minimal_sets,
                                                  sampson_distance)
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

_REFIT_ROUNDS = 3


class EssentialResult(NamedTuple):
    E: torch.Tensor  # (3, 3) best essential matrix
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor  # () int


class RecoveredPose(NamedTuple):
    R: torch.Tensor  # (3, 3) cam2-from-cam1 rotation
    t: torch.Tensor  # (3,) unit-norm cam2-from-cam1 translation
    points: torch.Tensor  # (N, 3) triangulated points in cam1's frame
    in_front: torch.Tensor  # (N,) bool: positive depth in BOTH cameras
    n_good: torch.Tensor  # () int: the winner's cheirality vote


def normalized_coords(cam: Pinhole, pts: torch.Tensor) -> torch.Tensor:
    """Pixel (N, 2) -> camera-normalized (N, 2): K^-1 [u, v, 1]."""
    return torch.stack([(pts[..., 0] - cam.cx) / cam.fx, (pts[..., 1] - cam.cy) / cam.fy],
                       dim=-1)


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def _ortho3(M: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Right-handed SVD factors (U, V) of a (batch of) 3x3 M with singular
    values ~ (s, s, 0): det(U) = det(V) = +1 and the null direction in the
    last column, from the analytic eigh of M^T M (ascending columns)."""
    evals, Vasc = linalg.eigh3x3(M.transpose(-1, -2) @ M)
    v1, v2 = Vasc[..., :, 2], Vasc[..., :, 1]  # descending singular value
    v3 = torch.linalg.cross(v1, v2)  # right-handed; null direction of M
    s1 = torch.sqrt(torch.clamp(evals[..., 2], min=1e-20))[..., None]
    s2 = torch.sqrt(torch.clamp(evals[..., 1], min=1e-20))[..., None]
    u1 = torch.einsum("...ij,...j->...i", M, v1) / s1
    u2 = torch.einsum("...ij,...j->...i", M, v2) / s2
    # Re-orthonormalize u2 against u1 (float32, near-degenerate hypotheses).
    u1 = _unit(u1)
    u2 = _unit(u2 - (u1 * u2).sum(-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2)
    return torch.stack([u1, u2, u3], dim=-1), torch.stack([v1, v2, v3], dim=-1)


def _essential_factors(E: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(U, V) SVD factors of an essential E (singular values (s, s, 0)).

    The repeated pair leaves the in-plane rotation of the first two
    singular vectors free, and the E -> (R, t) decomposition does not
    depend on it, so any right-handed completion of the null direction
    serves: v3 = unit null vector of E (a column of (E^T E - s I)^2 with
    s = trace / 2), v1 = v3 x the world axis least aligned with v3, v2 =
    v3 x v1; u_i = E v_i normalized (i = 1, 2), u3 = u1 x u2.
    """
    EtE = E.transpose(-1, -2) @ E
    s = 0.5 * EtE.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    P = EtE - s * torch.eye(3, dtype=E.dtype, device=E.device)
    P = P @ P
    bestc = torch.argmax((P * P).sum(-2), dim=-1)
    v3 = _unit(torch.gather(P, -1, bestc[..., None, None].expand(P.shape[:-1] + (1,)))[..., 0])
    eye = torch.eye(3, dtype=E.dtype, device=E.device)
    v1 = _unit(torch.linalg.cross(v3, eye[torch.argmin(torch.abs(v3), dim=-1)]))
    v2 = torch.linalg.cross(v3, v1)
    u1 = _unit(torch.einsum("...ij,...j->...i", E, v1))
    u2 = torch.einsum("...ij,...j->...i", E, v2)
    u2 = _unit(u2 - (u1 * u2).sum(-1, keepdim=True) * u1)
    u3 = torch.linalg.cross(u1, u2)
    return torch.stack([u1, u2, u3], dim=-1), torch.stack([v1, v2, v3], dim=-1)


def _canonical(like: torch.Tensor) -> torch.Tensor:
    return torch.diag(torch.tensor([1.0, 1.0, 0.0], dtype=like.dtype, device=like.device))


def project_essential(M: torch.Tensor) -> torch.Tensor:
    """Nearest essential matrix of (a batch of) 3x3 M: U diag(1, 1, 0) V^T."""
    U, V = _ortho3(M)
    return U @ _canonical(M) @ V.transpose(-1, -2)


def _eight_point_essential(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """(..., 8, 2) + (..., 8, 2) normalized points -> (..., 3, 3) E."""
    A = _epipolar_design(p1, p2)
    return project_essential(linalg.null_vector(A).reshape(A.shape[:-2] + (3, 3)))


def _threshold(cam: Pinhole, thresh_px: float) -> float:
    """The squared Sampson threshold in normalized coordinates: the pixel
    threshold converted with the mean focal length (first order, as OpenCV
    does), in float32 as the reference computes it."""
    f = np.float32(0.5) * (np.float32(cam.fx) + np.float32(cam.fy))
    return float((np.float32(thresh_px) / f) ** 2)


def _hypotheses(idx: torch.Tensor, cam: Pinhole, pts1: torch.Tensor, pts2: torch.Tensor,
                mask: torch.Tensor, thresh_px: float = 1.0):
    """The solve's first half on given (K, 8) minimal sets: the hypotheses
    E (K, 3, 3), their Sampson errors (K, N) and MSAC scores (K,), the
    squared threshold in normalized coordinates, and the (N, 3)
    homogeneous normalized points."""
    n = pts1.shape[0]
    x1, x2 = normalized_coords(cam, pts1), normalized_coords(cam, pts2)
    E = _eight_point_essential(x1[idx], x2[idx])  # (K, 3, 3)
    ones = torch.ones((n, 1), dtype=x1.dtype, device=x1.device)
    x1h, x2h = torch.cat([x1, ones], dim=1), torch.cat([x2, ones], dim=1)
    thr = _threshold(cam, thresh_px)
    err = sampson_distance(E, x1h, x2h)
    return E, err, _msac(err, mask, thr), thr, x1h, x2h


def _msac(err: torch.Tensor, mask: torch.Tensor, thr: float) -> torch.Tensor:
    """MSAC: the sum of truncated errors (lower is better) tells apart
    hypotheses whose inlier counts saturate (near-forward motion)."""
    return torch.where(mask, torch.clamp(err, max=thr), torch.zeros_like(err)).sum(-1)


def _essential_from_sets(idx: torch.Tensor, cam: Pinhole, pts1: torch.Tensor,
                         pts2: torch.Tensor, mask: torch.Tensor,
                         thresh_px: float = 1.0) -> EssentialResult:
    """The E-RANSAC solve on given (K, 8) minimal sets."""
    E, err, msac, thr, x1h, x2h = _hypotheses(idx, cam, pts1, pts2, mask, thresh_px)
    best = torch.argmin(torch.where(torch.isfinite(msac), msac, torch.inf))
    E_cur, inl_cur, sc_cur = E[best], (err[best] < thr) & mask, msac[best]

    # IRLS polish: Sampson-weighted refits over the current inlier set; a
    # refit is kept only if it is finite and does not raise the MSAC score.
    A_full = _epipolar_design(normalized_coords(cam, pts1), normalized_coords(cam, pts2))
    for _ in range(_REFIT_ROUNDS):
        e = sampson_distance(E_cur, x1h, x2h)
        w = inl_cur.to(x1h.dtype) / (1.0 + e / max(thr, 1e-12))
        E_new = project_essential(linalg.null_vector(A_full * w[:, None]).reshape(3, 3))
        err_n = sampson_distance(E_new, x1h, x2h)
        sc_n = _msac(err_n, mask, thr)
        ok = torch.isfinite(E_new).all() & (sc_n <= sc_cur)
        E_cur = torch.where(ok, E_new, E_cur)
        inl_cur = torch.where(ok, (err_n < thr) & mask, inl_cur)
        sc_cur = torch.where(ok, sc_n, sc_cur)
    # Degenerate inputs (an empty mask) can leave a non-finite E: return the
    # canonical essential matrix with no inliers instead.
    finite = torch.isfinite(E_cur).all()
    inliers = inl_cur & finite
    return EssentialResult(E=torch.where(finite, E_cur, _canonical(E_cur)), inliers=inliers,
                           n_inliers=inliers.sum())


def essential_ransac(gen: torch.Generator, cam: Pinhole, pts1: torch.Tensor,
                     pts2: torch.Tensor, mask: torch.Tensor, thresh_px: float = 1.0,
                     iters: int = 256) -> EssentialResult:
    """Fixed-budget parallel RANSAC for E on (N, 2) pixel correspondences."""
    idx = _sample_minimal_sets(gen, mask, iters, 8)
    return _essential_from_sets(idx, cam, pts1, pts2, mask, thresh_px)


def midpoint_triangulate(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                         x2: torch.Tensor):
    """Two-ray midpoint triangulation in cam1 coordinates.

    R (..., 3, 3), t (..., 3): cam2-from-cam1 (p2 = R p1 + t), a batch of
    candidates; x1, x2 (N, 2) normalized.  Returns (points (..., N, 3),
    z1 (..., N), z2 (..., N)) from the closed-form 2x2 normal equations of
    min_{a,b} || a f1 - (c2 + b f2) ||^2.
    """
    ones = torch.ones(x1.shape[:-1] + (1,), dtype=x1.dtype, device=x1.device)
    f1 = torch.cat([x1, ones], dim=-1)  # rays from cam1's origin
    c2 = -torch.einsum("...ji,...j->...i", R, t)[..., None, :]  # cam2's centre in cam1
    f2 = torch.einsum("...ji,nj->...ni", R, torch.cat([x2, ones], dim=-1))
    a11 = (f1 * f1).sum(-1)
    a22 = (f2 * f2).sum(-1)
    a12 = -(f1 * f2).sum(-1)
    b1 = (f1 * c2).sum(-1)
    b2 = -(f2 * c2).sum(-1)
    det = a11 * a22 - a12 * a12
    det = torch.where(torch.abs(det) > 1e-12, det, torch.full_like(det, 1e-12))
    a = (b1 * a22 - b2 * a12) / det
    b = (a11 * b2 - a12 * b1) / det
    p = 0.5 * (a[..., None] * f1 + c2 + b[..., None] * f2)
    z2 = torch.einsum("...ij,...nj->...ni", R, p)[..., 2] + t[..., 2:3]
    return p, p[..., 2], z2


def recover_pose(E: torch.Tensor, cam: Pinhole, pts1: torch.Tensor, pts2: torch.Tensor,
                 mask: torch.Tensor) -> RecoveredPose:
    """``cv::recoverPose``: the four (R, t) decompositions of E triangulate
    every point at once; the candidate with the most points in front of
    both cameras wins."""
    E = torch.where(torch.isfinite(E).all(), E, _canonical(E))
    U, V = _essential_factors(E)
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=E.dtype,
                      device=E.device)
    Ra = U @ Wm @ V.transpose(-1, -2)
    Rb = U @ Wm.T @ V.transpose(-1, -2)
    # det(U) = det(V) = +1 by construction, so det(Ra) = det(Rb) = +1.
    tu = _unit(U[:, 2])
    Rs = torch.stack([Ra, Ra, Rb, Rb])  # (4, 3, 3)
    ts = torch.stack([tu, -tu, tu, -tu])  # (4, 3)
    pts, z1, z2 = midpoint_triangulate(Rs, ts, normalized_coords(cam, pts1),
                                       normalized_coords(cam, pts2))
    front = (z1 > 1e-6) & (z2 > 1e-6) & mask
    votes = front.sum(-1)  # (4,)
    k = torch.argmax(votes)
    return RecoveredPose(R=Rs[k], t=ts[k], points=pts[k], in_front=front[k], n_good=votes[k])


def monocular_triangulate(gen: torch.Generator, cam: Pinhole, pts1: torch.Tensor,
                          pts2: torch.Tensor, mask: torch.Tensor, thresh_px: float = 1.0,
                          iters: int = 256) -> tuple[EssentialResult, RecoveredPose]:
    """The node's monocular flow: E-RANSAC -> recoverPose -> midpoint
    points, for two views of the same camera (up-to-scale pose)."""
    er = essential_ransac(gen, cam, pts1, pts2, mask, thresh_px, iters)
    return er, recover_pose(er.E, cam, pts1, pts2, er.inliers)
