"""Absolute trajectory error after a rigid Umeyama alignment (a frozen
copy of the port's ``utils/metrics.py::align_umeyama`` / ``ate_rmse``)."""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform gt ~ s R est + t over (N, 3)
    matched positions.  Returns (s, R, t)."""
    mu_e, mu_g = est.mean(axis=0), gt.mean(axis=0)
    ec, gc = est - mu_e, gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    s = float(np.trace(np.diag(D) @ S) / ((ec**2).sum() / est.shape[0])) if with_scale else 1.0
    return s, R, mu_g - s * R @ mu_e


def position_errors(est_poses: np.ndarray, gt_poses: np.ndarray) -> np.ndarray:
    """(F,) distances of the aligned estimated positions from the truth."""
    est = np.asarray(est_poses, np.float64)[:, :3, 3]
    gt = np.asarray(gt_poses, np.float64)[: est.shape[0], :3, 3]
    s, R, t = align_umeyama(est, gt)
    return np.linalg.norm((s * (R @ est.T)).T + t - gt, axis=1)


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray) -> float:
    """RMS of :func:`position_errors`."""
    err = position_errors(est_poses, gt_poses)
    return float(np.sqrt(np.mean(err**2)))
