"""Trajectory metrics: ATE / RPE (the numbers the reference never computed).

The reference only plots GT overlays (``reference/visualizer/
plotter.py:70-81``, ``dump.cpp:447-454``); SURVEY.md §6 requires us to
self-measure ATE RMSE.  Conventions follow the standard KITTI/TUM tooling:
ATE after SE(3) (or Sim(3)) alignment via Umeyama/Kabsch.
"""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform gt ~ s R est + t (Umeyama).

    est, gt: (N, 3) matched position sequences.  Returns (s, R, t).
    """
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    ec = est - mu_e
    gc = gt - mu_g
    cov = gc.T @ ec / est.shape[0]
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    if with_scale:
        var_e = (ec**2).sum() / est.shape[0]
        s = float(np.trace(np.diag(D) @ S) / var_e)
    else:
        s = 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE over (F, 4, 4) pose arrays."""
    est = est_poses[:, :3, 3]
    gt = gt_poses[: est.shape[0], :3, 3]
    if align:
        s, R, t = align_umeyama(est, gt)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt(np.mean(err**2)))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error per `delta` frames.

    Returns (trans_rmse [m], rot_rmse [deg]).
    """
    n = min(est_poses.shape[0], gt_poses.shape[0]) - delta
    terrs, rerrs = [], []
    for i in range(n):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        e = np.linalg.inv(dg) @ de
        terrs.append(np.linalg.norm(e[:3, 3]))
        c = np.clip((np.trace(e[:3, :3]) - 1.0) * 0.5, -1.0, 1.0)
        rerrs.append(np.degrees(np.arccos(c)))
    return (
        float(np.sqrt(np.mean(np.square(terrs)))),
        float(np.sqrt(np.mean(np.square(rerrs)))),
    )
