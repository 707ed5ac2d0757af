"""LK parameter profiles of the frontend.

Port of ``_lk_params`` and ``_lk_stereo_params`` from
``ros_stereo_slam_tpu/models/frontend.py``.
"""

from __future__ import annotations

from ros_stereo_slam_tpu_torch.config import FrontendConfig
from ros_stereo_slam_tpu_torch.ops import lk


def _lk_params(cfg: FrontendConfig) -> lk.LKParams:
    return lk.LKParams(
        window=cfg.lk_window,
        levels=cfg.lk_levels,
        iters=cfg.lk_iters,
        eps=cfg.lk_eps,
        min_eig=cfg.lk_min_eig,
        max_residual=cfg.lk_max_residual,
    )


def _lk_stereo_params(cfg: FrontendConfig) -> lk.LKParams:
    """Lighter profile for the rectified L->R match (1-D search)."""
    return _lk_params(cfg)._replace(
        iters=cfg.lk_stereo_iters, levels=cfg.lk_stereo_levels
    )
