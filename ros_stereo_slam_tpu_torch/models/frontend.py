"""Per-frame pipeline stages (tracking, localization, bootstrap).

Port of ``ros_stereo_slam_tpu/models/frontend.py``, the per-stage API
beside the fused frame step (:mod:`.step`):

- :func:`preprocess`       — image -> pyramid (kept on the device)
- :func:`odometry_step`    — ``PerspectiveNpointEstimation``
  (``src/rosFuncs.cpp:73-94``): temporal LK + F-gate + PnP-RANSAC.
- :func:`stereo_bootstrap` — ``stereoTriangulate``
  (``src/triangulation.cpp:73-166``): stereo LK + F-gate + triangulation,
  lifted to world frame.
- :func:`_lk_params` / :func:`_lk_stereo_params` — the LK profiles the
  step uses too.

LK runs through ``lk_cuda.track_level`` (kernel K1 on CUDA tensors).
Sampling is split from the solve (as in :mod:`..ops.pnp`): the stages
take a ``torch.Generator`` where the reference takes a key, and their
``_from_sets`` forms take a ``draw(mask, k_hyp, m)`` callable, through
which a test feeds index sets drawn by the reference.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ros_stereo_slam_tpu_torch.config import FrontendConfig, PnPConfig
from ros_stereo_slam_tpu_torch.models.state import TrackState
from ros_stereo_slam_tpu_torch.ops import interp, lk, pnp, pyramid, ransac, triangulate
from ros_stereo_slam_tpu_torch.utils import lie
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

# draw(mask, k_hyp, m) -> (k_hyp, m) indices of valid points
Draw = Callable[[torch.Tensor, int, int], torch.Tensor]


class OdometryOut(NamedTuple):
    T_cw: torch.Tensor  # (4, 4) cam-from-world
    T_wc: torch.Tensor  # (4, 4) world-from-cam (the pose the pipeline logs)
    tracked: torch.Tensor  # (N, 2) tracked 2D points in the current frame
    mask: torch.Tensor  # (N,) bool — PnP inliers among tracked points
    n_tracked: torch.Tensor  # () int — survivors of LK + F-gate
    n_inliers: torch.Tensor  # () int — PnP inliers


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


def _draw_from(gen: torch.Generator) -> Draw:
    return lambda mask, k_hyp, m: ransac._sample_minimal_sets(gen, mask, k_hyp, m)


def preprocess(img: torch.Tensor, levels: int) -> tuple:
    """Image -> pyramid tuple (computed once, reused by both LK call sites)."""
    return tuple(pyramid.build_pyramid(img, levels))


def odometry_step(ref_pyr: tuple, cur_pyr: tuple, track: TrackState, gen: torch.Generator,
                  cam: Pinhole, pnp_thresh, fe: FrontendConfig, pc: PnPConfig) -> OdometryOut:
    """Track the reference feature set into the current frame and localize.

    Mirrors ``PyrLKtrackFrame2Frame`` + ``solvePnPRansac``
    (``src/tracking.cpp:46-91``, ``src/rosFuncs.cpp:73-94``), with the
    vector compactions replaced by masks.  Draws the F-gate's and then
    PnP's minimal sets from `gen`.
    """
    return odometry_from_sets(ref_pyr, cur_pyr, track, _draw_from(gen), cam, pnp_thresh, fe, pc)


def odometry_from_sets(ref_pyr: tuple, cur_pyr: tuple, track: TrackState, draw: Draw,
                       cam: Pinhole, pnp_thresh, fe: FrontendConfig,
                       pc: PnPConfig) -> OdometryOut:
    """:func:`odometry_step` with its minimal sets from `draw`: first the
    F-gate's (fmat_iters, 8), then PnP's (iters, 6)."""
    res = lk.track(ref_pyr, cur_pyr, track.pts2d, None, _lk_params(fe))
    m = track.mask & res.valid
    fres = ransac._fmat_from_sets(draw(m, fe.fmat_iters, 8), track.pts2d, res.points, m,
                                  thresh_px=fe.fmat_thresh_px)
    m = m & fres.inliers
    n_tracked = m.sum()
    pres = pnp._solve(
        draw(m, pc.iters, 6), None, cam, track.pts3d, res.points, m,
        thresh_px=pnp_thresh, refine_iters=pc.refine_iters, huber_px=pc.refine_huber_px,
    )
    return OdometryOut(
        T_cw=pres.T_cw,
        T_wc=lie.inv_se3(pres.T_cw),
        tracked=res.points,
        mask=pres.inliers,
        n_tracked=n_tracked,
        n_inliers=pres.n_inliers,
    )


def stereo_bootstrap(left_pyr: tuple, right_pyr: tuple, grid_pts: torch.Tensor,
                     grid_mask: torch.Tensor, T_wc: torch.Tensor, gen: torch.Generator,
                     cam: Pinhole, baseline, max_depth,
                     fe: FrontendConfig) -> tuple[TrackState, torch.Tensor]:
    """(Re)build the tracked feature set from a stereo pair.

    Stereo LK epipolar matching -> F-gate -> closed-form triangulation ->
    world lift by T_wc.  Returns (new TrackState, n_valid scalar).
    """
    return bootstrap_from_sets(left_pyr, right_pyr, grid_pts, grid_mask, T_wc, _draw_from(gen),
                               cam, baseline, max_depth, fe)


def bootstrap_from_sets(left_pyr: tuple, right_pyr: tuple, grid_pts: torch.Tensor,
                        grid_mask: torch.Tensor, T_wc: torch.Tensor, draw: Draw, cam: Pinhole,
                        baseline, max_depth,
                        fe: FrontendConfig) -> tuple[TrackState, torch.Tensor]:
    """:func:`stereo_bootstrap` with the F-gate's (fmat_iters, 8) minimal
    sets from `draw`."""
    res = lk.track(left_pyr, right_pyr, grid_pts, None, _lk_stereo_params(fe))
    m = grid_mask & res.valid
    fres = ransac._fmat_from_sets(draw(m, fe.fmat_iters, 8), grid_pts, res.points, m,
                                  thresh_px=fe.fmat_stereo_thresh_px)
    m = m & fres.inliers
    tri = triangulate.triangulate_rectified(
        cam, baseline, grid_pts, res.points, m, max_depth=max_depth
    )
    pts_world = lie.transform_points(T_wc, tri.points)
    gray = interp.bilinear_at(left_pyr[0], grid_pts)
    state = TrackState(
        pts2d=grid_pts, pts3d=pts_world, colors=torch.stack([gray, gray, gray], dim=-1),
        mask=tri.valid,
    )
    return state, tri.valid.sum()
