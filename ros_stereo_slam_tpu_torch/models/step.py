"""The stereo-odometry frame step and the whole-sequence loop.

Port of ``ros_stereo_slam_tpu/models/step.py`` for the odometry
configuration.  Where the reference is one jitted program, this is eager
PyTorch on the device that holds the frames:

- ``lax.scan`` over frames becomes a Python loop over frames staged on
  the device once (:func:`run_sequence`);
- the two ``lax.cond``s become host branches that read one device scalar
  each: the rescue re-track and the keyframe branch.  Every such read is
  counted in ``HOST_READS``;
- ``jax.random.split(carry.key, ...)`` becomes a generator per frame and
  stream, seeded from (``carry.key``, frame index, stream), so one seed
  gives a bitwise-identical trajectory on one device.  The streams are not
  JAX's (the parity tests compare poses, not random draws).

Only the default static choices are ported: the grid sampler, LK stereo
matching with the epipolar gate, no temporal F-gate and no BA.  The others
raise ``NotImplementedError``.  The RGB map path (``left_rgb``) is not
ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import frontend
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore, TrackState
from ros_stereo_slam_tpu_torch.ops import interp, lk, pnp, pyramid, sor, triangulate
from ros_stereo_slam_tpu_torch.utils import lie
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole, project

# Device -> host scalar reads made by the frame step in this process, and
# the frames among them that ran the rescue re-track.
HOST_READS = 0
RESCUES = 0

# Generator streams of one frame.
_STREAM_TRACK, _STREAM_RESCUE = 0, 1


class FrameStats(NamedTuple):
    T_wc: torch.Tensor  # (4, 4)
    n_tracked: torch.Tensor  # () int
    n_inliers: torch.Tensor  # () int
    is_keyframe: torch.Tensor  # () bool
    tracking_ok: torch.Tensor  # () bool
    used_retry: torch.Tensor  # () bool
    ba_rms: torch.Tensor  # () f32 — 0: BA is not ported


class SlamCarry(NamedTuple):
    track: TrackState
    T_wc: torch.Tensor  # (4, 4) current pose (world-from-cam)
    keyframes: KeyframeStore
    ref_pyr: tuple  # pyramid of the previous left image
    key: int  # base seed of the per-frame generators
    frame_idx: int  # index of the next frame
    # Previous inter-frame motion, the constant-velocity prior that seeds
    # the temporal LK track; dT_valid is False until one real motion has
    # been measured (a cold prior routes through the rescue).
    dT: torch.Tensor  # (4, 4)
    dT_valid: torch.Tensor  # () bool
    # Last measured L->R flow per (static) grid slot: the disparity prior
    # of the keyframe branch's stereo re-match.
    stereo_flow: torch.Tensor  # (N, 2)


def _check_supported(cfg: PipelineConfig) -> None:
    fe = cfg.frontend
    for name, got, want in (
        ("frontend.sampler", fe.sampler, "grid"),
        ("frontend.stereo_matcher", fe.stereo_matcher, "lk"),
        ("frontend.fmat_gate", fe.fmat_gate, "none"),
        ("frontend.stereo_gate", fe.stereo_gate, "epipolar"),
    ):
        if got != want:
            raise NotImplementedError(f"{name}={got!r} is not ported (only {want!r})")
    if cfg.ba_enabled:
        raise NotImplementedError("ba_enabled=True is not ported")


def _host_read(flag: torch.Tensor) -> bool:
    global HOST_READS
    HOST_READS += 1
    return bool(flag.item())


def _generator(key: int, frame_idx: int, stream: int, device) -> torch.Generator:
    seed = np.random.SeedSequence([key, frame_idx, stream]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _happy_levels(fe) -> int:
    """Pyramid depth the seeded steady-state path touches."""
    return min(max(fe.lk_seeded_levels, fe.lk_stereo_seeded_levels), fe.lk_levels)


def _cam_of(cfg: PipelineConfig) -> Pinhole:
    c = cfg.camera
    return Pinhole(fx=float(c.fx), fy=float(c.fy), cx=float(c.cx), cy=float(c.cy))


def _to_unit(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> [0, 1] float32, per frame (f32 frames pass through)."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    return img


def _bootstrap_track(
    left_pyr, right_pyr, grid_pts, grid_mask, T_wc, cfg: PipelineConfig,
    stereo_flow=None,
) -> tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Stereo LK -> epipolar gate -> triangulate -> SOR -> world lift.

    Returns (track, right_uv, right_mask).  `stereo_flow` (N, 2), if given,
    seeds the L->R match from each grid slot's last measured disparity.
    """
    fe, kfc = cfg.frontend, cfg.keyframes
    res = lk.track(left_pyr, right_pyr, grid_pts, stereo_flow,
                   frontend._lk_stereo_params(fe))
    # Rectified pair: a valid match has y_l == y_r and positive disparity.
    dy = res.points[:, 1] - grid_pts[:, 1]
    disp = grid_pts[:, 0] - res.points[:, 0]
    m = (grid_mask & res.valid & (torch.abs(dy) <= fe.stereo_epipolar_tol_px)
         & (disp > 0.05))
    tri = triangulate.triangulate_rectified(
        _cam_of(cfg), float(cfg.camera.baseline), grid_pts, res.points, m,
        max_depth=kfc.max_depth,
    )
    clean = sor.sor_filter(
        tri.points, tri.valid, mean_k=kfc.sor_mean_k,
        std_mul=kfc.sor_std_mul, max_depth=kfc.max_depth,
    )
    gray = interp.bilinear_at(left_pyr[0], grid_pts)
    track = TrackState(
        pts2d=grid_pts, pts3d=lie.transform_points(T_wc, tri.points),
        colors=torch.stack([gray, gray, gray], dim=-1), mask=clean,
    )
    return track, res.points, clean


def _track_and_pnp(carry: SlamCarry, ref_pyr, c_pyr, init_flow, lk_params,
                   gen: torch.Generator, cfg: PipelineConfig, cam, T_prior):
    """Temporal LK track -> PnP with the folded retry ladder; the previous
    pose seeds the GN hypothesis family."""
    pc = cfg.pnp
    r = lk.track(ref_pyr, c_pyr, carry.track.pts2d, init_flow, lk_params)
    mm = carry.track.mask & r.valid
    pp = pnp.pnp_ransac(
        gen, cam, carry.track.pts3d, r.points, mm,
        thresh_px=pc.thresh_px, iters=pc.iters,
        refine_iters=pc.refine_iters,
        T_init=T_prior, retry_thresh_px=pc.retry_thresh_px,
        min_inliers=pc.min_inliers, huber_px=pc.refine_huber_px,
    )
    return r.points, mm, pp


def _insert_keyframe(kf: KeyframeStore, track: TrackState, T_wc: torch.Tensor,
                     frame_idx: int) -> KeyframeStore:
    """Write the keyframe into ring slot count % capacity.

    The store's arrays are updated IN PLACE (the reference copies them);
    only ``count`` is a new tensor.  The slot stays on the device.
    """
    slot = (kf.count.long() % kf.capacity).reshape(1)
    kf.poses.index_copy_(0, slot, T_wc[None])
    kf.frame_idx.index_fill_(0, slot, frame_idx)
    kf.points.index_copy_(0, slot, track.pts3d[None])
    kf.colors.index_copy_(0, slot, track.colors[None])
    kf.point_mask.index_copy_(0, slot, track.mask[None])
    kf.retrack.index_fill_(0, slot, False)
    kf.valid.index_fill_(0, slot, True)
    return kf._replace(count=kf.count + 1)


def slam_frame_step(
    carry: SlamCarry,
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
) -> tuple[SlamCarry, FrameStats]:
    """One odometry frame on the frames' device.

    `left_img`/`right_img` (H, W) are float32 in [0, 1] or uint8 (cast
    here, per frame).
    """
    global RESCUES
    _check_supported(cfg)
    left_img, right_img = _to_unit(left_img), _to_unit(right_img)
    fe, pc, kfc = cfg.frontend, cfg.pnp, cfg.keyframes
    cam = _cam_of(cfg)
    dev = left_img.device
    seeded = fe.lk_seed == "const_velocity"
    # Lazy pyramid: the seeded path touches only the finest levels; the
    # rescue builds the coarse ones itself.
    cur_pyr = tuple(pyramid.build_pyramid(
        left_img, _happy_levels(fe) if seeded else fe.lk_levels))
    T_prior = lie.inv_se3(carry.T_wc)

    def track_and_pnp(ref_pyr, c_pyr, init_flow, lk_params, stream):
        gen = _generator(carry.key, carry.frame_idx, stream, dev)
        return _track_and_pnp(carry, ref_pyr, c_pyr, init_flow, lk_params,
                              gen, cfg, cam, T_prior)

    if seeded:
        # Predict the pose by replaying the last inter-frame motion, project
        # the landmarks, and track on a shallow pyramid from that seed.
        T_pred_cw = lie.inv_se3(carry.T_wc @ carry.dT)
        uv_pred, z_ok = project(cam, lie.transform_points(T_pred_cw, carry.track.pts3d))
        h0, w0 = cur_pyr[0].shape
        seed_ok = (z_ok & torch.isfinite(uv_pred).all(-1)
                   & interp.in_bounds(uv_pred, h0, w0, fe.lk_window // 2 + 1))
        init_flow = torch.where(seed_ok[:, None], uv_pred - carry.track.pts2d,
                                torch.zeros_like(uv_pred))
        n_lvl = min(fe.lk_seeded_levels, fe.lk_levels)
        tracked_pts, m, p = track_and_pnp(
            carry.ref_pyr[:n_lvl], cur_pyr[:n_lvl], init_flow,
            frontend._lk_params(fe)._replace(
                iters=fe.lk_seeded_iters, walk_iters=fe.lk_seeded_walk_iters),
            _STREAM_TRACK,
        )
        # Rescue: a wrong velocity prior starves PnP — re-track unseeded on
        # the full pyramid (coarse levels of both frames built only here).
        if _host_read((p.n_inliers < fe.lk_rescue_min_inliers) | ~carry.dT_valid):
            RESCUES += 1
            ref_full = tuple(pyramid.build_pyramid(carry.ref_pyr[0], fe.lk_levels))
            cur_full = tuple(pyramid.build_pyramid(left_img, fe.lk_levels))
            tracked_pts, m, p = track_and_pnp(
                ref_full, cur_full, None, frontend._lk_params(fe), _STREAM_RESCUE)
    else:
        tracked_pts, m, p = track_and_pnp(
            carry.ref_pyr, cur_pyr, None, frontend._lk_params(fe), _STREAM_TRACK)

    tracking_ok = p.n_inliers >= pc.min_inliers
    T_wc = torch.where(tracking_ok, lie.inv_se3(p.T_cw), carry.T_wc)

    # --- keyframe trigger + re-triangulation ---
    is_kf = (p.n_inliers < kfc.min_pnp_inliers) | ~tracking_ok
    if _host_read(is_kf):
        if seeded:
            n_lvl = min(fe.lk_stereo_seeded_levels, fe.lk_levels)
            right_pyr = tuple(pyramid.build_pyramid(right_img, n_lvl))
            track, r_uv, _ = _bootstrap_track(
                cur_pyr[:n_lvl], right_pyr, grid_pts, grid_mask, T_wc, cfg,
                stereo_flow=carry.stereo_flow,
            )
            flow = torch.where(track.mask[:, None], r_uv - grid_pts, carry.stereo_flow)
        else:
            right_pyr = tuple(pyramid.build_pyramid(right_img, fe.lk_levels))
            track, _, _ = _bootstrap_track(
                cur_pyr, right_pyr, grid_pts, grid_mask, T_wc, cfg)
            flow = carry.stereo_flow
        keyframes = _insert_keyframe(carry.keyframes, track, T_wc, carry.frame_idx)
    else:
        track = carry.track._replace(pts2d=tracked_pts, mask=p.inliers & m)
        flow = carry.stereo_flow
        keyframes = carry.keyframes

    # Velocity update: keep the last good estimate through a tracking
    # failure (the held pose would otherwise zero the prior).
    dT_new = torch.where(tracking_ok, lie.inv_se3(carry.T_wc) @ T_wc, carry.dT)
    new_carry = SlamCarry(
        track=track,
        T_wc=T_wc,
        keyframes=keyframes,
        ref_pyr=cur_pyr,
        key=carry.key,
        frame_idx=carry.frame_idx + 1,
        dT=dT_new,
        dT_valid=carry.dT_valid | tracking_ok,
        stereo_flow=flow,
    )
    stats = FrameStats(
        T_wc=T_wc,
        n_tracked=m.sum(),
        n_inliers=p.n_inliers,
        is_keyframe=is_kf,
        tracking_ok=tracking_ok,
        used_retry=p.used_retry,
        ba_rms=torch.zeros((), dtype=torch.float32, device=dev),
    )
    return new_carry, stats


def init_carry(
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    key: int,
    cfg: PipelineConfig,
) -> SlamCarry:
    """Frame-0 bootstrap: stereo-triangulate the grid, insert keyframe 0."""
    _check_supported(cfg)
    left_img, right_img = _to_unit(left_img), _to_unit(right_img)
    fe = cfg.frontend
    dev = left_img.device
    left_pyr = pyramid.build_pyramid(left_img, fe.lk_levels)
    right_pyr = pyramid.build_pyramid(right_img, fe.lk_levels)
    T0 = torch.eye(4, dtype=torch.float32, device=dev)
    track, r_uv, _ = _bootstrap_track(left_pyr, right_pyr, grid_pts, grid_mask, T0, cfg)
    kf = KeyframeStore.empty(cfg.keyframes.max_keyframes, fe.max_points, dev)
    kf = _insert_keyframe(kf, track, T0, 0)
    stereo_flow = torch.where(track.mask[:, None], r_uv - track.pts2d,
                              torch.zeros_like(r_uv))
    # Carry only the pyramid depth the steady-state (seeded) path touches.
    ref_keep = (left_pyr[: _happy_levels(fe)]
                if fe.lk_seed == "const_velocity" else left_pyr)
    return SlamCarry(
        track=track, T_wc=T0, keyframes=kf, ref_pyr=tuple(ref_keep),
        key=int(key), frame_idx=1,
        dT=torch.eye(4, dtype=torch.float32, device=dev),
        dT_valid=torch.zeros((), dtype=torch.bool, device=dev),
        stereo_flow=stereo_flow,
    )


def _stack_stats(stats: list[FrameStats], device) -> FrameStats:
    if stats:
        return FrameStats(*(torch.stack(f) for f in zip(*stats)))
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    b = dict(dtype=torch.bool, device=device)
    return FrameStats(
        T_wc=torch.zeros((0, 4, 4), **f32), n_tracked=torch.zeros((0,), **i64),
        n_inliers=torch.zeros((0,), **i64), is_keyframe=torch.zeros((0,), **b),
        tracking_ok=torch.zeros((0,), **b), used_retry=torch.zeros((0,), **b),
        ba_rms=torch.zeros((0,), **f32),
    )


def run_sequence(
    left_seq: torch.Tensor,  # (F, H, W) float32 or uint8 — frames 1..F
    right_seq: torch.Tensor,  # (F, H, W)
    carry: SlamCarry,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
) -> tuple[SlamCarry, FrameStats]:
    """Step every frame of a staged sequence; stats stacked along axis 0."""
    stats = []
    for i in range(left_seq.shape[0]):
        carry, st = slam_frame_step(carry, left_seq[i], right_seq[i],
                                    grid_pts, grid_mask, cfg)
        stats.append(st)
    return carry, _stack_stats(stats, left_seq.device)
