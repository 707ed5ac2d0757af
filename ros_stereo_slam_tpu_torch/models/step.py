"""The stereo-odometry frame step and the whole-sequence loop.

Port of ``ros_stereo_slam_tpu/models/step.py`` for the odometry
configuration.  Where the reference is one jitted program, this is eager
PyTorch on the device that holds the frames:

- ``lax.scan`` over frames becomes a Python loop over frames staged on
  the device once (:func:`run_sequence`);
- the two ``lax.cond``s become host branches that read one device scalar
  each, the count of lanes that ask: the rescue re-track and the keyframe
  branch.  Every such read is counted in ``HOST_READS`` and held by a
  ``host_read`` span (:mod:`..utils.profiling`; the step's others:
  ``step.frame`` around each frame, ``step.track``, ``step.pnp``,
  ``step.rescue`` and ``step.keyframe`` with the lanes run and the lanes
  that asked (``lanes``, ``asked``; steps of several lanes also count them
  in ``LANE_BRANCHES``), ``step.ba`` with each solve's lanes, poses ``W``,
  landmark slots ``N`` and ``iters``, and the solves' ``ba.*`` spans in
  it);
- ``jax.random.split(carry.key, ...)`` becomes a generator per frame and
  stream, seeded from (``carry.key``, frame index, stream), so one seed
  gives a bitwise-identical trajectory on one device.  The streams are not
  JAX's (the parity tests compare poses, not random draws).

Every static choice of the frontend is ported, each a branch of the
reference's step: the keypoint sampler (the grid, or FAST + ANMS:
``sampler="anms"``), the stereo matcher (LK, or ORB on both views matched
by :func:`.match.mutual_hamming_match`: ``stereo_matcher="orb"``), the
stereo gate (the epipolar rows, or F-matrix RANSAC: any ``stereo_gate``
but ``"epipolar"``) and the temporal F-gate before PnP
(``fmat_gate="ransac"``).  The two F-gates draw from streams of their
own, so the default configuration draws and launches what it did before
they were ported.  The RGB map path
(``left_rgb``: keyframe colours from an RGB frame, config 2) and windowed
bundle adjustment (``cfg.ba_enabled``, config 4: :func:`_ba_refine` on
every frame, :func:`_ba_reset` on every keyframe) are ported.  The BA
state's ring slot, fixed poses and frame counts stay tensors on the
device, so BA adds no host read.

The step is written for lanes (:func:`_step_lanes`: a leading lane axis B
on every tensor, one host read per branch for all lanes); the single-lane
step runs it with one lane and the batched-lane step of
:mod:`.step_batched` with B, so a lane rounds as its single-lane run does.
:func:`init_carry_batched` is the lanes' frame-0 bootstrap.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import bundle_adjust, frontend
from ros_stereo_slam_tpu_torch.models.state import KeyframeShard, KeyframeStore, TrackState
from ros_stereo_slam_tpu_torch.ops import (anms, fast, interp, lk, match, orb, pnp, pyramid,
                                           ransac, sor, triangulate)
from ros_stereo_slam_tpu_torch.utils import lie, profiling
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole, project

# Device -> host scalar reads made by the frame step in this process, and
# the frames among them that ran the rescue re-track.
HOST_READS = 0
RESCUES = 0
# Per any-lane branch ("rescue", "keyframe"), over the steps of more than
# one lane that ran it: the runs, the lane-slots they ran (B a run) and the
# lane-slots that asked for it.  Lanes that did not ask ride along.
LANE_BRANCHES = {name: {"runs": 0, "lanes": 0, "asked": 0} for name in ("rescue", "keyframe")}

# Generator streams of one frame: PnP on the seeded track and on the
# rescue; the temporal F-gate on each; the keyframe branch's stereo F-gate
# (frame 0's bootstrap included); a correction's re-bootstrap.
_STREAM_TRACK, _STREAM_RESCUE = 0, 1
_STREAM_FGATE_TRACK, _STREAM_FGATE_RESCUE, _STREAM_KEYFRAME, _STREAM_CORRECTION = 2, 3, 4, 5


class FrameStats(NamedTuple):
    T_wc: torch.Tensor  # (4, 4)
    n_tracked: torch.Tensor  # () int
    n_inliers: torch.Tensor  # () int
    is_keyframe: torch.Tensor  # () bool
    tracking_ok: torch.Tensor  # () bool
    used_retry: torch.Tensor  # () bool
    ba_rms: torch.Tensor  # () f32 — post-BA reprojection RMS (0 if disabled)


class BAState(NamedTuple):
    """Sliding observation window of local bundle adjustment.

    Ring of the last W frames' tracked 2D observations of the CURRENT
    landmark set, plus the stereo right-view observations captured at the
    landmark set's keyframe: the scale anchor (monocular BA has a free
    global-scale gauge; the right view pins it through the landmarks).
    Lane form: a leading lane axis on every field.  Never written in place:
    each frame makes new tensors, so a carry may share its BA state.
    """

    obs_uv: torch.Tensor  # (W, N, 2)
    obs_mask: torch.Tensor  # (W, N) bool
    T_cw: torch.Tensor  # (W, 4, 4) cam-from-world of the ring frames
    right_uv: torch.Tensor  # (N, 2) right-view observations at the keyframe
    right_mask: torch.Tensor  # (N,) bool
    T_cw_right: torch.Tensor  # (4, 4) right-camera pose (fixed)
    n_frames: torch.Tensor  # () int32 — frames pushed since the last keyframe

    @staticmethod
    def empty(window: int, n: int, device, lanes: int | None = None) -> "BAState":
        f32 = dict(dtype=torch.float32, device=device)
        ln = () if lanes is None else (lanes,)
        return BAState(
            obs_uv=torch.zeros((*ln, window, n, 2), **f32),
            obs_mask=torch.zeros((*ln, window, n), dtype=torch.bool, device=device),
            T_cw=torch.eye(4, **f32).repeat(*ln, window, 1, 1),
            right_uv=torch.zeros((*ln, n, 2), **f32),
            right_mask=torch.zeros((*ln, n), dtype=torch.bool, device=device),
            T_cw_right=torch.eye(4, **f32).repeat(*ln, 1, 1),
            n_frames=torch.zeros(ln, dtype=torch.int32, device=device),
        )


class SlamCarry(NamedTuple):
    track: TrackState
    T_wc: torch.Tensor  # (4, 4) current pose (world-from-cam)
    keyframes: KeyframeStore
    ref_pyr: tuple  # pyramid of the previous left image
    key: int  # base seed of the per-frame generators (one per lane: a tuple)
    frame_idx: int  # index of the next frame
    # Previous inter-frame motion, the constant-velocity prior that seeds
    # the temporal LK track; dT_valid is False until one real motion has
    # been measured (a cold prior routes through the rescue).
    dT: torch.Tensor  # (4, 4)
    dT_valid: torch.Tensor  # () bool
    # Last measured L->R flow per (static) grid slot: the disparity prior
    # of the keyframe branch's stereo re-match.
    stereo_flow: torch.Tensor  # (N, 2)
    ba: BAState | None = None  # present iff cfg.ba_enabled


def _lanes_asking(mask: torch.Tensor, branch: str) -> int:
    """How many of the (B,) lanes of `mask` ask for `branch`, in the one
    host read the branch costs; a run of more than one lane is counted in
    :data:`LANE_BRANCHES`."""
    global HOST_READS
    HOST_READS += 1
    with profiling.span("host_read", site=f"step.{branch}"):
        asked = int(mask.cpu().sum())  # B flags in one copy, counted on the host: no kernel
    if asked and mask.shape[0] > 1:
        c = LANE_BRANCHES[branch]
        c["runs"] += 1
        c["lanes"] += mask.shape[0]
        c["asked"] += asked
    return asked


def _generator(key: int, frame_idx: int, stream: int, device) -> torch.Generator:
    seed = np.random.SeedSequence([key, frame_idx, stream]).generate_state(1, np.uint64)[0]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def _stereo_gate_generators(cfg: PipelineConfig, keys, frame_idx: int,
                            stream: int, device) -> list | None:
    """One generator per lane for the stereo F-gate of a (re)bootstrap, or
    None where the bootstrap draws nothing (the epipolar gate, ORB stereo)."""
    fe = cfg.frontend
    if fe.stereo_matcher == "orb" or fe.stereo_gate == "epipolar":
        return None
    return [_generator(k, frame_idx, stream, device) for k in keys]


def _grid_lk(fe) -> bool:
    """The static grid with LK stereo: the only frontend whose keyframe
    branch can seed its stereo re-match from each slot's last disparity."""
    return fe.sampler == "grid" and fe.stereo_matcher == "lk"


def _happy_levels(fe) -> int:
    """Pyramid depth the seeded steady-state path touches.  A keyframe
    branch that re-matches unseeded (the ANMS sampler, ORB stereo) needs
    the full pyramid every frame."""
    if _grid_lk(fe):
        return min(max(fe.lk_seeded_levels, fe.lk_stereo_seeded_levels), fe.lk_levels)
    return fe.lk_levels


def _right_levels(fe) -> int:
    """Pyramid depth of the right view in an unseeded (re)bootstrap: ORB
    stereo reads level 0 only."""
    return 1 if fe.stereo_matcher == "orb" else fe.lk_levels


def _cam_of(cfg: PipelineConfig) -> Pinhole:
    c = cfg.camera
    return Pinhole(fx=float(c.fx), fy=float(c.fy), cx=float(c.cx), cy=float(c.cy))


def _to_unit(img: torch.Tensor) -> torch.Tensor:
    """uint8 frames -> [0, 1] float32, per frame (f32 frames pass through)."""
    if img.dtype == torch.uint8:
        return img.to(torch.float32) * (1.0 / 255.0)
    return img


def _sample_keypoints(left_img: torch.Tensor, grid_pts, grid_mask, fe):
    """Keypoint source of B lanes: the static grid (reference C2) or FAST +
    ANMS on level 0 (reference C3, ``src/ANMS.cpp:18-67``) with the exact
    top corners (the reference's ``approx_max_k`` is a TPU mechanic)."""
    if fe.sampler != "anms":
        return grid_pts, grid_mask
    score = fast.fast_score(left_img, fe.fast_thresh / 255.0)
    cand_pts, cand_scores, cand_mask = fast.top_corners(score, 4 * fe.max_points)
    return anms.anms(cand_pts, cand_scores, cand_mask, fe.max_points, fe.anms_robust_coeff)


def _orb_lanes(img: torch.Tensor, fe) -> orb.OrbFeatures:
    """ORB features of a (B, H, W) stack: kernel K2 on a single lane's
    image, K2b on B > 1 lanes (a lane of K2b equals K2's call)."""
    if img.shape[0] == 1:
        f = orb.detect_and_compute(img[0], fe.max_points, fe.fast_thresh / 255.0)
        return orb.OrbFeatures(*(x[None] for x in f))
    return orb.detect_and_compute(img, fe.max_points, fe.fast_thresh / 255.0)


def _fgate(gens: list, pts1: torch.Tensor, pts2: torch.Tensor, mask: torch.Tensor,
           thresh_px: float, iters: int) -> torch.Tensor:
    """F-matrix RANSAC inliers of B lanes, lane by lane (lane b draws from
    gens[b]), so a lane rounds as its single-lane run does."""
    return _lane_by_lane(
        lambda a, b, m, g: ransac.fmat_ransac(g, a, b, m, thresh_px, iters).inliers,
        pts1, pts2, mask, gens)


def _bootstrap_track(
    left_pyr, right_pyr, grid_pts, grid_mask, T_wc, cfg: PipelineConfig,
    gens: list | None = None, stereo_flow=None, left_rgb=None,
) -> tuple[TrackState, torch.Tensor, torch.Tensor]:
    """Keypoints -> stereo match -> gate -> triangulate -> SOR -> world lift.

    The keypoints are the grid or FAST + ANMS (``sampler``), matched by
    stereo LK behind the epipolar or the F-matrix gate (``stereo_gate``;
    the latter draws from `gens`, one generator per lane), or ORB corners
    of both views matched by descriptor (``stereo_matcher="orb"``).
    Returns (track, right_uv, right_mask); the right-view matches feed the
    BA window's scale anchor.  `stereo_flow` (N, 2), if given, seeds the
    L->R match from each grid slot's last measured disparity.  `left_rgb`
    (H, W, 3; float32 in [0, 1] or uint8, scaled here), if given, colours
    the points (the reference's ``getColors``); otherwise the grayscale
    intensity is replicated.  Lane form: (B, h, w) pyramids, (B, N, 2)
    grid points, (B, 4, 4) poses, (B, H, W, 3) RGB frames.
    """
    fe, kfc = cfg.frontend, cfg.keyframes
    if fe.stereo_matcher == "orb":
        # The reference's non-dense path: ORB on each view, brute-force
        # descriptor matching gated to pairs on one row with positive
        # disparity (src/triangulation.cpp:104-134).
        fl, fr = _orb_lanes(left_pyr[0], fe), _orb_lanes(right_pyr[0], fe)
        dv = torch.abs(fl.pts[..., :, None, 1] - fr.pts[..., None, :, 1])
        disp = fl.pts[..., :, None, 0] - fr.pts[..., None, :, 0]
        pair_ok = (dv <= fe.orb_epipolar_tol_px) & (disp > 0.1)
        mres = match.mutual_hamming_match(
            fl.desc_sign, fl.valid, fr.desc_sign, fr.valid, max_dist=fe.orb_match_max_dist,
            ratio=fe.orb_match_ratio, pair_mask=pair_ok)
        pts = fl.pts.contiguous()
        right_pts = torch.gather(fr.pts, -2, mres.idx[..., None].expand(mres.idx.shape + (2,)))
        m = mres.valid
    else:
        pts, mask = _sample_keypoints(left_pyr[0], grid_pts, grid_mask, fe)
        res = lk.track(left_pyr, right_pyr, pts, stereo_flow, frontend._lk_stereo_params(fe))
        m = mask & res.valid
        if fe.stereo_gate == "epipolar":
            # Rectified pair: a valid match has y_l == y_r and positive disparity.
            dy = res.points[..., 1] - pts[..., 1]
            disp = pts[..., 0] - res.points[..., 0]
            m = m & (torch.abs(dy) <= fe.stereo_epipolar_tol_px) & (disp > 0.05)
        else:
            m = m & _fgate(gens, pts, res.points, m, fe.fmat_stereo_thresh_px, fe.fmat_iters)
        right_pts = res.points
    tri = triangulate.triangulate_rectified(
        _cam_of(cfg), float(cfg.camera.baseline), pts, right_pts, m,
        max_depth=kfc.max_depth,
    )
    clean = sor.sor_filter(
        tri.points, tri.valid, mean_k=kfc.sor_mean_k,
        std_mul=kfc.sor_std_mul, max_depth=kfc.max_depth,
    )
    if left_rgb is not None:
        colors = interp.bilinear_at_rgb(left_rgb, pts)
    else:
        gray = interp.bilinear_at(left_pyr[0], pts)
        colors = torch.stack([gray, gray, gray], dim=-1)
    track = TrackState(
        pts2d=pts, pts3d=_lane_by_lane(lie.transform_points, T_wc, tri.points),
        colors=colors, mask=clean,
    )
    return track, right_pts, clean


def _track_and_pnp(carry: SlamCarry, ref_pyr, c_pyr, init_flow, lk_params,
                   gen, fgens, cfg: PipelineConfig, cam, T_prior):
    """Temporal LK track -> F-matrix gate (``fmat_gate="ransac"``, drawing
    from `fgens`; the reference's ``src/tracking.cpp:75-84``) -> PnP with
    the folded retry ladder; the previous pose seeds the GN hypothesis
    family."""
    fe, pc = cfg.frontend, cfg.pnp
    with profiling.span("step.track"):
        r = lk.track(ref_pyr, c_pyr, carry.track.pts2d, init_flow, lk_params)
        mm = carry.track.mask & r.valid
        if fe.fmat_gate == "ransac":
            mm = mm & _fgate(fgens, carry.track.pts2d, r.points, mm, fe.fmat_thresh_px,
                             fe.fmat_iters)
    with profiling.span("step.pnp"):
        pp = pnp.pnp_ransac(
            gen, cam, carry.track.pts3d, r.points, mm,
            thresh_px=pc.thresh_px, iters=pc.iters,
            refine_iters=pc.refine_iters,
            T_init=T_prior, retry_thresh_px=pc.retry_thresh_px,
            min_inliers=pc.min_inliers, huber_px=pc.refine_huber_px,
        )
    return r.points, mm, pp


def _right_cam_pose(T_wc: torch.Tensor, baseline: float) -> torch.Tensor:
    """Cam-from-world of the RIGHT camera: shift by -baseline along cam x
    (lane form: (B, 4, 4), lane by lane)."""
    shift = torch.eye(4, dtype=T_wc.dtype, device=T_wc.device)
    shift[0, 3] = -baseline
    return _lane_by_lane(lambda T: shift @ lie.inv_se3(T), T_wc)


def _ba_reset(track: TrackState, right_uv, right_mask, T_wc, cfg: PipelineConfig) -> BAState:
    """A fresh window after a (re)bootstrap of B lanes: slot 0 holds the
    keyframe's left observations (the track's points), the right-view
    observations pin scale."""
    B, N = track.mask.shape
    st = BAState.empty(cfg.ba.window - 1, N, T_wc.device, lanes=B)
    return BAState(
        obs_uv=torch.cat([track.pts2d[:, None], st.obs_uv], dim=1),
        obs_mask=torch.cat([track.mask[:, None], st.obs_mask], dim=1),
        T_cw=torch.cat([_lane_by_lane(lie.inv_se3, T_wc)[:, None], st.T_cw], dim=1),
        right_uv=right_uv,
        right_mask=right_mask,
        T_cw_right=_right_cam_pose(T_wc, cfg.camera.baseline),
        n_frames=torch.ones((B,), dtype=torch.int32, device=T_wc.device),
    )


def _ba_refine(ba: BAState, track: TrackState, T_wc, obs_uv, obs_mask, cfg: PipelineConfig):
    """Push this frame's observations into B lanes' windows and run the
    windowed Schur BA of each lane (:func:`.bundle_adjust.ba_solve`, lane
    by lane, so a lane rounds as its single-lane run does).

    Returns (new_ba, refined T_wc, refined track, rms_after (B,)).  The
    ring slot and the fixed poses follow from ``n_frames`` on the device.
    """
    W = cfg.ba.window
    dev = T_wc.device
    ring = torch.arange(W, device=dev)
    slot = (ba.n_frames % W).long()
    at_slot = ring == slot[:, None]  # (B, W)
    n_frames = ba.n_frames + 1
    ba = ba._replace(
        obs_uv=torch.where(at_slot[..., None, None], obs_uv[:, None], ba.obs_uv),
        obs_mask=torch.where(at_slot[..., None], obs_mask[:, None], ba.obs_mask),
        T_cw=torch.where(at_slot[..., None, None], _lane_by_lane(lie.inv_se3, T_wc)[:, None],
                         ba.T_cw),
        n_frames=n_frames,
    )
    # Stack: pose 0 is the right view (always fixed), 1.. the ring frames.
    poses = torch.cat([ba.T_cw_right[:, None], ba.T_cw], dim=1)
    obs = torch.cat([ba.right_uv[:, None], ba.obs_uv], dim=1)
    masks = torch.cat([ba.right_mask[:, None], ba.obs_mask], dim=1)
    # Fix the right view and the oldest ring frame (gauge + scale anchor),
    # and the slots never written.
    oldest = torch.where(n_frames <= W, 0, n_frames % W)
    fixed = torch.cat([torch.ones_like(at_slot[:, :1]),
                       (ring == oldest[:, None]) | (ring >= n_frames[:, None])], dim=1)
    bc = cfg.ba
    outs = [bundle_adjust.ba_solve(_cam_of(cfg), poses[b], track.pts3d[b], obs[b], masks[b],
                                   fixed[b], iters=bc.iters, damping=bc.damping,
                                   huber_px=bc.huber_px)
            for b in range(poses.shape[0])]
    T_out, X_out, rms = (x[0][None] if len(outs) == 1 else torch.stack(x)
                         for x in zip(*((r.T_cw, r.landmarks, r.rms_after) for r in outs)))
    lanes = torch.arange(T_out.shape[0], device=dev)
    T_wc_new = _lane_by_lane(lie.inv_se3, T_out[lanes, 1 + slot])
    return ba._replace(T_cw=T_out[:, 1:]), T_wc_new, track._replace(pts3d=X_out), rms


def _insert_keyframe(kf: KeyframeStore, track: TrackState, T_wc: torch.Tensor,
                     frame_idx: int, sel: torch.Tensor | None = None,
                     shard: KeyframeShard | None = None) -> KeyframeStore:
    """Write the keyframe into ring slot count % capacity.

    The store's arrays are updated IN PLACE (the reference copies them);
    only ``count`` is a new tensor.  The slot stays on the device.

    Lane form (every field with a leading lane axis B): only the lanes in
    `sel` (B,) bool write their slot and advance their count; the other
    lanes' slots are written back unchanged, so no lane's store is touched
    by another lane's keyframe and nothing is read on the host.  Without
    `sel`, every lane writes.

    On a `shard` of a ring sharded over a mesh, the slot is taken in the
    whole ring (``count % shard.capacity``) and written only where this
    shard holds it; ``count`` advances on every shard.
    """
    if T_wc.dim() == 2:  # one store: the lane form with one lane (views)
        out = _insert_keyframe(KeyframeStore(*(x[None] for x in kf)),
                               TrackState(*(x[None] for x in track)), T_wc[None], frame_idx,
                               shard=shard)
        return KeyframeStore(*(x[0] for x in out))
    lanes = torch.arange(T_wc.shape[0], device=T_wc.device)
    keep = sel
    if shard is None:
        slot = kf.count.long() % kf.capacity
    else:
        slot = kf.count.long() % shard.capacity - shard.base
        mine = (slot >= 0) & (slot < kf.capacity)
        slot = slot.clamp(0, kf.capacity - 1)
        keep = mine if sel is None else sel & mine

    def put(field: torch.Tensor, new) -> None:
        if keep is not None:
            k = keep.reshape((-1,) + (1,) * (field.dim() - 2))
            new = torch.where(k, new, field[lanes, slot])
        field[lanes, slot] = new

    put(kf.poses, T_wc)
    put(kf.frame_idx, frame_idx)
    put(kf.points, track.pts3d)
    put(kf.colors, track.colors)
    put(kf.point_mask, track.mask)
    put(kf.retrack, False)
    put(kf.valid, True)
    return kf._replace(count=kf.count + (1 if sel is None else sel.to(kf.count.dtype)))


def _lane_by_lane(fn, *args):
    """`fn` on each lane's slice of `args`, stacked on the lane axis.  The
    pose products of the step go through here: a batched 4x4 product
    rounds differently for one transform and for a batch of them (mm
    against bmm on the CPU, cuBLAS kernels on the card), so every lane runs
    the same 2-D call whatever B is.  With one lane the result is a view of
    that call's, so the single-lane step launches what a 2-D step would."""
    outs = [fn(*(a[b] for a in args)) for b in range(args[0].shape[0])]
    return outs[0][None] if len(outs) == 1 else torch.stack(outs)


def _where_lanes(pred: torch.Tensor, a, b):
    """Per-lane select over matching tuples of tensors (or tensors):
    pred (B,), leaves (B, ...).  It merges a branch that runs when any lane
    takes it, so with one lane that lane took it: `a` is returned as it is,
    with no select to launch."""
    if pred.shape[0] == 1:
        return a
    if isinstance(a, torch.Tensor):
        return torch.where(pred.reshape(pred.shape + (1,) * (a.dim() - 1)), a, b)
    merged = [_where_lanes(pred, x, y) for x, y in zip(a, b, strict=True)]
    return type(a)(*merged) if hasattr(a, "_fields") else tuple(merged)


def _map_carry(carry: SlamCarry, fn, key) -> SlamCarry:
    """`fn` applied to every tensor of the carry; `key` replaces the key."""
    return SlamCarry(
        track=TrackState(*map(fn, carry.track)), T_wc=fn(carry.T_wc),
        keyframes=KeyframeStore(*map(fn, carry.keyframes)),
        ref_pyr=tuple(map(fn, carry.ref_pyr)), key=key, frame_idx=carry.frame_idx,
        dT=fn(carry.dT), dT_valid=fn(carry.dT_valid), stereo_flow=fn(carry.stereo_flow),
        ba=None if carry.ba is None else BAState(*map(fn, carry.ba)),
    )


def _one_lane(carry: SlamCarry) -> SlamCarry:
    """A single-lane carry as the lane form with B = 1 (views)."""
    return _map_carry(carry, lambda t: t[None], (carry.key,))


def _drop_lane(carry: SlamCarry) -> SlamCarry:
    """The only lane of a B = 1 carry (views)."""
    return _map_carry(carry, lambda t: t[0], carry.key[0])


def slam_frame_step(
    carry: SlamCarry,
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
    left_rgb: torch.Tensor | None = None,
    kf_shard: KeyframeShard | None = None,
) -> tuple[SlamCarry, FrameStats]:
    """One odometry frame on the frames' device.

    `left_img`/`right_img` (H, W) are float32 in [0, 1] or uint8 (cast
    here, per frame); `left_rgb` (H, W, 3; float32 or uint8), if given,
    colours the points a keyframe triangulates (the RGB map path).  It
    runs :func:`_step_lanes` with one lane, so a lane of the batched step
    rounds exactly as this step does.  `kf_shard`: the carry's keyframe
    store is that shard of a ring sharded over a mesh.
    """
    with profiling.span("step.frame", frame=carry.frame_idx, lanes=1):
        new, stats = _step_lanes(_one_lane(carry), left_img[None], right_img[None], grid_pts,
                                 grid_mask, cfg, None if left_rgb is None else left_rgb[None],
                                 kf_shard)
        return _drop_lane(new), FrameStats(*(s[0] for s in stats))


def _step_lanes(
    carry: SlamCarry,
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
    left_rgb: torch.Tensor | None = None,
    kf_shard: KeyframeShard | None = None,
    kf_window: int = 1,
) -> tuple[SlamCarry, FrameStats]:
    """The frame step of B lanes: `carry` with a leading lane axis on every
    tensor and B keys, (B, H, W) frames (and (B, H, W, 3) RGB frames or
    None), the (N, 2) grid shared by all lanes.  Every branch costs one
    host read of "how many lanes take it" (:func:`_lanes_asking`); when
    any does, it runs for all lanes and a per-lane ``where`` keeps it
    only in the lanes that take it.  With one lane that is the reference's
    ``lax.cond``; with B it is the reference's batch-hoisted branch
    (``step_batched.py``).  `kf_window` > 1 is the batched step's shared
    keyframe cadence (``KeyframeConfig.batch_align_window``).
    """
    global RESCUES
    # frames sliced from a (B, F, H, W) stack are strided views; the
    # kernels take contiguous lanes
    left_img = _to_unit(left_img).contiguous()
    right_img = _to_unit(right_img).contiguous()
    fe, pc, kfc = cfg.frontend, cfg.pnp, cfg.keyframes
    cam = _cam_of(cfg)
    dev = left_img.device
    B = left_img.shape[0]
    seeded = fe.lk_seed == "const_velocity"
    stereo_seeded = seeded and _grid_lk(fe)
    # Lazy pyramid: the seeded path touches only the finest levels; the
    # rescue builds the coarse ones itself.
    cur_pyr = tuple(pyramid.build_pyramid(
        left_img, _happy_levels(fe) if seeded else fe.lk_levels))
    T_prior = _lane_by_lane(lie.inv_se3, carry.T_wc)

    def track_and_pnp(ref_pyr, c_pyr, init_flow, lk_params, stream, fgate_stream):
        gens = [_generator(k, carry.frame_idx, stream, dev) for k in carry.key]
        fgens = ([_generator(k, carry.frame_idx, fgate_stream, dev) for k in carry.key]
                 if fe.fmat_gate == "ransac" else None)
        return _track_and_pnp(carry, ref_pyr, c_pyr, init_flow, lk_params,
                              gens, fgens, cfg, cam, T_prior)

    if seeded:
        # Predict the pose by replaying the last inter-frame motion, project
        # the landmarks, and track on a shallow pyramid from that seed.
        T_pred_cw = _lane_by_lane(lambda T, dT: lie.inv_se3(lie.compose(T, dT)),
                                  carry.T_wc, carry.dT)
        uv_pred, z_ok = project(
            cam, _lane_by_lane(lie.transform_points, T_pred_cw, carry.track.pts3d))
        h0, w0 = cur_pyr[0].shape[-2:]
        seed_ok = (z_ok & torch.isfinite(uv_pred).all(-1)
                   & interp.in_bounds(uv_pred, h0, w0, fe.lk_window // 2 + 1))
        init_flow = torch.where(seed_ok[..., None], uv_pred - carry.track.pts2d,
                                torch.zeros_like(uv_pred))
        n_lvl = min(fe.lk_seeded_levels, fe.lk_levels)
        tracked = track_and_pnp(
            carry.ref_pyr[:n_lvl], cur_pyr[:n_lvl], init_flow,
            frontend._lk_params(fe)._replace(
                iters=fe.lk_seeded_iters, walk_iters=fe.lk_seeded_walk_iters),
            _STREAM_TRACK, _STREAM_FGATE_TRACK,
        )
        # Rescue: a wrong velocity prior starves PnP — re-track unseeded on
        # the full pyramid (coarse levels of both frames built only here).
        need_rescue = (tracked[2].n_inliers < fe.lk_rescue_min_inliers) | ~carry.dT_valid
        asked = _lanes_asking(need_rescue, "rescue")
        if asked:
            RESCUES += 1
            with profiling.span("step.rescue", lanes=B, asked=asked):
                ref_full = tuple(pyramid.build_pyramid(carry.ref_pyr[0], fe.lk_levels))
                cur_full = tuple(pyramid.build_pyramid(left_img, fe.lk_levels))
                rescued = track_and_pnp(ref_full, cur_full, None, frontend._lk_params(fe),
                                        _STREAM_RESCUE, _STREAM_FGATE_RESCUE)
                tracked = _where_lanes(need_rescue, rescued, tracked)
    else:
        tracked = track_and_pnp(carry.ref_pyr, cur_pyr, None, frontend._lk_params(fe),
                                _STREAM_TRACK, _STREAM_FGATE_TRACK)
    tracked_pts, m, p = tracked

    tracking_ok = p.n_inliers >= pc.min_inliers
    T_wc = torch.where(tracking_ok[:, None, None], _lane_by_lane(lie.inv_se3, p.T_cw),
                       carry.T_wc)

    # --- windowed Schur bundle adjustment (config 4) ---
    track, ba = carry.track, carry.ba
    ba_rms = torch.zeros((B,), dtype=torch.float32, device=dev)
    if cfg.ba_enabled:
        with profiling.span("step.ba", lanes=B, W=cfg.ba.window + 1, N=track.pts3d.shape[1],
                            iters=cfg.ba.iters):
            ba, T_wc, track, ba_rms = _ba_refine(ba, track, T_wc, tracked_pts, p.inliers & m,
                                                 cfg)
    track = track._replace(pts2d=tracked_pts, mask=p.inliers & m)
    flow = carry.stereo_flow
    keyframes = carry.keyframes

    # --- keyframe trigger + re-triangulation ---
    is_kf = (p.n_inliers < kfc.min_pnp_inliers) | ~tracking_ok
    if kf_window > 1 and carry.frame_idx % kf_window:
        # Off the shared window frame, inlier-triggered keyframes wait;
        # tracking failures fire at once.  frame_idx is lockstep across
        # lanes, so on window frames every due lane fires together.
        is_kf = ~tracking_ok
    asked = _lanes_asking(is_kf, "keyframe")
    if asked:
        with profiling.span("step.keyframe", lanes=B, asked=asked):
            gp = grid_pts.expand(B, -1, -1).contiguous()
            gm = grid_mask.expand(B, -1)
            gens = _stereo_gate_generators(cfg, carry.key, carry.frame_idx, _STREAM_KEYFRAME,
                                           dev)
            if stereo_seeded:
                n_lvl = min(fe.lk_stereo_seeded_levels, fe.lk_levels)
                right_pyr = tuple(pyramid.build_pyramid(right_img, n_lvl))
                kf_track, r_uv, r_mask = _bootstrap_track(
                    cur_pyr[:n_lvl], right_pyr, gp, gm, T_wc, cfg, gens,
                    stereo_flow=carry.stereo_flow, left_rgb=left_rgb,
                )
                flow = _where_lanes(is_kf, torch.where(kf_track.mask[..., None], r_uv - gp,
                                                       carry.stereo_flow), flow)
            else:
                # Unseeded on the full pyramid; the grid's disparity prior is
                # left as it is.  ORB stereo reads level 0 of the right view only.
                right_pyr = tuple(pyramid.build_pyramid(right_img, _right_levels(fe)))
                kf_track, r_uv, r_mask = _bootstrap_track(cur_pyr, right_pyr, gp, gm, T_wc, cfg,
                                                          gens, left_rgb=left_rgb)
            if cfg.ba_enabled:
                ba = _where_lanes(is_kf, _ba_reset(kf_track, r_uv, r_mask, T_wc, cfg), ba)
            track = _where_lanes(is_kf, kf_track, track)
            keyframes = _insert_keyframe(keyframes, track, T_wc, carry.frame_idx,
                                         is_kf if B > 1 else None, kf_shard)

    # Velocity update: keep the last good estimate through a tracking
    # failure (the held pose would otherwise zero the prior).
    dT_new = torch.where(tracking_ok[:, None, None], _lane_by_lane(lie.compose, T_prior, T_wc),
                         carry.dT)
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
        ba=ba,
    )
    stats = FrameStats(
        T_wc=T_wc,
        n_tracked=m.sum(-1),
        n_inliers=p.n_inliers,
        is_keyframe=is_kf,
        tracking_ok=tracking_ok,
        used_retry=p.used_retry,
        ba_rms=ba_rms,
    )
    return new_carry, stats


def init_carry(
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    key: int,
    cfg: PipelineConfig,
    left_rgb: torch.Tensor | None = None,
) -> SlamCarry:
    """Frame-0 bootstrap: stereo-triangulate the grid, insert keyframe 0
    (coloured from `left_rgb` (H, W, 3) if given), open the BA window."""
    with profiling.span("step.frame", frame=0, lanes=1):
        return _drop_lane(_init_lanes(left_img[None], right_img[None], grid_pts, grid_mask,
                                      (int(key),), cfg,
                                      None if left_rgb is None else left_rgb[None]))


def init_carry_batched(
    left_imgs: torch.Tensor,
    right_imgs: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    keys,
    cfg: PipelineConfig,
    left_rgbs: torch.Tensor | None = None,
) -> SlamCarry:
    """Frame-0 bootstrap of B lanes at once (the reference's
    ``vmap(init_carry)``): (B, H, W) images (and (B, H, W, 3) RGB frames
    or None), one int key per lane, the (N, 2) grid shared by all lanes.  Every tensor of the carry gains a
    leading lane axis, ``key`` becomes a tuple of B keys and ``frame_idx``
    stays one int (lanes step in lockstep).  Lane b equals
    ``init_carry(..., key=keys[b], ...)``.
    """
    with profiling.span("step.frame", frame=0, lanes=left_imgs.shape[0]):
        return _init_lanes(left_imgs, right_imgs, grid_pts, grid_mask, keys, cfg, left_rgbs)


def _init_lanes(left_imgs, right_imgs, grid_pts, grid_mask, keys, cfg: PipelineConfig,
                left_rgbs=None) -> SlamCarry:
    """The body of :func:`init_carry_batched`."""
    B = left_imgs.shape[0]
    if left_imgs.dim() != 3 or right_imgs.shape != left_imgs.shape or len(keys) != B:
        raise ValueError(f"expected (B, H, W) images and B keys: {tuple(left_imgs.shape)}, "
                         f"{tuple(right_imgs.shape)}, {len(keys)} keys")
    left_imgs = _to_unit(left_imgs).contiguous()
    right_imgs = _to_unit(right_imgs).contiguous()
    fe = cfg.frontend
    dev = left_imgs.device
    left_pyr = pyramid.build_pyramid(left_imgs, fe.lk_levels)
    right_pyr = pyramid.build_pyramid(right_imgs, _right_levels(fe))
    T0 = torch.eye(4, dtype=torch.float32, device=dev).expand(B, 4, 4).contiguous()
    gp = grid_pts.expand(B, -1, -1).contiguous()
    gens = _stereo_gate_generators(cfg, keys, 0, _STREAM_KEYFRAME, dev)
    track, r_uv, r_mask = _bootstrap_track(left_pyr, right_pyr, gp, grid_mask.expand(B, -1), T0,
                                           cfg, gens, left_rgb=left_rgbs)
    kf = KeyframeStore.empty(cfg.keyframes.max_keyframes, fe.max_points, dev, lanes=B)
    kf = _insert_keyframe(kf, track, T0, 0)
    stereo_flow = torch.where(track.mask[..., None], r_uv - track.pts2d, torch.zeros_like(r_uv))
    # Carry only the pyramid depth the steady-state (seeded) path touches.
    ref_keep = (left_pyr[: _happy_levels(fe)]
                if fe.lk_seed == "const_velocity" else left_pyr)
    return SlamCarry(
        track=track, T_wc=T0, keyframes=kf, ref_pyr=tuple(ref_keep),
        key=tuple(int(k) for k in keys), frame_idx=1,
        dT=T0.clone(),
        dT_valid=torch.zeros((B,), dtype=torch.bool, device=dev),
        stereo_flow=stereo_flow,
        ba=_ba_reset(track, r_uv, r_mask, T0, cfg) if cfg.ba_enabled else None,
    )


def _stack_stats(stats: list[FrameStats], device, lead: tuple = ()) -> FrameStats:
    """Per-frame stats stacked along a new frame axis 0; `lead` is the lane
    shape of each frame's stats, for an empty sequence."""
    if stats:
        return FrameStats(*(torch.stack(f) for f in zip(*stats)))
    f32 = dict(dtype=torch.float32, device=device)
    i64 = dict(dtype=torch.int64, device=device)
    b = dict(dtype=torch.bool, device=device)
    e = (0,) + tuple(lead)
    return FrameStats(
        T_wc=torch.zeros(e + (4, 4), **f32), n_tracked=torch.zeros(e, **i64),
        n_inliers=torch.zeros(e, **i64), is_keyframe=torch.zeros(e, **b),
        tracking_ok=torch.zeros(e, **b), used_retry=torch.zeros(e, **b),
        ba_rms=torch.zeros(e, **f32),
    )


def run_sequence(
    left_seq: torch.Tensor,  # (F, H, W) float32 or uint8 — frames 1..F
    right_seq: torch.Tensor,  # (F, H, W)
    carry: SlamCarry,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
    rgb_seq: torch.Tensor | None = None,  # (F, H, W, 3) float32 or uint8
) -> tuple[SlamCarry, FrameStats]:
    """Step every frame of a staged sequence; stats stacked along axis 0."""
    stats = []
    for i in range(left_seq.shape[0]):
        carry, st = slam_frame_step(carry, left_seq[i], right_seq[i], grid_pts, grid_mask, cfg,
                                    None if rgb_seq is None else rgb_seq[i])
        stats.append(st)
    return carry, _stack_stats(stats, left_seq.device)
