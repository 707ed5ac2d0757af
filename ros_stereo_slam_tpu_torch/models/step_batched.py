"""Batched-lane (DP-over-sequences) odometry: B sequences per frame step.

Port of ``ros_stereo_slam_tpu/models/step_batched.py``.  Where the
reference vmaps the single-lane step over B independent sequences, every
tensor here carries a leading lane axis written out, so each launch
serves all B lanes: K1 runs once per pyramid level for all lanes
(``lk_cuda.track_level_batch``), PnP solves every lane's hypotheses at
once, and the keyframe bootstrap triangulates all lanes together.

The step is :func:`.step._step_lanes`, the body that the single-lane
step runs with one lane, in the reference's four phases:

1. the seeded temporal track + PnP for all lanes;
2. the rescue re-track, run for all lanes when ANY lane needs it, then a
   per-lane ``where`` keeps it only in the lanes that asked;
3. the pose update and the continue-branch state;
4. the keyframe branch, likewise run when any lane triggers it, merged
   per lane, with a masked ring insert that writes only the triggering
   lanes' stores.

The reference's two ``lax.cond(jnp.any(...))`` become one host read each
(counted in ``step.HOST_READS``): 2 per frame, whatever B is.  The read
gives the count of lanes that ask, which the ``step.rescue`` and
``step.keyframe`` spans carry (``lanes``, ``asked``) and
``step.LANE_BRANCHES`` sums: the lane-slots a branch ran for lanes that
did not ask are the cost of the batch hoist.

Per-lane semantics equal :func:`.step.slam_frame_step`'s: lane b of a
batched run is the single-lane run started with
``init_carry(..., key=lane_keys(seed, B)[b], ...)`` (each lane draws its
RANSAC sets from its own generators, and every sum is taken per lane in
an order that does not depend on B: on the CPU the two agree bitwise;
BA solves each lane's window on its own).  Only the const-velocity-seeded
configuration is batched, as in the reference; RGB frames, BA and the
mapping preset run as in the single-lane step.  With
``KeyframeConfig.batch_align_window`` W > 1 the lanes share a keyframe
cadence: an inlier-triggered keyframe waits for a frame with
``frame_idx % W == 0``, a tracking failure fires at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import step as step_mod
from ros_stereo_slam_tpu_torch.models.step import FrameStats, SlamCarry
from ros_stereo_slam_tpu_torch.utils import profiling


def lane_keys(seed: int, lanes: int) -> tuple[int, ...]:
    """The base key of each lane of a batched run started from `seed`.

    The reference splits ``PRNGKey(seed)`` into B keys, whose streams torch
    cannot reproduce; here lane b's key (the ``key`` of its per-frame
    generators, ``step._generator``) is word b of
    ``SeedSequence([seed, lanes])``.  Lane b of a batched run equals the
    single-lane run started with ``init_carry(..., key=lane_keys(seed,
    lanes)[b], ...)``.
    """
    words = np.random.SeedSequence([int(seed), int(lanes)]).generate_state(lanes, np.uint64)
    return tuple(int(w) for w in words)


def check_batched(cfg: PipelineConfig) -> None:
    """Raise for the configurations the batched step does not run."""
    if cfg.frontend.lk_seed != "const_velocity":
        raise ValueError(
            "the batched step requires the const-velocity-seeded config (the "
            "batch hoist targets the seeded/rescue split); got "
            f"lk_seed={cfg.frontend.lk_seed!r}")


def slam_frame_step_batched(
    carry: SlamCarry,
    left_img: torch.Tensor,
    right_img: torch.Tensor,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
    left_rgb: torch.Tensor | None = None,
) -> tuple[SlamCarry, FrameStats]:
    """One odometry frame for B lanes (see the module docstring).

    `carry` from :func:`.step.init_carry_batched` (a leading lane axis on
    every tensor); `left_img`/`right_img` (B, H, W) float32 in [0, 1] or
    uint8; `left_rgb` (B, H, W, 3) float32 or uint8, or None; `grid_pts`
    (N, 2) and `grid_mask` (N,) shared by all lanes.  Returns the new
    carry and (B, ...) stats.
    """
    check_batched(cfg)
    if left_img.dim() != 3 or right_img.shape != left_img.shape \
            or len(carry.key) != left_img.shape[0]:
        raise ValueError(f"expected (B, H, W) frames for {len(carry.key)} lanes, got "
                         f"{tuple(left_img.shape)} and {tuple(right_img.shape)}")
    with profiling.span("step.frame", frame=carry.frame_idx, lanes=left_img.shape[0]):
        return step_mod._step_lanes(carry, left_img, right_img, grid_pts, grid_mask, cfg,
                                    left_rgb, kf_window=max(cfg.keyframes.batch_align_window, 1))


def run_sequence_batched(
    left_seq: torch.Tensor,  # (B, F, H, W) float32 or uint8 — frames 1..F per lane
    right_seq: torch.Tensor,
    carry: SlamCarry,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    cfg: PipelineConfig,
    rgb_seq: torch.Tensor | None = None,  # (B, F, H, W, 3) float32 or uint8
) -> tuple[SlamCarry, FrameStats]:
    """Step B staged sequences in lockstep; stats come back frame-major,
    (F, B, ...), as the reference's scan gives them.  `rgb_seq` colours
    each lane's keyframes."""
    check_batched(cfg)
    stats = []
    for i in range(left_seq.shape[1]):
        carry, st = slam_frame_step_batched(carry, left_seq[:, i], right_seq[:, i],
                                            grid_pts, grid_mask, cfg,
                                            None if rgb_seq is None else rgb_seq[:, i])
        stats.append(st)
    return carry, step_mod._stack_stats(stats, left_seq.device, (left_seq.shape[0],))
