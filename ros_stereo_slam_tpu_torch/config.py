"""Configuration system for the TPU-native SLAM pipeline.

The reference hardcodes every parameter in C++ and requires recompilation to
change dataset paths (``reference/src/VisualSLAM.cpp:220-222``,
``README.md:27-32``); intrinsics, baseline, loop parameters and thresholds
are scattered literals (``include/visualSLAM.h:68,82-87,120-127``; step 30,
inliers 200, cooldown 100, SOR 200/0.01).  Here everything is a frozen
dataclass; the five BASELINE.json configurations are provided as presets.

All capacities are STATIC — they size the fixed-shape arrays that every
jitted stage runs on.  Changing a capacity retriggers XLA compilation, so
presets pick TPU-friendly (multiple-of-8/128) values.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class CameraConfig:
    """Stereo rig calibration (KITTI grayscale rig by default)."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    baseline: float = 0.54  # meters; reference visualSLAM.h:68
    width: int = 1241
    height: int = 376


@dataclass(frozen=True)
class FrontendConfig:
    """Dense sampling + LK tracking + gating (reference C2/C4/C5)."""

    # px; the reference uses stepSize=30 (src/tracking.cpp:4-12), with 20
    # as an option in its older variant (include/trangulation.h:19).
    # Denser grids average drift down ~1/sqrt(N) but every point rides the
    # whole LK/PnP path; 24 (700 points on a KITTI frame) is the measured
    # speed/accuracy knee — vs step 20 (1116 points) it runs ~15% faster
    # end-to-end at ATE well inside the reference re-execution's envelope
    # (tools/sweep_fast2.py: 0.138 m vs OpenCV's 0.175 m at 192 frames).
    grid_step: int = 24
    # Static capacity for tracked points (multiple of 128).  Sized to the
    # actual grid population: step 24 on a 1241x376 KITTI frame yields 700
    # points; every padded slot costs full LK/RANSAC/PnP work, so keep the
    # capacity snug (shrink together with a sparser grid_step).
    max_points: int = 768
    sampler: str = "grid"  # "grid" (reference C2) or "anms" (FAST + C3)
    # Stereo correspondence source for (re)triangulation: "lk" = dense-grid
    # epipolar LK (reference DENSE_FLAG=true, src/triangulation.cpp:87-101);
    # "orb" = per-view ORB + mutual Hamming matmul matching (the reference's
    # non-dense BFMatcher variant, src/triangulation.cpp:104-134).
    stereo_matcher: str = "lk"
    orb_match_max_dist: float = 64.0
    orb_match_ratio: float = 0.8
    orb_epipolar_tol_px: float = 2.0
    # Pyramidal LK (reference uses OpenCV defaults: win 21, 3 levels + base,
    # 30 iters; Python proto src/ROSslam.py:145 same).  Window 15 measures
    # BETTER than 21 here on both bench worlds (0.078 -> 0.057 ATE corridor,
    # 0.091 -> 0.032 orbit) and is ~5% faster: the dense grid supplies
    # redundancy, and a smaller window averages less depth discontinuity
    # into each patch.
    lk_window: int = 15
    lk_levels: int = 4  # pyramid levels incl. base
    lk_iters: int = 10
    # Constant-velocity motion-model seeding for the temporal track: predict
    # this frame's pose as T_prev @ dT_prev, project the tracked landmarks,
    # and hand LK the predicted flow.  A good seed absorbs the large inter-
    # frame motion that the coarse pyramid levels exist to find, so the
    # seeded track runs on a shallow pyramid (lk_seeded_levels) — roughly
    # half the per-frame LK cost.  "none" reproduces the reference's
    # unseeded coarse-to-fine search (cv::calcOpticalFlowPyrLK has no seed
    # at either call site, reference/src/tracking.cpp:18,52).
    lk_seed: str = "const_velocity"
    # A good constant-velocity seed lands within ~1-2 px, so the seeded
    # track needs NO coarse levels at all: one full-resolution level with
    # a few more iterations is both faster (no level-1 kernel pass) and
    # more accurate (coarse-level mistracks can't poison the fine level)
    # than 2 levels x 6 iterations — measured 0.198 vs 0.237 ATE on the
    # 96-frame bench corridor at identical cost.
    lk_seeded_levels: int = 1
    # Per-level GN iterations for the SEEDED temporal track: the seed
    # starts within a few px, so fewer iterations converge (unseeded
    # tracks keep the full lk_iters).  6 measures both faster AND lower-
    # ATE than 10 on the 192-frame corridor (tools/sweep_fast.py) — the
    # extra iterations only chase sub-eps dither.
    lk_seeded_iters: int = 6
    # Of those, how many run as full "walk" iterations (fresh aligned-
    # superblock sample each step, MXU one-hot selects); the remainder run
    # in the kernel's freeze-polish phase (one (S+3, S+3) tile at the
    # post-walk anchor, register-level bilinear mixes — ~an order of
    # magnitude cheaper per iteration, valid within ~±1 px of the anchor).
    # A constant-velocity seed lands within 1-2 px, so a short walk
    # already brings the flow inside the polish cell.
    lk_seeded_walk_iters: int = 10
    # Rescue: if the seeded track's PnP lands under this many inliers the
    # frame re-tracks unseeded on the FULL pyramid (lax.cond — executed
    # only on distressed frames).  Catches a wrong velocity prior: the
    # first frame (identity prior) and motion discontinuities.
    lk_rescue_min_inliers: int = 50
    lk_eps: float = 0.01
    lk_min_eig: float = 1e-7  # for images in [0, 1]
    lk_max_residual: float = 0.8  # contrast-normalized photometric gate
    # Stereo (left->right) LK profile.  The pair is rectified, so the
    # search is effectively 1-D along the row and converges in fewer
    # iterations than the temporal track; the keyframe branch re-runs the
    # stereo match every insertion (reference keyframes cost ~2x,
    # SURVEY.md §3.2), so a lighter profile buys back most of that.
    lk_stereo_iters: int = 6
    lk_stereo_levels: int = 4
    # Seeded stereo profile: the dense grid is STATIC, so each slot's last
    # measured disparity is a strong prior for the next re-triangulation
    # (scene depth at a pixel drifts slowly between keyframes).  When
    # lk_seed is enabled the keyframe-branch stereo match starts from that
    # prior at FULL RESOLUTION ONLY (level-1 passes add cost, not accuracy,
    # under a good disparity prior — measured); the first bootstrap (no
    # prior yet) always runs the full coarse-to-fine profile.
    lk_stereo_seeded_levels: int = 1
    # Stereo-match gate.  The reference runs full F-matrix RANSAC on the
    # L->R matches (FmatThresholding, src/tracking.cpp:30-43) because its
    # code never assumes rectification — but KITTI pairs ARE rectified
    # (the triangulation relies on it), so the epipolar geometry is known
    # analytically: a valid match has y_l == y_r and positive disparity.
    # "epipolar" gates on exactly that (no RANSAC, saves the 8-point
    # hypothesis solves + (K, N) Sampson scoring in the keyframe branch);
    # "fmat" reproduces the reference's RANSAC gate.
    stereo_gate: str = "epipolar"
    stereo_epipolar_tol_px: float = 1.5
    # Fundamental-matrix RANSAC gate (reference src/tracking.cpp:30-43:
    # CV_RANSAC 3.0 px, 0.99; frame2frame 8-pt 1.0 px).
    # Fixed hypothesis budget (parallel RANSAC).  128 is ~4x OpenCV's
    # adaptive budget at 50% inliers and measures accuracy-neutral on both
    # bench worlds; halving it from 256 saves ~0.4 ms/frame.
    fmat_iters: int = 128
    fmat_thresh_px: float = 1.0
    fmat_stereo_thresh_px: float = 3.0
    # Temporal-track outlier gate.  "ransac" reproduces the reference's
    # per-frame findFundamentalMat(8pt) on the tracked pairs
    # (src/tracking.cpp:75-84).  "none" drops it: the LK photometric
    # residual gate + PnP-RANSAC's own 3D-2D inlier model (which the
    # reference ALSO runs right after, rosFuncs.cpp:84) already reject
    # the same outliers — the F-gate is redundant on this path and costs
    # the 8-point hypothesis solves + a (K, N) Sampson scoring matmul
    # every frame.  Measured: dropping it is faster AND slightly lower
    # ATE on the bench corridor (tools/sweep_fast2.py), so "none" is the
    # default; set "ransac" for reference-exact gating.
    fmat_gate: str = "none"
    # ANMS (reference src/ANMS.cpp:18-67)
    anms_robust_coeff: float = 1.11
    fast_thresh: float = 12.0


@dataclass(frozen=True)
class PnPConfig:
    """PnP-RANSAC localization (reference src/rosFuncs.cpp:73-94)."""

    # Parallel hypotheses (ref: 100 sequential).  128 still exceeds the
    # reference's sequential budget and measures ~0.15 ms/frame cheaper
    # than 256 at equal ATE (tools/sweep_fast.py).
    iters: int = 128
    thresh_px: float = 1.0  # inlier gate, as the reference (rosFuncs.cpp:84)
    # Huber scale for the GN polish, TIGHTER than the gate: downweights
    # (rather than excludes) the noisier half of the inliers.  Captures the
    # drift reduction a hard 0.5 px gate gives on well-textured scenes
    # (0.095 -> 0.062 ATE on the 96-frame bench) without the gate's
    # fragility when per-point noise approaches it (a hard 0.5 px gate
    # starved PnP on the half-res orbit test: 0.67 m vs 0.09 m ATE).
    refine_huber_px: float = 0.5
    retry_thresh_px: float = 8.0  # reference retry ladder rosFuncs.cpp:85-93
    min_inliers: int = 10  # below -> tracking failure (SHUTDOWN in ref)
    # Gauss-Newton polish on SE(3).  4 iterations converge (ATE-neutral
    # vs 8, tools/sweep_fast.py) at ~0.3 ms/frame less.
    refine_iters: int = 4


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe triggering + map management (reference C8/C14)."""

    max_keyframes: int = 512  # ring-buffer capacity
    min_pnp_inliers: int = 200  # trigger: reference VisualSLAM.cpp:120
    map_block_points: int = 1536  # points per keyframe cloud block
    sor_mean_k: int = 32  # reference uses meanK=200 (rosFuncs.cpp:9); 32 kNN
    sor_std_mul: float = 1.0  # over blocks is the masked equivalent
    max_depth: float = 500.0  # z cutoff, reference rosFuncs.cpp:12-14
    # BATCHED lanes only (step_batched): snap inlier-triggered keyframe
    # re-bootstraps to frames where frame_idx % window == 0, so lanes
    # fire the shared hoisted branch TOGETHER instead of paying it on
    # any lane's frame (P(any) grows 1-(1-p)^B).  The trigger is a
    # LEVEL signal (inliers stay < min_pnp_inliers until the
    # re-bootstrap), so no pending state is needed — an off-window
    # trigger re-evaluates true on the next window frame, deferring the
    # keyframe by <= window-1 frames.  Tracking FAILURES re-bootstrap
    # immediately regardless.  1 = exact single-lane semantics
    # (default; the lane-vs-single parity test pins it).
    batch_align_window: int = 1


@dataclass(frozen=True)
class LoopClosureConfig:
    """BoW loop detection (reference C9: TemplatedLoopDetector params)."""

    enabled: bool = True
    orb_features: int = 512  # descriptors per frame (static capacity)
    # ORB pyramid levels at factor 1.25 (the reference's cv::ORB is
    # pyramidal — 8 levels at factor 1.2 by OpenCV default,
    # optimizationStuff.cpp:50).  Revisits at a different distance need
    # features detected across scales; 4 levels span 1..1.95x, covering
    # relative scale changes up to ~1.95x between two multi-scale frames.
    orb_levels: int = 4
    # Vocabulary geometry (reference bagOfWordsDetector.cpp:21: k=9, L=6 =
    # 531,441 words).  Read by bench.py and tools/build_vocab.py when
    # training; the detector itself takes whatever Vocabulary it is given.
    # No equivalent of DBoW2's di_levels direct index exists: the geometric
    # check brute-forces ALL descriptor pairs on the MXU, which strictly
    # supersedes the direct-index shortlist (a CPU-time optimization).
    vocab_k: int = 9  # branching factor
    vocab_levels: int = 6  # depth
    # Detection cadence: run ORB + BoW + database query every Nth frame
    # (1 = reference behavior, optimizationStuff.cpp:49 runs every frame —
    # only because its host loop was already slower than its camera).
    # The accept rule needs query-match > 100 frames and arms a 100-frame
    # cooldown, so strides <= 4 cost no recall on revisits lasting more
    # than a few frames; the island/temporal-consistency tolerances widen
    # with the stride (CandidateGater).  Default 2 halves the per-frame
    # detection cost (measured 2.33 ms -> 1.17 ms amortized on TPU v5e);
    # recall evidence: the streaming cadence test
    # (tests/test_slam_full.py::test_detect_every_cadence_still_closes),
    # the jittered revisit bench and the jittered endurance run all still
    # close their loops at stride 2 (RESULTS.md).  Set 1 for
    # reference-exact cadence.
    detect_every: int = 2
    dislocal: int = 20  # skip this many recent frames (detector default)
    max_db_results: int = 50
    # Binned-shortlist query (vocab.score_db_binned): each frame's sparse
    # BoW folds into an (n_bins,) histogram; database scoring is one
    # (db_capacity, n_bins) bf16 MXU matvec; the top `shortlist` entries
    # are re-scored EXACTLY (min-intersection) before the top-K /gates.
    # The dense-row path this replaces cost ~15 ms/frame in TPU scatter+
    # gather at the 531k-word scale, independent of db size.
    n_bins: int = 4096
    shortlist: int = 128
    min_nss: float = 0.005
    # removeLowScores cutoff on nss-normalized scores — ABSOLUTE, as the
    # reference (TemplatedLoopDetector.h:748; configured 0.9 with use_nss,
    # visualSLAM.h:124).
    alpha: float = 0.9
    k_consistency: int = 1  # temporal window, reference visualSLAM.h:125
    geom_min_points: int = 12
    geom_ransac_iters: int = 256
    geom_thresh_px: float = 2.0
    neigh_ratio: float = 0.6
    min_separation: int = 100  # accept iff query - match > 100 (driver rule,
    cooldown: int = 100  # reference src/optimizationStuff.cpp:59-63)
    db_capacity: int = 4096  # reference allocates 4000 (visualSLAM.h:137)
    # Loop-edge measurement: "pnp" stereo-triangulates the query's ORB
    # features and solves the metric relative pose to the matched frame
    # (the reference's planned-but-unbuilt getLCMeasurement,
    # dump.cpp:331-348); "identity" reproduces the reference's shipped
    # absolute-closure semantics (poseGraph.h:118, README.md:39).  PnP
    # falls back to identity when it finds < geom_min_points inliers.
    edge_measurement: str = "pnp"


@dataclass(frozen=True)
class PGOConfig:
    """SE(3) pose-graph optimization (reference C11: g2o GN x10)."""

    iters: int = 10  # reference poseGraph.h:130 optimize(10)
    max_poses: int = 4608  # reference reserves 4500 (VisualSLAM.cpp:37)
    max_loop_edges: int = 64
    damping: float = 1e-6  # LM-style diagonal damping for the GN solve
    cg_iters: int = 128  # block-CG iterations for the normal equations


@dataclass(frozen=True)
class BAConfig:
    """Windowed Schur-complement bundle adjustment (reference C13)."""

    window: int = 8  # keyframes per BA window
    max_landmarks: int = 2048
    iters: int = 10  # reference bundleAdjust.cpp:598 optimize(10)
    damping: float = 1e-4
    huber_px: float = 2.0


@dataclass(frozen=True)
class ParallelConfig:
    """Device-mesh layout for multi-chip / multi-host runs."""

    mesh_shape: tuple = (1,)  # devices along the 'shard' axis
    axis_name: str = "shard"


@dataclass(frozen=True)
class PipelineConfig:
    camera: CameraConfig = CameraConfig()
    frontend: FrontendConfig = FrontendConfig()
    pnp: PnPConfig = PnPConfig()
    keyframes: KeyframeConfig = KeyframeConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    pgo: PGOConfig = PGOConfig()
    ba: BAConfig = BAConfig()
    parallel: ParallelConfig = ParallelConfig()
    ba_enabled: bool = False
    export_map: bool = False
    seed: int = 0

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# BASELINE.json presets (the five benchmark configurations)
# ---------------------------------------------------------------------------


def preset_odometry() -> PipelineConfig:
    """Config 1: stereo odometry only (ANMS + LK + RANSAC-PnP), no LC."""
    return PipelineConfig(loop=LoopClosureConfig(enabled=False))


def preset_mapping() -> PipelineConfig:
    """Config 2: odometry + triangulated RGB point-cloud map + PLY export."""
    return PipelineConfig(loop=LoopClosureConfig(enabled=False), export_map=True)


def preset_loop_closure() -> PipelineConfig:
    """Config 3: full SLAM with BoW loop closure + pose-graph optimization."""
    return PipelineConfig(export_map=True)


def preset_ba() -> PipelineConfig:
    """Config 4: keyframe management + windowed Schur BA."""
    return PipelineConfig(export_map=True, ba_enabled=True)


def preset_distributed(n_devices: int) -> PipelineConfig:
    """Config 5: keyframes/map blocks partitioned across devices."""
    return PipelineConfig(
        export_map=True,
        ba_enabled=True,
        parallel=ParallelConfig(mesh_shape=(n_devices,)),
    )


PRESETS = {
    "odometry": preset_odometry,
    "mapping": preset_mapping,
    "loop_closure": preset_loop_closure,
    "ba": preset_ba,
}
