"""Full stereo SLAM, frame by frame: odometry + loop closure + pose graph.

Port of ``ros_stereo_slam_tpu/models/slam.py``.  Each
:meth:`StereoSLAM.process_frame` mirrors the reference's frame flow
(``reference/src/VisualSLAM.cpp:54-200``, SURVEY.md §3.1/§3.4):

1. the odometry step (:func:`.step.slam_frame_step`), whose relative
   motion becomes the pose graph's odometry edge;
2. on every ``detect_every``-th frame, loop detection on the left image
   (:class:`.loop_closure.LoopDetector`: ORB with kernel K2, the descent
   with kernel K3, the database query, the gates, the geometric check);
3. on an accepted closure: the loop edge (measured by PnP exactly as the
   scan epilogue measures it, :func:`.slam_scan.measure_loop_edges`),
   global optimization of the whole ``max_poses`` graph, and
   :func:`corrected_carry`: the keyframe map follows the corrected
   trajectory and tracking restarts from the optimized pose.

Driver-level accept rule: ``query - match > min_separation`` and a
cooldown that counts down once per FRAME; detection runs during the
cooldown, so the database and the gates' temporal window stay those of
the scan posture, which accepts the same closures.

As the JAX package's driver does, the gray frames are cast to float32
and NOT scaled: uint8 frames reach the step as 0..255 (ROADMAP F2).  RGB
frames (``left_rgb``) keep their dtype and a uint8 one is scaled where the
keyframe samples it, as in every driver.  BA runs inside the step when
``cfg.ba_enabled``; a correction opens a fresh BA window.

With a ``mesh`` (:mod:`ros_stereo_slam_tpu_torch.parallel.mesh`, config 5)
every rank runs the same frames through the same step, as the JAX
program runs it replicated, but holds only its K/D slots of the keyframe
store (:mod:`ros_stereo_slam_tpu_torch.parallel.dist_map`); a closure
solves the pose graph chain-sharded when the mesh has more than one rank
and rewrites each rank's blocks in place.  The outputs (``keyframes``,
``map_points``, ``save_map``, the checkpoint) gather the map, so every
rank calls them; only rank 0 writes files.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import loop_closure, slam_scan, step as step_mod
from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
from ros_stereo_slam_tpu_torch.models.pipeline import (FrameInfo, _grid_for, map_points_of,
                                                       rgb_frame)
from ros_stereo_slam_tpu_torch.models.pose_graph import PoseGraph, rewrite_points
from ros_stereo_slam_tpu_torch.models.state import KeyframeShard, TrackState
from ros_stereo_slam_tpu_torch.ops import orb, pyramid
from ros_stereo_slam_tpu_torch.parallel import dist_map
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, barrier, check_mesh
from ros_stereo_slam_tpu_torch.utils import lie, profiling


def corrected_carry(carry: step_mod.SlamCarry, new_poses: torch.Tensor,
                    old_poses: torch.Tensor, right_img: torch.Tensor, grid_pts: torch.Tensor,
                    grid_mask: torch.Tensor, cfg: PipelineConfig,
                    rgb_img: torch.Tensor | None = None,
                    shard: KeyframeShard | None = None) -> step_mod.SlamCarry:
    """Apply a pose-graph result to the carry after frame
    f = ``carry.frame_idx - 1`` (the reference's ``VisualSLAM.cpp:120-146``,
    as both online drivers apply it).

    Every keyframe cloud and pose follows the corrected trajectory; the
    live feature set is re-triangulated at frame f's optimized pose from
    the full pyramids of frame f's left image (the carry's ``ref_pyr[0]``)
    and `right_img` (uint8 is scaled), coloured from frame f's `rgb_img`
    if given; frame f enters the keyframe ring, whose arrays are written
    in place; with BA on, the window restarts on the new track.  With a
    `shard` the carry holds that rank's block of a ring sharded over a
    mesh: its blocks are rewritten and frame f lands in the whole ring's
    slot, written where the block holds it (no collective).
    """
    fe = cfg.frontend
    f = carry.frame_idx - 1
    kf = carry.keyframes
    kf = kf._replace(
        points=rewrite_points(kf.points, kf.frame_idx, old_poses, new_poses),
        poses=new_poses[kf.frame_idx.to(torch.int64)],
        retrack=kf.retrack | kf.valid,
    )
    T_opt = new_poses[f].clone()
    left_pyr = pyramid.build_pyramid(carry.ref_pyr[0], fe.lk_levels)
    right_pyr = pyramid.build_pyramid(step_mod._to_unit(right_img).contiguous(),
                                      step_mod._right_levels(fe))
    gens = step_mod._stereo_gate_generators(cfg, (carry.key,), f, step_mod._STREAM_CORRECTION,
                                            T_opt.device)
    track, r_uv, r_mask = step_mod._bootstrap_track(  # one lane
        tuple(p[None] for p in left_pyr), tuple(p[None] for p in right_pyr), grid_pts[None],
        grid_mask[None], T_opt[None], cfg, gens,
        left_rgb=None if rgb_img is None else rgb_img[None])
    ba = None
    if cfg.ba_enabled:
        ba = step_mod.BAState(*(x[0] for x in step_mod._ba_reset(track, r_uv, r_mask,
                                                                   T_opt[None], cfg)))
    track = TrackState(*(x[0] for x in track))
    kf = step_mod._insert_keyframe(kf, track, T_opt, f, shard=shard)
    return carry._replace(track=track, T_wc=T_opt, keyframes=kf, ba=ba)


@dataclass
class LoopEvent:
    query: int
    match: int
    n_inliers: int


@dataclass
class StereoSLAM:
    """Streaming SLAM: one :meth:`process_frame` per stereo pair on `device`
    (under a `mesh`, on the mesh's device, every rank calling every method
    with the same frames)."""

    config: PipelineConfig
    vocab: vocab_mod.Vocabulary | None = None
    mesh: Mesh | None = None
    device: torch.device | str = "cuda"
    frame_count: int = field(init=False, default=0)

    def __post_init__(self):
        check_mesh(self.mesh)
        cfg = self.config
        self._kf_shard = None
        if self.mesh is not None:
            if torch.device(self.device).type != self.mesh.device.type:
                raise ValueError(f"device {self.device} is not the mesh's {self.mesh.device}")
            self.device = self.mesh.device
            self._kf_shard = dist_map.keyframe_shardings(self.mesh, cfg.keyframes.max_keyframes)
        self.grid_pts, self.grid_mask = _grid_for(cfg, self.device)
        self._carry = None
        self.trajectory_dev = None  # (max_poses, 4, 4) on the device
        self.graph = PoseGraph(cfg.pgo, self.device)
        self.detector = (loop_closure.LoopDetector(self.vocab, cfg.loop, self.device)
                         if self.vocab is not None and cfg.loop.enabled else None)
        self.cooldown = 0
        self.loop_events: list[LoopEvent] = []
        self.keyframe_frames: list[int] = []
        self.tracking_failed = False

    # -- helpers -----------------------------------------------------------

    def _frame(self, img) -> torch.Tensor:
        """float32 on the device, NOT scaled (F2)."""
        return torch.as_tensor(img, dtype=torch.float32).to(self.device).contiguous()

    def _orb(self, left: torch.Tensor) -> orb.OrbFeatures:
        lcc = self.config.loop
        return orb.detect_and_compute(left, lcc.orb_features,
                                      self.config.frontend.fast_thresh / 255.0,
                                      n_levels=lcc.orb_levels)

    def _append_pose(self, T_wc: torch.Tensor) -> None:
        f = self.frame_count
        if f >= self.config.pgo.max_poses:
            raise RuntimeError(f"trajectory capacity exhausted ({self.config.pgo.max_poses} "
                               "poses); raise PGOConfig.max_poses")
        self.trajectory_dev[f] = T_wc

    def _detect_loop(self, left: torch.Tensor,
                     suppressed: bool) -> loop_closure.LoopCandidate | None:
        """Detection and the accept rule for the current frame; `suppressed`
        while the cooldown runs (detection still runs, so the database and
        the temporal window stay those of the scan posture).  The detector
        already drops candidates within ``min_separation`` frames."""
        if self.detector is None:
            return None
        with profiling.span("detect.frame", frame=self.frame_count, lanes=1):
            with profiling.span("detect.orb"):
                feats = self._orb(left)
            cand = self.detector.detect(self.frame_count, feats)
        if suppressed or cand is None:
            return None
        self.cooldown = self.config.loop.cooldown
        return cand

    def _measure_loop_edge(self, cand: loop_closure.LoopCandidate, left: torch.Tensor,
                           right: torch.Tensor) -> tuple:
        """The closure's pose-graph edge (i, j, Z): PnP-measured to vertex
        ``match`` or the identity edge to ``match - 1``, computed by the
        scan epilogue's own :func:`.slam_scan.measure_loop_edges`."""
        accepted = [(cand.query, cand.match, cand.match_idx, cand.match_inliers,
                     cand.n_inliers)]
        _, edges = slam_scan.measure_loop_edges(accepted, self.detector.lc,
                                                lambda fid: (left, right), self.config)
        return edges[0]

    # -- public API --------------------------------------------------------

    def initialize(self, left, right, left_rgb=None) -> FrameInfo:
        """Frame 0: triangulate the initial feature set (coloured from
        `left_rgb` (H, W, 3) float32 or uint8, if given); frame 0 enters the
        loop database."""
        cfg = self.config
        left, right = self._frame(left), self._frame(right)
        self._carry = step_mod.init_carry(left, right, self.grid_pts, self.grid_mask,
                                          cfg.seed, cfg, rgb_frame(left_rgb, self.device))
        self._shard_store()
        self.trajectory_dev = torch.eye(4, dtype=torch.float32,
                                        device=self.device).repeat(cfg.pgo.max_poses, 1, 1)
        self.graph.initialize()
        if self.detector is not None:
            with profiling.span("detect.frame", frame=0, lanes=1):
                with profiling.span("detect.orb"):
                    feats = self._orb(left)
                self.detector.add(0, feats)
        n = int(self._carry.track.mask.sum())
        self.keyframe_frames.append(0)
        self.frame_count = 1
        return FrameInfo(frame=0, T_wc=np.eye(4, dtype=np.float32), n_tracked=n, n_inliers=n,
                         is_keyframe=True, tracking_ok=True, used_retry=False)

    def process_frame(self, left, right, left_rgb=None) -> FrameInfo:
        """One frame: the step, detection, and on an accepted closure the
        correction; `left_rgb` colours the points of a keyframe."""
        cfg = self.config
        frame_idx = self.frame_count
        left, right = self._frame(left), self._frame(right)
        rgb = rgb_frame(left_rgb, self.device)
        prev_T = self._carry.T_wc
        self._carry, stats = step_mod.slam_frame_step(self._carry, left, right, self.grid_pts,
                                                      self.grid_mask, cfg, rgb, self._kf_shard)
        T_wc = self._carry.T_wc
        self.graph.add_odometry(lie.inv_se3(prev_T) @ T_wc)
        self._append_pose(T_wc)

        # the cooldown counts down once per frame, detection frames or not
        suppressed = self.cooldown > 0
        if suppressed:
            self.cooldown -= 1
        cand = (self._detect_loop(left, suppressed)
                if self.frame_count % max(cfg.loop.detect_every, 1) == 0 else None)
        if cand is not None:
            self.graph.add_loop(*self._measure_loop_edge(cand, left, right))
            old_poses = self.trajectory_dev
            with profiling.span("slam.optimize", poses=self.graph.count,
                                loop_edges=self.graph.n_loops):
                self.trajectory_dev = self.graph.optimize(old_poses, mesh=self.mesh)
            with profiling.span("slam.corrected_carry", frame=frame_idx):
                self._carry = corrected_carry(self._carry, self.trajectory_dev, old_poses,
                                              right, self.grid_pts, self.grid_mask, cfg, rgb,
                                              self._kf_shard)
            self.loop_events.append(LoopEvent(cand.query, cand.match, cand.n_inliers))

        self.frame_count += 1
        with profiling.span("host_read", site="slam.frame_info"):
            n_trk, n_inl, is_kf, ok, retry = torch.stack(
                [s.long() for s in (stats.n_tracked, stats.n_inliers, stats.is_keyframe,
                                    stats.tracking_ok, stats.used_retry)]).tolist()
            T_wc_host = self._carry.T_wc.cpu().numpy()
        info = FrameInfo(frame=frame_idx, T_wc=T_wc_host, n_tracked=n_trk,
                         n_inliers=n_inl, is_keyframe=bool(is_kf) or cand is not None,
                         tracking_ok=bool(ok), used_retry=bool(retry))
        if info.is_keyframe:
            self.keyframe_frames.append(frame_idx)
        if not info.tracking_ok:
            self.tracking_failed = True
        return info

    # -- outputs -----------------------------------------------------------

    def _shard_store(self) -> None:
        """Keep only this rank's slots of the carry's (whole) store."""
        if self.mesh is not None:
            self._carry = self._carry._replace(
                keyframes=dist_map.shard_keyframes(self.mesh, self._carry.keyframes))

    def _writes_files(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def trajectory_array(self) -> np.ndarray:
        return self.trajectory_dev[: self.frame_count].cpu().numpy()

    @property
    def keyframes(self):
        """The whole keyframe store (gathered over the mesh's ranks)."""
        kf = self._carry.keyframes
        return kf if self.mesh is None else dist_map.gather_keyframes(self.mesh, kf)

    def map_points(self) -> tuple[np.ndarray, np.ndarray]:
        return map_points_of(self.keyframes)

    def save_graph(self, path: str) -> None:
        if self._writes_files():
            self.graph.save(path, self.trajectory_array())

    def save_map(self, path: str) -> int:
        """Write the map as PLY (rank 0 under a mesh); returns its points."""
        from ros_stereo_slam_tpu_torch.utils import ply

        pts, cols = self.map_points()
        if self._writes_files():
            ply.save_ply(path, pts, cols)
        return len(pts)

    # -- checkpoint / resume (the reference saves artifacts, never resumes) --

    def _state_tree(self) -> dict:
        g = self.graph
        tree = {
            "carry": self._carry._replace(keyframes=self.keyframes),
            "traj": self.trajectory_dev,
            "graph": {"odo_Z": g.odo_Z, "loop_i": g.loop_i, "loop_j": g.loop_j,
                      "loop_Z": g.loop_Z, "loop_valid": g.loop_valid},
        }
        if self.detector is not None:
            tree["det"] = self.detector.lc
        return tree

    def save_checkpoint(self, path: str) -> None:
        """Under a mesh the checkpoint holds the whole map (rank 0 writes it,
        the others wait), so it loads into a mesh of any size or into one
        device."""
        from ros_stereo_slam_tpu_torch.utils import checkpoint

        d = self.detector
        meta = {
            "frame_count": self.frame_count,
            "cooldown": self.cooldown,
            "graph_count": self.graph.count,
            "n_loops": self.graph.n_loops,
            "keyframe_frames": self.keyframe_frames,
            "loop_events": [[e.query, e.match, e.n_inliers] for e in self.loop_events],
            "window": [[int(x) for x in w] for w in (d._gater._window if d else [])],
            "has_last": bool(d and d.has_last),
            "tracking_failed": self.tracking_failed,
        }
        tree = self._state_tree()
        if self._writes_files():
            checkpoint.save_pytree(path, tree, meta)
        if self.mesh is not None:
            barrier(self.mesh)

    def load_checkpoint(self, path: str) -> None:
        """Restore into an object built with the SAME config and vocabulary
        and ``initialize``d once (which gives the tensors' shapes)."""
        from ros_stereo_slam_tpu_torch.utils import checkpoint

        tree, meta = checkpoint.load_pytree(path, self._state_tree())
        self._carry = tree["carry"]
        self._shard_store()
        self.trajectory_dev = tree["traj"]
        g = self.graph
        for name, t in tree["graph"].items():
            setattr(g, name, t)
        g.count, g.n_loops = meta["graph_count"], meta["n_loops"]
        if self.detector is not None:
            self.detector.lc = tree["det"]
            self.detector.has_last = meta["has_last"]
            self.detector._gater._window = [tuple(w) for w in meta["window"]]
        self.frame_count = meta["frame_count"]
        self.cooldown = meta["cooldown"]
        self.keyframe_frames = list(meta["keyframe_frames"])
        self.loop_events = [LoopEvent(*e) for e in meta["loop_events"]]
        self.tracking_failed = meta["tracking_failed"]
