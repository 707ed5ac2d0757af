"""Full SLAM online in chunks: micro-batches of frames, corrected between
chunks.

Port of ``ros_stereo_slam_tpu/models/slam_chunked.py``.  Frames run
through the scan posture's frame loop (:func:`.slam_scan.run_sequence_slam`
with the chunk's ``fid_start``) in chunks of `chunk` frames; between
chunks the host replays the gates over the chunk's shortlists
(:class:`.slam_scan.EpilogueGater`, stateful across chunks), verifies and
measures the accepted closures, and applies the reference's correction to
the LIVE carry (:func:`.slam.corrected_carry`: full-graph PGO, the
keyframe map rewrite, a re-bootstrap at the optimized pose), so tracking
after a closure continues in the corrected frame.

Speculation (:func:`run_online_slam`): chunk k+1 is dispatched from the
uncorrected post-k state before chunk k is gated; on an accepted closure
the driver rolls back to chunk k's post-state, corrects it and dispatches
k+1 again.  The step writes the keyframe ring and the detection writes
the database IN PLACE, so a dispatch made while an earlier chunk is still
to be gated runs on copies of both (:meth:`ChunkedSLAM.begin_chunk`):
chunk k's post-state stays what the sequential driver
(:meth:`ChunkedSLAM.process_chunk` in a loop) would hold, and the two
drivers are bitwise equal.  The BA window (``cfg.ba_enabled``) is never
written in place, so it needs no copy.  Each frame step reads the device
twice, so the host cannot run ahead of the card: here speculation only
reorders work.  RGB frames (``rgb0``, ``rgbs``, ``rgb_seq``) colour the
keyframes; a correction colours its re-bootstrap from the chunk's last
RGB frame.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import slam_scan, step as step_mod
from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
from ros_stereo_slam_tpu_torch.models.pipeline import _grid_for, _stage, map_points_of, rgb_frame
from ros_stereo_slam_tpu_torch.models.pose_graph import PoseGraph
from ros_stereo_slam_tpu_torch.models.slam import corrected_carry
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore
from ros_stereo_slam_tpu_torch.utils import profiling


class ChunkInfo(NamedTuple):
    """Per-chunk outputs (host numpy) of :meth:`ChunkedSLAM.finish_chunk`."""

    T_wc: np.ndarray  # (C, 4, 4) live poses of this chunk's frames
    n_tracked: np.ndarray  # (C,)
    n_inliers: np.ndarray  # (C,)
    is_keyframe: np.ndarray  # (C,)
    tracking_ok: np.ndarray  # (C,)
    n_accepted: int  # closures accepted at this chunk boundary
    corrected: bool  # whether a PGO correction was applied


class PendingChunk(NamedTuple):
    """A dispatched chunk still to be gated (:meth:`ChunkedSLAM.begin_chunk`),
    consumed IN ORDER by :meth:`ChunkedSLAM.finish_chunk`: its post-chunk
    state (the correction starts from it even after later chunks were
    dispatched), its stats on the device and its staged frames."""

    pos: int  # frame id of row 0
    n: int  # frames in this chunk
    carry_after: step_mod.SlamCarry
    lc_after: slam_scan.LCScanState
    fstats: step_mod.FrameStats
    lstats: slam_scan.LCScanStats
    lefts: torch.Tensor
    rights: torch.Tensor
    rgbs: torch.Tensor | None  # (n, H, W, 3) or None


@dataclass
class ChunkedSlamResult:
    trajectory: np.ndarray  # (F, 4, 4) live trajectory (corrected online)
    loop_events: list  # [(query, match, n_inliers)]
    n_corrections: int  # PGO solves applied to the live state
    n_inliers: np.ndarray
    is_keyframe: np.ndarray
    tracking_ok: np.ndarray
    keyframes: KeyframeStore
    n_chunks: int


def _copy(tree):
    return type(tree)(*(t.clone() for t in tree))


@dataclass
class ChunkedSLAM:
    """Incremental chunked online SLAM on `device` (module docstring)::

        slam = ChunkedSLAM(cfg, vocab, device="cuda")
        slam.initialize(left0, right0)
        for lefts, rights in blocks:  # (C, H, W) each, frames 1, 2, ...
            slam.process_chunk(lefts, rights)
        traj = slam.trajectory_array()
    """

    config: PipelineConfig
    vocab: vocab_mod.Vocabulary
    device: torch.device | str = "cuda"
    frame_count: int = field(init=False, default=0)

    def __post_init__(self):
        cfg = self.config
        self.grid_pts, self.grid_mask = _grid_for(cfg, self.device)
        self._tree = self.vocab.packed().to(self.device)
        self._idf = self.vocab.idf.to(self.device)
        self._carry = None
        self._lc = None
        self.graph = PoseGraph(cfg.pgo, self.device)
        self.trajectory_dev = torch.eye(4, dtype=torch.float32,
                                        device=self.device).repeat(cfg.pgo.max_poses, 1, 1)
        self.gate = slam_scan.EpilogueGater(cfg)
        self.loop_events: list = []
        self.n_corrections = 0
        self._n_inl, self._is_kf, self._ok = [], [], []

    def initialize(self, left0, right0, rgb0=None) -> None:
        """Frame 0: the bootstrap (coloured from `rgb0` (H, W, 3), if given)
        and frame 0's database row."""
        cfg = self.config
        l0, r0 = _stage(left0, self.device), _stage(right0, self.device)
        self._carry = step_mod.init_carry(l0, r0, self.grid_pts, self.grid_mask, cfg.seed, cfg,
                                          rgb_frame(rgb0, self.device))
        self._lc, _ = slam_scan._lc_scan_step(
            slam_scan.init_lc_state(cfg, self.vocab.n_words, self.device), l0, 0, self._tree,
            self._idf, cfg, self.vocab.k)
        self.graph.initialize()
        self._prev_T = self._carry.T_wc
        self.frame_count = 1
        self._disp_pos = 1  # the dispatch frontier: ahead of frame_count under speculation
        self._in_flight = 0  # chunks dispatched and not yet gated

    def begin_chunk(self, lefts, rights, rgbs=None) -> PendingChunk:
        """Run one chunk's frames from the dispatch frontier.

        May be called again before :meth:`finish_chunk` (speculation): the
        next chunk starts from this one's post-state.  A later
        ``finish_chunk`` that corrects invalidates every chunk begun after
        the corrected one; the frontier rolls back, and the caller must
        begin them again (:func:`run_online_slam`).  `rgbs` (C, H, W, 3),
        if given, colours the chunk's keyframes.
        """
        cfg = self.config
        pos = self._disp_pos
        ls, rs = _stage(lefts, self.device), _stage(rights, self.device)
        rgb = rgb_frame(rgbs, self.device)
        carry, lc = self._carry, self._lc
        if self._in_flight:
            # An earlier chunk may still roll back to this post-state: the
            # frames below write their keyframes and database rows into
            # copies of it.
            carry = carry._replace(keyframes=_copy(carry.keyframes))
            lc = _copy(lc)
        (carry, lc), (fstats, lstats) = slam_scan.run_sequence_slam(
            ls, rs, carry, lc, self.grid_pts, self.grid_mask, self._tree, self._idf, cfg,
            self.vocab.k, fid_start=pos, rgb_seq=rgb)
        self._carry, self._lc = carry, lc
        self._disp_pos = pos + ls.shape[0]
        self._in_flight += 1
        return PendingChunk(pos=pos, n=ls.shape[0], carry_after=carry, lc_after=lc,
                            fstats=fstats, lstats=lstats, lefts=ls, rights=rs, rgbs=rgb)

    def finish_chunk(self, pending: PendingChunk, query_frames=None) -> ChunkInfo:
        """Gate and commit one dispatched chunk (in order).

        On an accepted closure the live carry is corrected FROM THIS
        CHUNK'S post-state and the dispatch frontier rolls back to it: any
        chunk begun after this one is invalid and must be begun again.
        `query_frames`: callable ``fid -> (left, right)`` device frames for
        the PnP loop edges (default: this chunk's frames).
        """
        cfg = self.config
        pos, n = pending.pos, pending.n
        fs, ls = pending.fstats, pending.lstats
        with profiling.span("host_read", site="chunked.stats"):
            T_np, n_trk, n_inl, is_kf, ok = (x.cpu().numpy() for x in (
                fs.T_wc, fs.n_tracked, fs.n_inliers, fs.is_keyframe, fs.tracking_ok))
            top_ids, top_scores, ns = (x.cpu().numpy() for x in ls)
        self._in_flight -= 1
        self._n_inl.append(n_inl)
        self._is_kf.append(is_kf)
        self._ok.append(ok)
        # odometry edges: the measured relative motions prev^-1 cur
        chain = np.concatenate([self._prev_T.cpu().numpy()[None], T_np], axis=0)
        self.graph.add_odometry_batch(
            np.einsum("fij,fjk->fik", np.linalg.inv(chain[:-1]), chain[1:]))
        self.trajectory_dev[pos:pos + n] = torch.from_numpy(T_np).to(self.device)
        self._prev_T = pending.carry_after.T_wc
        self.frame_count = pos + n

        accepted = self.gate.process(pending.lc_after, top_ids, top_scores, ns, fid_start=pos)
        if accepted:
            if query_frames is None:
                def query_frames(fid):
                    return pending.lefts[fid - pos], pending.rights[fid - pos]
            events, edges = slam_scan.measure_loop_edges(accepted, pending.lc_after,
                                                         query_frames, cfg)
            self.loop_events.extend(events)
            for i, j, Z in edges:
                self.graph.add_loop(i, j, Z)
            old_poses = self.trajectory_dev
            with profiling.span("slam.optimize", poses=self.graph.count,
                                loop_edges=self.graph.n_loops):
                self.trajectory_dev = self.graph.optimize(old_poses)
            with profiling.span("slam.corrected_carry", frame=pos + n - 1):
                self._carry = self._corrected_carry(
                    pending.carry_after, self.trajectory_dev, old_poses, pending.rights[-1],
                    None if pending.rgbs is None else pending.rgbs[-1])
            # roll the frontier back to this (corrected) chunk boundary
            self._lc = pending.lc_after
            self._disp_pos = pos + n
            self._in_flight = 0
            self._prev_T = self._carry.T_wc
            self.n_corrections += 1
        return ChunkInfo(T_wc=T_np, n_tracked=n_trk, n_inliers=n_inl, is_keyframe=is_kf,
                         tracking_ok=ok, n_accepted=len(accepted), corrected=bool(accepted))

    def process_chunk(self, lefts, rights, rgbs=None, query_frames=None) -> ChunkInfo:
        """One chunk, sequentially: ``finish_chunk(begin_chunk(...))``."""
        return self.finish_chunk(self.begin_chunk(lefts, rights, rgbs=rgbs),
                                 query_frames=query_frames)

    def _corrected_carry(self, carry, new_poses, old_poses, right_img, rgb_img=None):
        """The PGO result applied to a post-chunk carry at its last frame."""
        return corrected_carry(carry, new_poses, old_poses, right_img, self.grid_pts,
                               self.grid_mask, self.config, rgb_img)

    # -- outputs -----------------------------------------------------------

    def trajectory_array(self) -> np.ndarray:
        return self.trajectory_dev[: self.frame_count].cpu().numpy()

    @property
    def keyframes(self) -> KeyframeStore:
        return self._carry.keyframes

    def map_points(self) -> tuple[np.ndarray, np.ndarray]:
        return map_points_of(self._carry.keyframes)

    def save_graph(self, path: str) -> None:
        self.graph.save(path, self.trajectory_array())

    def result(self, n_chunks: int = 0) -> ChunkedSlamResult:
        def cat(parts, dtype):
            return np.concatenate(parts) if parts else np.zeros((0,), dtype)

        return ChunkedSlamResult(
            trajectory=self.trajectory_array(), loop_events=self.loop_events,
            n_corrections=self.n_corrections, n_inliers=cat(self._n_inl, np.int64),
            is_keyframe=cat(self._is_kf, bool), tracking_ok=cat(self._ok, bool),
            keyframes=self._carry.keyframes, n_chunks=n_chunks,
        )


def run_online_slam(cfg: PipelineConfig, vocab: vocab_mod.Vocabulary, left_seq, right_seq,
                    chunk: int = 32, device: torch.device | str = "cuda",
                    rgb_seq=None) -> ChunkedSlamResult:
    """Online full SLAM over a sequence in `chunk`-frame chunks, speculatively
    (module docstring): chunk k+1 is dispatched before chunk k is gated, and
    again from the corrected state when chunk k accepts a closure.

    left_seq/right_seq: (F, H, W) float32 or uint8 stacks (frame 0
    included), numpy arrays or tensors, staged on `device` once; uint8
    stays uint8 and is scaled per frame.  The last chunk may be shorter.
    `rgb_seq` ((F, H, W, 3) float32 or uint8, optional) colours the
    keyframes.
    """
    left, right = _stage(left_seq, device), _stage(right_seq, device)
    rgb = rgb_frame(rgb_seq, device)
    F = left.shape[0]
    slam = ChunkedSLAM(cfg, vocab, device)
    slam.initialize(left[0], right[0], None if rgb is None else rgb[0])

    def begin(pos):
        return slam.begin_chunk(left[pos:pos + chunk], right[pos:pos + chunk],
                                None if rgb is None else rgb[pos:pos + chunk])

    n_chunks = 0
    pending = begin(1) if F > 1 else None
    while pending is not None:
        next_pos = pending.pos + pending.n
        pend_next = begin(next_pos) if next_pos < F else None  # speculative
        info = slam.finish_chunk(pending, query_frames=lambda fid: (left[fid], right[fid]))
        if info.corrected and pend_next is not None:
            pend_next = begin(next_pos)  # the frontier rolled back: run it again
        n_chunks += 1
        pending = pend_next
    return slam.result(n_chunks=n_chunks)
