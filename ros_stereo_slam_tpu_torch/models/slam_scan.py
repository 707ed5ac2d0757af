"""Full SLAM (config 3): odometry with in-loop loop detection, then the
host epilogue.

Port of the single-lane path of ``ros_stereo_slam_tpu/models/slam_scan.py``.
Where the reference is one jitted ``lax.scan``, this is a Python loop over
frames staged on the device, as :func:`.pipeline.run_offline` is:

- each frame runs :func:`.step.slam_frame_step`, then, on every
  ``detect_every``-th frame, :func:`_lc_scan_step`: ORB (kernel K2), the
  vocabulary descent of ORB's packed words (kernel K3, every level in one
  launch, over the tree packed once per run by
  :meth:`.vocab.Vocabulary.packed`), the sparse BoW, the binned
  shortlist and its exact rescore, and the database insert.
  ``lax.cond`` on the cadence becomes a host branch on the frame id, which
  the host knows, so it reads nothing from the device;
- the sparse database (:class:`LCScanState`, ~130 MB at the reference
  scale) stays on the device and is written IN PLACE, one ring row per
  detection frame (the reference's scan carry copies nothing either);
- the per-frame stats stay on the device and are read once after the loop;
- the epilogue replays the gates on the host (:class:`EpilogueGater`),
  verifies the surviving candidates, measures PnP loop edges, solves one
  pose graph and rewrites the keyframe map.

Batched lanes (:func:`run_offline_slam_batched`): B sequences step in
lockstep through :mod:`.step_batched`, and every detection frame runs
:func:`_lc_scan_step` once for all lanes (ORB's K2b and the descent's K3
launched once for every lane), each lane writing its own database row in
place.  The interleaved cadence (``interleave=True``) shifts lane b's
detection to frames with ``fid % detect_every == lane_phase(b, ...)``:
each such frame runs the single-lane step (K2, K3) for each lane whose
phase it is, on views of that lane's database
(:func:`_lc_scan_step_lane`).  Every driver takes RGB frames (``rgb_seq``,
``rgb_seqs``) that colour the keyframes, and runs BA when
``cfg.ba_enabled`` (config 4), through the step.  The online postures, per frame
(:mod:`.slam`) and in chunks (:mod:`.slam_chunked`), run the same
detection and the same epilogue pieces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.models import frontend
from ros_stereo_slam_tpu_torch.models import loop_closure as lc_mod
from ros_stereo_slam_tpu_torch.models import pose_graph as pg_mod
from ros_stereo_slam_tpu_torch.models import step as step_mod
from ros_stereo_slam_tpu_torch.models import step_batched
from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
from ros_stereo_slam_tpu_torch.ops import lk, orb as orb_mod, pnp, pyramid, triangulate
from ros_stereo_slam_tpu_torch.utils import lie, profiling


LCScanState = lc_mod.LCScanState


class LCScanStats(NamedTuple):
    """Per-frame candidate shortlist (the host gates run on these)."""

    top_ids: torch.Tensor  # (K,) int32 database frame ids (-1 padding)
    top_scores: torch.Tensor  # (K,) f32 exact min-intersection scores
    ns: torch.Tensor  # () f32 score against the previous detected frame


def init_lc_state(cfg: PipelineConfig, n_words: int | None = None,
                  device: torch.device | str = "cuda", lanes: int | None = None) -> LCScanState:
    """An empty database on `device` (one per lane with `lanes`).  `n_words`
    (the vocabulary's size, the reference's second argument) does not
    shape the sparse database and is not read."""
    return lc_mod.empty_database(cfg.loop, device, lanes)


def _top_k_count(lcc) -> int:
    """Top-K emitted per frame: no more than the shortlist or the database."""
    return min(lcc.max_db_results, lcc.shortlist, lcc.db_capacity)


def _null_stats(cfg: PipelineConfig, device, lead: tuple = ()) -> LCScanStats:
    k = _top_k_count(cfg.loop)
    return LCScanStats(
        top_ids=torch.full(lead + (k,), -1, dtype=torch.int32, device=device),
        top_scores=torch.full(lead + (k,), -1e9, dtype=torch.float32, device=device),
        ns=torch.full(lead, -1.0, dtype=torch.float32, device=device),
    )


def _lc_scan_step(
    lc: LCScanState,
    left_img: torch.Tensor,
    frame_id: int,
    tree: vocab_mod.PackedTree,
    idf: torch.Tensor,
    cfg: PipelineConfig,
    vocab_k: int,
) -> tuple[LCScanState, LCScanStats]:
    """One detection frame: ORB -> sparse BoW -> query -> database insert.

    `tree` is the vocabulary packed by :func:`.vocab.pack_centers`, the
    counterpart of the reference's int8 `centers`: the descent reads ORB's
    packed words and validity, which give the reference's word ids.

    The database rows of ring slot ``frame_id % db_capacity`` are written
    in place; the returned state shares the input's tensors.

    Lane form: (B, H, W) frames against a lane-stacked database (one
    detection per lane, all lanes on frame `frame_id`); every lane writes
    its own row, and the stats gain a leading lane axis.
    """
    with profiling.span("detect.frame", frame=frame_id, lanes=left_img.shape[0]
                        if left_img.dim() == 3 else 1):
        left_img = step_mod._to_unit(left_img).contiguous()
        lcc = cfg.loop
        with profiling.span("detect.orb"):
            feats = orb_mod.detect_and_compute(
                left_img, lcc.orb_features, cfg.frontend.fast_thresh / 255.0,
                n_levels=lcc.orb_levels,
            )
        with profiling.span("detect.bow"):
            uw, uv = lc_mod.bow_of(feats, tree, idf, vocab_k)
            q_bins = vocab_mod.bin_of_sparse(uw, uv, lcc.n_bins)
        with profiling.span("detect.query"):
            ns = vocab_mod.score_pair_min(uw, uv, lc.last_words, lc.last_wvals)
            top_ids, top_scores = lc_mod._query_scores(
                uw, uv, q_bins, lc.db_words, lc.db_wvals, lc.db_bins, lc.db_valid,
                frame_id - lcc.dislocal - 1, lc.db_ids, _top_k_count(lcc), lcc.shortlist)
        # The reference masks ns with `have_last` AFTER setting it, so a
        # detection frame always reports the raw score (0 on the first
        # frame); only skipped frames carry ns = -1 (_null_stats).
        stats = LCScanStats(top_ids=top_ids, top_scores=top_scores, ns=ns)
        with profiling.span("detect.insert"):
            return lc_mod._db_insert(lc, frame_id, feats, uw, uv, q_bins), stats


def _stack(rows: list):
    return type(rows[0])(*(torch.stack(f) for f in zip(*rows)))


def run_sequence_slam(
    left_seq: torch.Tensor,  # (F, H, W) f32 or uint8 — frames 1..F
    right_seq: torch.Tensor,
    carry: step_mod.SlamCarry,
    lc: LCScanState,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    tree: vocab_mod.PackedTree,
    idf: torch.Tensor,
    cfg: PipelineConfig,
    vocab_k: int,
    fid_start: int = 1,
    rgb_seq: torch.Tensor | None = None,  # (F, H, W, 3) f32 or uint8
):
    """Odometry + detection over a staged sequence (`tree`: the packed
    vocabulary, :meth:`.vocab.Vocabulary.packed`); `fid_start` is the frame
    id of row 0 (the chunked driver runs a sequence in blocks); `rgb_seq`
    colours the keyframes.

    Returns ((carry, lc), (frame stats, detection stats)), each stats
    tuple stacked along frames and left on the device.
    """
    return _run_frames(left_seq, right_seq, rgb_seq, carry, lc, grid_pts, grid_mask, cfg,
                       step_mod.slam_frame_step,
                       _detect_lockstep(tree, idf, cfg, vocab_k,
                                        _null_stats(cfg, left_seq.device)),
                       fid_start)


def _run_frames(frames_l, frames_r, frames_rgb, carry, lc, grid_pts, grid_mask,
                cfg: PipelineConfig, frame_step, detect, fid_start: int = 1):
    """The frame loop of the drivers: `frame_step` on every frame, then
    ``detect(lc, left, fid) -> (lc, stats)``.  frames_l[i] is frame
    fid_start + i (of every lane); `frames_rgb` is None or its RGB frames."""
    fstats, lstats = [], []
    for i in range(frames_l.shape[0]):
        fid = fid_start + i
        carry, fs = frame_step(carry, frames_l[i], frames_r[i], grid_pts, grid_mask, cfg,
                               None if frames_rgb is None else frames_rgb[i])
        lc, ls = detect(lc, frames_l[i], fid)
        fstats.append(fs)
        lstats.append(ls)
    if not fstats:
        raise ValueError("the SLAM drivers need at least one frame after frame 0")
    return (carry, lc), (_stack(fstats), _stack(lstats))


def _detect_lockstep(tree, idf, cfg: PipelineConfig, vocab_k: int, null: LCScanStats):
    """Detection on every ``detect_every``-th frame, for all lanes at once
    (`null` stats on the others).  ``lax.cond`` on the cadence becomes a
    host branch on the frame id, which the host knows."""
    every = max(cfg.loop.detect_every, 1)

    def detect(lc, left, fid):
        if fid % every:
            return lc, null
        return _lc_scan_step(lc, left, fid, tree, idf, cfg, vocab_k)

    return detect


def lane_phase(lane: int, every: int) -> int:
    """Detection phase of a lane under the interleaved batched cadence:
    lane b detects on frames with ``fid % every == lane_phase(b, every)``
    (single-lane and lockstep runs use phase 0)."""
    return lane % max(every, 1)


def _lc_scan_step_lane(lc: LCScanState, lane: int, left_img: torch.Tensor, frame_id: int,
                       tree: vocab_mod.PackedTree, idf: torch.Tensor, cfg: PipelineConfig,
                       vocab_k: int) -> tuple[LCScanState, LCScanStats]:
    """One LANE's detection step against the lane-stacked database.

    The single-lane :func:`_lc_scan_step` runs on views of lane `lane`, so
    its ring-row insert lands in the lane-stacked tensors in place; only
    the previous-frame fields are written back into the lane.  A lane's
    database (about 135 MB at the reference scale) is never copied.
    `left_img` is the lane's (H, W) frame; the stats have no lane axis.
    """
    new, stats = _lc_scan_step(_lane(lc, lane), left_img, frame_id, tree, idf, cfg, vocab_k)

    def put(x, row):
        x = x.clone()  # the lane-stacked previous-frame fields are small
        x[lane] = row
        return x

    return lc._replace(last_words=put(lc.last_words, new.last_words),
                       last_wvals=put(lc.last_wvals, new.last_wvals),
                       have_last=put(lc.have_last, new.have_last)), stats


def _detect_interleaved(tree, idf, cfg: PipelineConfig, vocab_k: int, null: LCScanStats):
    """Detection of the lanes whose phase is ``fid % detect_every``, one
    lane at a time (:func:`_lc_scan_step_lane`); the other lanes get their
    row of the (B, ...) `null` stats."""
    every = max(cfg.loop.detect_every, 1)

    def detect(lc, left, fid):
        rows = []
        for b in range(left.shape[0]):
            if lane_phase(b, every) == fid % every:
                lc, row = _lc_scan_step_lane(lc, b, left[b], fid, tree, idf, cfg, vocab_k)
            else:
                row = _lane(null, b)
            rows.append(row)
        return lc, _stack(rows)

    return detect


def _interleaved(interleave: bool, lanes: int, cfg: PipelineConfig) -> bool:
    """Whether `interleave` changes the cadence: it needs several lanes and
    a stride (with ``detect_every`` 1 every lane detects every frame)."""
    return interleave and lanes > 1 and max(cfg.loop.detect_every, 1) > 1


def run_sequence_slam_batched(
    left_seq: torch.Tensor,  # (B, F, H, W) f32 or uint8 — frames 1..F per lane
    right_seq: torch.Tensor,
    carry: step_mod.SlamCarry,
    lc: LCScanState,
    grid_pts: torch.Tensor,
    grid_mask: torch.Tensor,
    tree: vocab_mod.PackedTree,
    idf: torch.Tensor,
    cfg: PipelineConfig,
    vocab_k: int,
    rgb_seq: torch.Tensor | None = None,  # (B, F, H, W, 3) f32 or uint8
    fid_start: int = 1,
    interleave: bool = False,
):
    """B lanes of odometry + detection: the batched step, and on every
    ``detect_every``-th frame one lane-form :func:`_lc_scan_step` for all
    lanes (the reference's lockstep cadence), or with `interleave` each
    lane's detection on its own phase of the stride (:func:`lane_phase`).

    `carry` from :func:`.step.init_carry_batched`, `lc` from
    ``init_lc_state(..., lanes=B)``; `fid_start` is the frame id of row 0.
    Returns ((carry, lc), (frame stats, detection stats)), the stats
    frame-major, (F, B, ...), as the reference's scan gives them.
    """
    B = left_seq.shape[0]
    null = _null_stats(cfg, left_seq.device, (B,))
    detect = (_detect_interleaved if _interleaved(interleave, B, cfg)
              else _detect_lockstep)(tree, idf, cfg, vocab_k, null)
    return _run_frames(left_seq.transpose(0, 1), right_seq.transpose(0, 1),
                       None if rgb_seq is None else rgb_seq.transpose(0, 1), carry, lc,
                       grid_pts, grid_mask, cfg, step_batched.slam_frame_step_batched, detect,
                       fid_start)


class EpilogueGater:
    """Replays the gate chain over per-frame candidate rows (host numpy).

    nss / alpha / island / temporal gates (:class:`loop_closure.
    CandidateGater`), the separation rule (query - match > min_separation),
    the geometric check, then the cooldown.  The geometric check runs
    before the cooldown is armed: a candidate that fails geometry does not
    suppress the following frames.  Stateful across calls, so one instance
    can process a sequence in blocks.

    Detection frames are those with ``fid % detect_every == phase`` (a
    lane's :func:`lane_phase` under the interleaved cadence, else 0).
    `key` is accepted as the reference accepts it and not read: the
    geometric check draws from each pair's :func:`loop_closure.geom_key`.
    """

    def __init__(self, cfg: PipelineConfig, key=None, phase: int = 0):
        del key
        self.cfg = cfg
        self.lcc = cfg.loop
        self.every = max(cfg.loop.detect_every, 1)
        self.phase = phase % self.every
        self.gater = lc_mod.CandidateGater(cfg.loop, stride=self.every)
        self.cooldown = 0

    def process(self, lc: LCScanState, top_ids, top_scores, ns_arr, fid_start: int) -> list:
        """Gate one block of per-frame shortlists; `fid_start` is the frame
        id of row 0.  Returns accepted closures as (fid, match_id, best_idx,
        inlier_mask, n_inliers).

        Pass 1 runs the host gates over every detection frame in order;
        pass 2 verifies all survivors on the device and reads the verdicts
        once; pass 3 replays the cooldown over them.  The accept set is the
        sequential one: a candidate inside a cooldown window is never
        accepted, and one that fails geometry arms no cooldown.
        """
        lcc = self.lcc
        n = top_ids.shape[0]
        suppress_until = fid_start + self.cooldown - 1
        cands = []
        with profiling.span("epilogue.gates", frames=n) as sp:
            for i in range(n):
                fid = fid_start + i
                if fid % self.every != self.phase or fid <= lcc.dislocal:
                    continue
                gated = self.gater.gate(fid, top_ids[i], top_scores[i], float(ns_arr[i]))
                if gated is None or fid <= suppress_until:
                    continue
                best_id = gated[0]
                if fid - best_id <= lcc.min_separation:
                    continue
                cands.append((fid, best_id))
            sp.set(candidates=len(cands))

        accepted = []
        if cands:
            with profiling.span("epilogue.geom", candidates=len(cands)) as sp:
                n_inl_d, bi_d, im_d = lc_mod._geom_match_many(
                    lc.db_bits, lc.db_pts, lc.db_pt_valid,
                    [q for q, _ in cands], [m for _, m in cands],
                    lcc.geom_thresh_px, lcc.neigh_ratio, iters=lcc.geom_ransac_iters,
                )
                with profiling.span("host_read", site="epilogue.geom"):
                    n_inl_b, bi_b, im_b = (t.cpu().numpy() for t in (n_inl_d, bi_d, im_d))
                for ci, (fid, best_id) in enumerate(cands):
                    if fid <= suppress_until or int(n_inl_b[ci]) < lcc.geom_min_points:
                        continue
                    suppress_until = fid + lcc.cooldown
                    accepted.append((fid, best_id, bi_b[ci], im_b[ci], int(n_inl_b[ci])))
                sp.set(accepted=len(accepted))
        self.cooldown = max(0, suppress_until - (fid_start + n - 1))
        return accepted


def _edges_pnp_batch(lq, rq, db_pts, db_pt_valid, best_idx, inl_mask, q_fids, m_fids,
                     cfg: PipelineConfig):
    """PnP loop-edge measurements of accepted closures.

    Per closure: the query pair's full pyramids, left->right LK,
    stereo triangulation, then PnP of the matched frame's 2D observations
    against the query's 3D points, with the pair's :func:`edge_key`
    generator.  Returns device tensors (n_inliers (P,), T_q_match (P, 4, 4)).
    """
    cam = step_mod._cam_of(cfg)
    cap = cfg.loop.db_capacity
    n_ok, Ts = [], []
    for l1, r1, bi, im, qf, mf in zip(lq, rq, best_idx, inl_mask, q_fids, m_fids):
        l1, r1 = step_mod._to_unit(l1), step_mod._to_unit(r1)
        lp = tuple(pyramid.build_pyramid(l1, cfg.frontend.lk_levels))
        rp = tuple(pyramid.build_pyramid(r1, cfg.frontend.lk_levels))
        qs, ms = int(qf) % cap, int(mf) % cap
        pts_q = db_pts[qs]
        st = lk.track(lp, rp, pts_q, None, frontend._lk_params(cfg.frontend))
        tri = triangulate.triangulate_rectified(
            cam, float(cfg.camera.baseline), pts_q, st.points,
            db_pt_valid[qs] & st.valid, max_depth=cfg.keyframes.max_depth,
        )
        uv_m = db_pts[ms][bi]
        res = pnp.pnp_ransac(
            lc_mod.edge_key(qf, mf, l1.device), cam, tri.points, uv_m, im & tri.valid,
            thresh_px=cfg.loop.geom_thresh_px, iters=128,
            refine_iters=cfg.pnp.refine_iters,
            T_init=torch.eye(4, dtype=torch.float32, device=l1.device),
        )
        n_ok.append(res.n_inliers)
        Ts.append(lie.inv_se3(res.T_cw))
    return torch.stack(n_ok), torch.stack(Ts)


def _measure_edges_pnp(lc_arrays, cands, geom, frame_of, cfg: PipelineConfig):
    """PnP-measured loop edges Z = T_q^-1 T_match for accepted candidates,
    None where PnP starves (the caller then uses the identity edge)."""
    db_pts, db_pt_valid = lc_arrays
    _, best_idx, inl_mask = geom
    if not cands:
        return []
    frames = [frame_of(q) for q, _ in cands]
    dev = db_pts.device
    n_ok, Ts = _edges_pnp_batch(
        [f[0] for f in frames], [f[1] for f in frames], db_pts, db_pt_valid,
        torch.as_tensor(np.asarray(best_idx), device=dev),
        torch.as_tensor(np.asarray(inl_mask), device=dev),
        [q for q, _ in cands], [m for _, m in cands], cfg,
    )
    with profiling.span("host_read", site="epilogue.edges"):
        n_ok, Ts = n_ok.cpu().numpy(), Ts.cpu().numpy()
    return [Ts[ci] if int(n_ok[ci]) >= cfg.loop.geom_min_points else None
            for ci in range(len(cands))]


def measure_loop_edges(accepted: list, lc: LCScanState, frame_of,
                       cfg: PipelineConfig, key=None) -> tuple[list, list]:
    """Accepted closures -> (loop events, (i, j, Z) pose-graph edges).

    PnP-measured edges when configured; otherwise, or where PnP starves,
    the reference's identity edge to the vertex before the match.
    `frame_of`: callable ``fid -> (left, right)`` frames.  `key` is
    accepted as the reference accepts it and not read: each pair draws
    from its own :func:`loop_closure.edge_key`.
    """
    del key
    loop_events, loop_edges = [], []
    if not accepted:
        return loop_events, loop_edges
    with profiling.span("epilogue.edges", closures=len(accepted)) as sp:
        if cfg.loop.edge_measurement == "pnp":
            sel = [(q, m) for q, m, _, _, _ in accepted]
            geom = (np.asarray([a[4] for a in accepted]),
                    np.stack([a[2] for a in accepted]),
                    np.stack([a[3] for a in accepted]))
            Zs = _measure_edges_pnp((lc.db_pts, lc.db_pt_valid), sel, geom, frame_of, cfg)
        else:
            Zs = [None] * len(accepted)
        for (q, m, _, _, n_inl), Z in zip(accepted, Zs):
            loop_events.append((q, m, n_inl))
            if Z is None:
                loop_edges.append((q, max(m - 1, 0), np.eye(4)))
            else:
                loop_edges.append((q, m, Z))
        sp.set(measured=sum(Z is not None for Z in Zs))
    return loop_events, loop_edges


@dataclass
class ScanSlamResult:
    trajectory: np.ndarray  # (F, 4, 4) post-PGO world-from-cam
    trajectory_odo: np.ndarray  # (F, 4, 4) raw odometry chain
    loop_events: list  # [(query, match, n_inliers)]
    n_inliers: np.ndarray
    is_keyframe: np.ndarray
    tracking_ok: np.ndarray
    keyframes: object
    loop_edges: list = None  # accepted (i, j, Z) pose-graph loop edges


def _epilogue_one(cfg: PipelineConfig, lc, top_ids, top_scores, ns, fstats, keyframes,
                  frame_of, phase: int = 0) -> ScanSlamResult:
    """Host epilogue: gates -> geometric check -> accept -> PnP loop edges
    -> one PGO -> keyframe map rewrite.  `fstats` holds host arrays;
    `phase` is the lane's detection phase (:class:`EpilogueGater`)."""
    with profiling.span("epilogue") as sp:
        traj_odo = np.concatenate([np.eye(4, dtype=np.float32)[None],
                                   np.asarray(fstats.T_wc)], axis=0)
        gate = EpilogueGater(cfg, phase=phase)
        accepted = gate.process(lc, top_ids, top_scores, ns, fid_start=1)
        loop_events, loop_edges = measure_loop_edges(accepted, lc, frame_of, cfg)
        sp.set(closures=len(loop_events))

        trajectory = traj_odo
        if loop_edges:
            dev = keyframes.points.device
            with profiling.span("epilogue.pgo", poses=traj_odo.shape[0],
                                loop_edges=len(loop_edges)):
                poses = torch.from_numpy(traj_odo).to(dev)
                lZ = torch.from_numpy(np.stack([Z for _, _, Z in loop_edges]).astype(np.float32))
                opt = pg_mod.optimize(
                    poses, traj_odo.shape[0], pg_mod.chain_measurements(poses),
                    torch.tensor([i for i, _, _ in loop_edges], device=dev),
                    torch.tensor([j for _, j, _ in loop_edges], device=dev),
                    lZ.to(dev), torch.ones((len(loop_edges),), dtype=torch.bool, device=dev),
                    iters=cfg.pgo.iters, cg_iters=cfg.pgo.cg_iters, damping=cfg.pgo.damping,
                )
                with profiling.span("host_read", site="epilogue.pgo"):
                    trajectory = opt.cpu().numpy()
            # Post-PGO map consistency (the reference's updateOdometry): every
            # keyframe cloud is re-expressed at its optimized pose.
            with profiling.span("epilogue.rewrite"):
                fi = keyframes.frame_idx.to(torch.int64)
                keyframes = keyframes._replace(
                    points=pg_mod.rewrite_points(keyframes.points, keyframes.frame_idx, poses, opt),
                    poses=opt[fi],
                    retrack=keyframes.retrack | keyframes.valid,
                )
        return ScanSlamResult(
            trajectory=trajectory, trajectory_odo=traj_odo, loop_events=loop_events,
            n_inliers=np.asarray(fstats.n_inliers), is_keyframe=np.asarray(fstats.is_keyframe),
            tracking_ok=np.asarray(fstats.tracking_ok), keyframes=keyframes,
            loop_edges=loop_edges,
        )


def _lane(tree, b: int):
    """Lane b of a lane-stacked NamedTuple of tensors (views)."""
    return type(tree)(*(x[b] for x in tree))


def run_offline_slam_batched(cfg: PipelineConfig, vocab: vocab_mod.Vocabulary, left_seqs,
                             right_seqs, device: torch.device | str = "cuda", rgb_seqs=None,
                             interleave: bool = False) -> list[ScanSlamResult]:
    """Batched full SLAM over B sequences: the batched bootstrap, one
    lockstep loop of odometry + detection for all lanes, then the host
    epilogue per lane.  Returns one :class:`ScanSlamResult` per lane.

    left_seqs/right_seqs: (B, F, H, W) float32 or uint8 stacks (frame 0
    included), numpy arrays or tensors, staged on `device` once.  Lane b
    starts from key ``step_batched.lane_keys(cfg.seed, B)[b]``.  The
    database is one per lane (about 135 MB each at the reference scale).
    `rgb_seqs` ((B, F, H, W, 3) float32 or uint8, optional) colours each
    lane's keyframes.  `interleave=True` shifts lane b's detection frames
    to ``fid % detect_every == lane_phase(b, detect_every)``.
    """
    from ros_stereo_slam_tpu_torch.models.pipeline import _grid_for, _stage, rgb_frame

    with profiling.span("driver.session", driver="run_offline_slam_batched",
                        frames=left_seqs.shape[1], lanes=left_seqs.shape[0]):
        step_batched.check_batched(cfg)
        grid_pts, grid_mask = _grid_for(cfg, device)
        left, right = _stage(left_seqs, device), _stage(right_seqs, device)
        rgb = rgb_frame(rgb_seqs, device)
        B = left.shape[0]
        tree, idf = vocab.packed().to(device), vocab.idf.to(device)
        carry = step_mod.init_carry_batched(left[:, 0], right[:, 0], grid_pts, grid_mask,
                                            step_batched.lane_keys(cfg.seed, B), cfg,
                                            None if rgb is None else rgb[:, 0])
        # frame 0 enters every lane's database, whatever its phase
        lc, _ = _lc_scan_step(init_lc_state(cfg, vocab.n_words, device, lanes=B), left[:, 0], 0,
                              tree, idf, cfg, vocab.k)
        (carry, lc), (fstats, lstats) = run_sequence_slam_batched(
            left[:, 1:], right[:, 1:], carry, lc, grid_pts, grid_mask, tree, idf, cfg, vocab.k,
            None if rgb is None else rgb[:, 1:], interleave=interleave)
        with profiling.span("host_read", site="slam.stats"):
            fstats_h = step_mod.FrameStats(*(f.cpu().numpy() for f in fstats))
            top_ids, top_scores, ns = (x.cpu().numpy() for x in lstats)
        every = max(cfg.loop.detect_every, 1)
        return [
            _epilogue_one(cfg, _lane(lc, b), top_ids[:, b], top_scores[:, b], ns[:, b],
                          step_mod.FrameStats(*(f[:, b] for f in fstats_h)),
                          _lane(carry.keyframes, b),
                          lambda fid, b=b: (left[b, fid], right[b, fid]),
                          phase=lane_phase(b, every) if _interleaved(interleave, B, cfg) else 0)
            for b in range(B)
        ]


def run_offline_slam(cfg: PipelineConfig, vocab: vocab_mod.Vocabulary, left_seq, right_seq,
                     device: torch.device | str = "cuda", rgb_seq=None) -> ScanSlamResult:
    """Full SLAM over a sequence: bootstrap, the frame loop, the epilogue.

    left_seq/right_seq: (F, H, W) float32 or uint8 stacks (frame 0
    included), numpy arrays or tensors, staged on `device` once; `vocab`'s
    packed tree (built once per vocabulary) and weights are moved there.
    `rgb_seq` ((F, H, W, 3) float32 or uint8, optional) colours the
    keyframe map points, as in :func:`.pipeline.run_offline`.
    """
    from ros_stereo_slam_tpu_torch.models.pipeline import _grid_for, _stage, rgb_frame

    with profiling.span("driver.session", driver="run_offline_slam", frames=len(left_seq),
                        lanes=1):
        grid_pts, grid_mask = _grid_for(cfg, device)
        left, right = _stage(left_seq, device), _stage(right_seq, device)
        rgb = rgb_frame(rgb_seq, device)
        tree, idf = vocab.packed().to(device), vocab.idf.to(device)
        carry = step_mod.init_carry(left[0], right[0], grid_pts, grid_mask, cfg.seed, cfg,
                                    None if rgb is None else rgb[0])
        # frame 0 enters the database too (0 % detect_every == 0)
        lc, _ = _lc_scan_step(init_lc_state(cfg, vocab.n_words, device), left[0], 0, tree, idf,
                              cfg, vocab.k)
        (carry, lc), (fstats, lstats) = run_sequence_slam(
            left[1:], right[1:], carry, lc, grid_pts, grid_mask, tree, idf, cfg, vocab.k,
            rgb_seq=None if rgb is None else rgb[1:])
        with profiling.span("host_read", site="slam.stats"):
            fstats_h = step_mod.FrameStats(*(f.cpu().numpy() for f in fstats))
            top_ids, top_scores, ns = (x.cpu().numpy() for x in lstats)
        return _epilogue_one(cfg, lc, top_ids, top_scores, ns, fstats_h, carry.keyframes,
                             lambda fid: (left[fid], right[fid]))
