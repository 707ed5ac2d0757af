"""BoW loop closure: the sparse database, its query, the gates, the
geometric check and the streaming detector.

Port of ``ros_stereo_slam_tpu/models/loop_closure.py``: the pair-derived
random streams (:func:`geom_key`, :func:`edge_key`), the database of
:class:`LCScanState` (a ring of sparse BoW rows, binned histograms and
packed descriptors on the device, written in place by :func:`_db_insert`)
and its query (:func:`_query_scores`: binned shortlist, exact
min-intersection rescore), the brute-force Hamming matching + ratio test
+ F-RANSAC check (:func:`_geom_match`, :func:`_geom_match_many`), island
grouping and the nss / alpha / island / temporal gate chain
(:class:`CandidateGater`, host logic copied as it is), and the streaming
:class:`LoopDetector`.  The scan step (``slam_scan._lc_scan_step``), the
streaming detector and the chunked driver share one query and one insert.

Pair keys (ROADMAP H1): each (query, match) pair gets its own
``torch.Generator``, seeded from (77, query, match) for the geometric
check and (4321, query, match) for the PnP loop edge, so verification is
a pure function of the pair and the database, as in the reference.  The
draws are not JAX's; tests inject JAX-drawn index sets instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import LoopClosureConfig
from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
from ros_stereo_slam_tpu_torch.models.step import _generator
from ros_stereo_slam_tpu_torch.ops import orb as orb_mod
from ros_stereo_slam_tpu_torch.ops import ransac, vocab_cuda
from ros_stereo_slam_tpu_torch.ops.topk import top_k
from ros_stereo_slam_tpu_torch.utils import profiling

_GEOM_SEED = 77
_EDGE_SEED = 4321


class LCScanState(NamedTuple):
    """Device-resident sparse BoW database (a ring of `db_capacity` frames);
    batched lanes stack one database per lane on a leading axis."""

    db_words: torch.Tensor  # (cap, nf) int32 merged word ids (0-padded)
    db_wvals: torch.Tensor  # (cap, nf) f32 L1-normalized TF-IDF weights
    db_bins: torch.Tensor  # (cap, n_bins) bf16 binned BoW (shortlist matvec)
    db_bits: torch.Tensor  # (cap, nf, 8) int32 packed descriptors (uint32 bits)
    db_pts: torch.Tensor  # (cap, nf, 2) f32
    db_pt_valid: torch.Tensor  # (cap, nf) bool
    db_valid: torch.Tensor  # (cap,) bool
    db_ids: torch.Tensor  # (cap,) int32
    last_words: torch.Tensor  # (nf,) int32 previous detected frame's BoW
    last_wvals: torch.Tensor  # (nf,) f32
    have_last: torch.Tensor  # () bool


def empty_database(lcc: LoopClosureConfig, device, lanes: int | None = None) -> LCScanState:
    """An empty database on `device` (one per lane with `lanes`)."""
    cap, nf = lcc.db_capacity, lcc.orb_features
    ln = () if lanes is None else (lanes,)

    def z(shape, dtype):
        return torch.zeros(ln + shape, dtype=dtype, device=device)

    return LCScanState(
        db_words=z((cap, nf), torch.int32),
        db_wvals=z((cap, nf), torch.float32),
        db_bins=z((cap, lcc.n_bins), torch.bfloat16),
        db_bits=z((cap, nf, orb_mod.N_BITS // 32), torch.int32),
        db_pts=z((cap, nf, 2), torch.float32),
        db_pt_valid=z((cap, nf), torch.bool),
        db_valid=z((cap,), torch.bool),
        db_ids=torch.full(ln + (cap,), -1, dtype=torch.int32, device=device),
        last_words=z((nf,), torch.int32),
        last_wvals=z((nf,), torch.float32),
        have_last=z((), torch.bool),
    )


def bow_of(feats: orb_mod.OrbFeatures, tree: vocab_mod.PackedTree, idf: torch.Tensor,
           vocab_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """ORB features -> sparse BoW (uwords, uvals).  ORB's packed words and
    validity descend the packed vocabulary in one launch of kernel K3 for
    every descriptor (of every lane, for (B, N) features)."""
    words = vocab_cuda.descend(feats.desc_bits.reshape(-1, orb_mod.N_BITS // 32),
                               feats.valid.reshape(-1), tree, vocab_k,
                               tree.levels).reshape(feats.valid.shape)
    return vocab_mod.bow_sparse(words, feats.valid, idf, idf.shape[0])


def _query_scores(uw, uv, q_bins, db_words, db_wvals, db_bins, db_valid, max_id: int,
                  db_ids, top_k_n: int, shortlist: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The database query: the binned shortlist over entries dated
    <= `max_id`, then the exact min-intersection rescore.  Returns (top ids
    (-1 where no entry), top exact scores (-1e9 there)), top_k_n of them at
    most; lane form with a leading lane axis on every input."""
    sdot = vocab_mod.score_db_binned(q_bins, db_bins)
    ok = db_valid & (db_ids <= max_id)
    sdot = torch.where(ok, sdot, torch.full_like(sdot, -1e9))
    C = min(shortlist, db_words.shape[-2])
    sl_scores, sl_idx = top_k(sdot, C)
    rows = sl_idx[..., None]  # each lane's shortlisted database rows
    s_ex = vocab_mod.rescore_min(uw, uv, torch.take_along_dim(db_words, rows, dim=-2),
                                 torch.take_along_dim(db_wvals, rows, dim=-2))
    s_ex = torch.where(sl_scores > -1e8, s_ex, torch.full_like(s_ex, -1e9))
    scores, ti = top_k(s_ex, min(top_k_n, C))
    ids = torch.where(scores > -1e8, db_ids.gather(-1, sl_idx.gather(-1, ti)),
                      torch.full_like(scores, -1, dtype=torch.int32))
    return ids, scores


def _db_insert(lc: LCScanState, frame_id: int, feats: orb_mod.OrbFeatures, uw, uv,
               q_bins) -> LCScanState:
    """Write the frame into ring slot ``frame_id % capacity`` IN PLACE (every
    lane its own row under a lane axis) and make it the previous frame.
    The returned state shares the input's database tensors."""
    slot = frame_id % lc.db_ids.shape[-1]
    ring = lc.db_ids.dim() - 1  # the ring axis: 0, or 1 under a lane axis
    for field, row in ((lc.db_words, uw), (lc.db_wvals, uv), (lc.db_bins, q_bins),
                       (lc.db_bits, feats.desc_bits), (lc.db_pts, feats.pts),
                       (lc.db_pt_valid, feats.valid)):
        field.select(ring, slot).copy_(row)
    lc.db_valid.select(ring, slot).fill_(True)
    lc.db_ids.select(ring, slot).fill_(frame_id)
    return lc._replace(last_words=uw.to(torch.int32), last_wvals=uv,
                       have_last=torch.ones_like(lc.have_last))


def geom_key(query: int, match: int, device) -> torch.Generator:
    """Generator for geometrically verifying the (query, match) pair."""
    return _generator(_GEOM_SEED, int(query), int(match), device)


def edge_key(query: int, match: int, device) -> torch.Generator:
    """Generator for the PnP loop-edge measurement of the pair."""
    return _generator(_EDGE_SEED, int(query), int(match), device)


def _ratio_matches(bits_q, valid_q, bits_m, valid_m, ratio: float):
    """Nearest match of every query descriptor and the two ratio gates.

    Returns (best (N,) int64, good (N,) bool at `ratio`, loose (N,) bool
    at 0.85).  Among equal distances the lowest index is the nearest.
    """
    ham = orb_mod.hamming_mxu(orb_mod.sign_of_packed(bits_q), orb_mod.sign_of_packed(bits_m))
    ham = torch.where(valid_m[None, :], ham, torch.full_like(ham, 1e9))
    neg2, idx2 = top_k(-ham, 2)  # two smallest distances per row
    d1, d2 = -neg2[:, 0], -neg2[:, 1]
    good = valid_q & (d1 < ratio * d2) & (d1 < 1e8)
    loose = valid_q & (d1 < 0.85 * d2) & (d1 < 1e8)
    return idx2[:, 0], good, loose


def _geom_from_sets(idx, pts_q, m_pts, good, loose, thresh_px: float):
    """F-RANSAC on given (K, 8) minimal sets over the ratio matches.

    Returns (n_inliers, measurement mask): every loose-ratio match that the
    verified F supports feeds the PnP loop edge.
    """
    res = ransac._fmat_from_sets(idx, pts_q, m_pts, good, thresh_px=thresh_px)
    return res.n_inliers, loose & (res.errors < thresh_px * thresh_px)


def _geom_match(bits_q, pts_q, valid_q, bits_m, pts_m, valid_m, gen: torch.Generator,
                thresh_px: float, ratio: float, iters: int = 256):
    """Brute-force descriptor matching + ratio test + F-RANSAC.

    Inputs are packed (N, 8) descriptors.  Returns (n_inliers,
    best_match_idx (N,), measurement mask (N,)).
    """
    best, good, loose = _ratio_matches(bits_q, valid_q, bits_m, valid_m, ratio)
    idx = ransac._sample_minimal_sets(gen, good, iters, 8)
    n_inl, meas = _geom_from_sets(idx, pts_q, pts_m[best], good, loose, thresh_px)
    return n_inl, best, meas


def _geom_match_many(db_bits, db_pts, db_pt_valid, q_fids, m_fids, thresh_px: float,
                     ratio: float, iters: int = 256):
    """:func:`_geom_match` over (query, match) frame-id pairs of the ring
    database, each with its own pair generator.  Returns stacked device
    tensors (n_inliers (P,), best (P, N), mask (P, N))."""
    cap = db_bits.shape[0]
    outs = []
    for qf, mf in zip(q_fids, m_fids):
        qs, ms = int(qf) % cap, int(mf) % cap
        outs.append(_geom_match(
            db_bits[qs], db_pts[qs], db_pt_valid[qs],
            db_bits[ms], db_pts[ms], db_pt_valid[ms],
            geom_key(qf, mf, db_bits.device), thresh_px, ratio, iters=iters))
    return tuple(torch.stack(x) for x in zip(*outs))


def group_islands(ids: np.ndarray, scores: np.ndarray):
    """Group candidate entries into islands of near-consecutive ids.

    Entries sorted by id, split when the id gap exceeds 3; island score =
    sum; representative = argmax entry.  Returns a list of
    ``[sum_score, best_id, best_score, lo, hi]``.
    """
    order = np.argsort(ids)
    islands = []
    cur = None
    for i in order:
        if ids[i] < 0:
            continue
        if cur is not None and ids[i] - cur[4] <= 3:
            cur[0] += scores[i]
            cur[4] = ids[i]
            if scores[i] > cur[2]:
                cur[1], cur[2] = ids[i], scores[i]
        else:
            if cur is not None:
                islands.append(cur)
            cur = [scores[i], ids[i], scores[i], ids[i], ids[i]]
    if cur is not None:
        islands.append(cur)
    return islands


class CandidateGater:
    """The nss / alpha / island / temporal-window gate chain.

    ``stride`` widens the island-gap and temporal-window tolerances when
    detection runs every Nth frame (``detect_every``).
    """

    def __init__(self, config: LoopClosureConfig, stride: int = 1):
        self.config = config
        self.stride = max(int(stride), 1)
        self._window: list[tuple[int, int, int]] = []  # (query, isl_lo, isl_hi)

    def gate(self, frame_id: int, ids: np.ndarray, scores: np.ndarray, ns: float):
        """Per-frame gates over the top-K database results.

        Returns (best_id, best_score, consistent) for a candidate that passed
        nss + alpha + islands + temporal consistency, else None.  Call it for
        every detected frame in order (it threads the temporal window).
        """
        cfg = self.config
        gap = 3 * self.stride
        if not (ns >= cfg.min_nss and scores.size and scores[0] > 0):
            self._window.append((frame_id, -10 * gap, -10 * gap))
            self._window = self._window[-8:]
            return None
        nss = scores / max(ns, 1e-6)
        keep = (nss >= cfg.alpha) & (scores > -1e8)
        islands = group_islands(ids[keep], nss[keep])
        if not islands:
            self._window.append((frame_id, -10 * gap, -10 * gap))
            self._window = self._window[-8:]
            return None
        best = max(islands, key=lambda g: g[0])
        _, best_id, best_score, lo, hi = best
        consistent = 0
        for (q, plo, phi) in reversed(self._window):
            if frame_id - q > gap:
                break
            if lo <= phi + gap and hi >= plo - gap:
                consistent += 1
                lo = min(lo, plo)
                hi = max(hi, phi)
            else:
                break
        self._window.append((frame_id, best[3], best[4]))
        self._window = self._window[-8:]
        if consistent >= cfg.k_consistency:
            return int(best_id), float(best_score), consistent
        return None


@dataclass
class LoopCandidate:
    query: int
    match: int
    score: float
    n_inliers: int
    consistent: int  # temporal-consistency count at acceptance
    # Geometric-check correspondences (query feature -> match feature) for
    # the PnP loop edge.
    match_idx: np.ndarray | None = None  # (N,) int
    match_inliers: np.ndarray | None = None  # (N,) bool


@dataclass
class LoopDetector:
    """Streaming detector over the scan posture's database (:class:`LCScanState`
    on `device`, written in place).  `lc` starts a detector from an existing
    database (``convert.detector_from_numpy``)."""

    vocab: vocab_mod.Vocabulary
    config: LoopClosureConfig
    device: torch.device | str = "cuda"
    lc: LCScanState | None = None

    def __post_init__(self):
        self._tree = self.vocab.packed().to(self.device)
        self._idf = self.vocab.idf.to(self.device)
        if self.lc is None:
            self.lc = empty_database(self.config, self.device)
        # the host's copy of lc.have_last: the query needs a previous frame
        self.has_last = bool(self.lc.have_last)
        # the stride widens the island / temporal tolerances when detection
        # runs every Nth frame, as in the scan epilogue
        self._gater = CandidateGater(self.config, stride=max(self.config.detect_every, 1))

    # The reference's database attributes, read-only views of `lc`.
    db_words = property(lambda self: self.lc.db_words)
    db_wvals = property(lambda self: self.lc.db_wvals)
    db_bins = property(lambda self: self.lc.db_bins)
    db_bits = property(lambda self: self.lc.db_bits)
    db_pts = property(lambda self: self.lc.db_pts)
    db_pt_valid = property(lambda self: self.lc.db_pt_valid)
    db_valid = property(lambda self: self.lc.db_valid)
    db_ids = property(lambda self: self.lc.db_ids)

    def _bow_of(self, feats: orb_mod.OrbFeatures):
        return bow_of(feats, self._tree, self._idf, self.vocab.k)

    def add(self, frame_id: int, feats: orb_mod.OrbFeatures, bow=None) -> None:
        """Insert the frame's BoW and features into the database."""
        if bow is None:
            with profiling.span("detect.bow"):
                bow = self._bow_of(feats)
        uw, uv = bow
        with profiling.span("detect.insert"):
            self.lc = _db_insert(self.lc, frame_id, feats, uw, uv,
                                 vocab_mod.bin_of_sparse(uw, uv, self.config.n_bins))
        self.has_last = True

    def detect(self, frame_id: int, feats: orb_mod.OrbFeatures) -> LoopCandidate | None:
        """Query the database with the frame, gate, verify the geometry of a
        survivor, then add the frame to the database."""
        cfg, lc = self.config, self.lc
        with profiling.span("detect.bow"):
            uw, uv = self._bow_of(feats)
        result = None
        if self.has_last and frame_id > cfg.dislocal:
            with profiling.span("detect.query"):
                ns = vocab_mod.score_pair_min(uw, uv, lc.last_words, lc.last_wvals)
                ids, scores = _query_scores(
                    uw, uv, vocab_mod.bin_of_sparse(uw, uv, cfg.n_bins), lc.db_words,
                    lc.db_wvals, lc.db_bins, lc.db_valid, frame_id - cfg.dislocal - 1,
                    lc.db_ids, cfg.max_db_results, cfg.shortlist)
                with profiling.span("host_read", site="detect.query"):
                    ns, ids, scores = float(ns), ids.cpu().numpy(), scores.cpu().numpy()
                gated = self._gater.gate(frame_id, ids, scores, ns)
            # the separation rule: a candidate failing it is never accepted,
            # so it gets no geometric check
            if gated is not None and gated[0] < frame_id - cfg.min_separation:
                best_id, best_score, consistent = gated
                slot = best_id % cfg.db_capacity
                with profiling.span("detect.geom"):
                    n_inl, best, meas = _geom_match(
                        feats.desc_bits, feats.pts, feats.valid, lc.db_bits[slot],
                        lc.db_pts[slot], lc.db_pt_valid[slot],
                        geom_key(frame_id, best_id, lc.db_bits.device),
                        cfg.geom_thresh_px, cfg.neigh_ratio, iters=cfg.geom_ransac_iters)
                    with profiling.span("host_read", site="detect.geom"):
                        n_inl = int(n_inl)
                        if n_inl >= cfg.geom_min_points:
                            result = LoopCandidate(
                                query=frame_id, match=best_id, score=best_score,
                                n_inliers=n_inl, consistent=consistent,
                                match_idx=best.cpu().numpy(), match_inliers=meas.cpu().numpy())
        self.add(frame_id, feats, (uw, uv))
        return result
