"""BoW loop-closure gates and the geometric check.

Port of the parts of ``ros_stereo_slam_tpu/models/loop_closure.py`` that
the scan epilogue runs: the pair-derived random streams (:func:`geom_key`,
:func:`edge_key`), the brute-force Hamming matching + ratio test +
F-RANSAC check (:func:`_geom_match`, :func:`_geom_match_many`), island
grouping and the nss / alpha / island / temporal gate chain
(:class:`CandidateGater`, host logic copied as it is).  The streaming
``LoopDetector`` is not ported yet.

Pair keys (ROADMAP H1): each (query, match) pair gets its own
``torch.Generator``, seeded from (77, query, match) for the geometric
check and (4321, query, match) for the PnP loop edge, so verification is
a pure function of the pair and the database, as in the reference.  The
draws are not JAX's; tests inject JAX-drawn index sets instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import LoopClosureConfig
from ros_stereo_slam_tpu_torch.models.step import _generator
from ros_stereo_slam_tpu_torch.ops import orb as orb_mod
from ros_stereo_slam_tpu_torch.ops import ransac
from ros_stereo_slam_tpu_torch.ops.topk import top_k

_GEOM_SEED = 77
_EDGE_SEED = 4321


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
