"""State carried across between the JAX package and this port.

The system has no weights; what it carries is the SLAM state: the JAX
package's ``SlamCarry`` and ``LCScanState`` (after ``jax.device_get``:
NamedTuples of numpy arrays) become this package's and back, its
``Vocabulary`` (or the npz it saves) becomes a port vocabulary, so both
packages can descend the same tree and query the same database, and its
streaming ``LoopDetector`` and ``PoseGraph`` become the port's.  Inputs
are read by field name only, so this module needs nothing of JAX.

The random key maps to the port's integer ``key`` as the 64-bit number of
its two uint32 words and back.  The port's random streams are its own, so
a converted carry continues the same trajectory up to the RANSAC draws.

Lane-stacked trees (the reference's ``vmap(init_carry)`` and its batched
database) carry over as they are: every field keeps its leading lane
axis, the (B, 2) keys become a tuple of B ints and the lanes' common
frame index one int, as :func:`.step.init_carry_batched` makes them.  A
carry's BA window (``ba``, present under ``preset_ba()``) crosses field
by field, its frame count an int32 tensor on both sides.
"""

from __future__ import annotations

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.config import LoopClosureConfig, PGOConfig
from ros_stereo_slam_tpu_torch.models.loop_closure import LoopDetector
from ros_stereo_slam_tpu_torch.models.pose_graph import PoseGraph
from ros_stereo_slam_tpu_torch.models.slam_scan import LCScanState
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore, TrackState
from ros_stereo_slam_tpu_torch.models.step import BAState, SlamCarry
from ros_stereo_slam_tpu_torch.models.vocab import Vocabulary


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def carry_from_numpy(tree, device: torch.device | str) -> SlamCarry:
    """JAX ``SlamCarry`` of numpy arrays (one lane, or lane-stacked) -> port
    ``SlamCarry`` on `device`."""
    words = np.asarray(tree.key, dtype=np.uint64)
    if words.ndim not in (1, 2) or words.shape[-1] != 2:
        raise ValueError(f"expected uint32[2] PRNG keys, got shape {words.shape}")
    keys = tuple((int(w[0]) << 32) | int(w[1]) for w in words.reshape(-1, 2))
    frame_idx = np.unique(np.asarray(tree.frame_idx))
    if frame_idx.size != 1:
        raise ValueError(f"lanes on different frames {frame_idx}: the port steps them in lockstep")
    tr, kf = tree.track, tree.keyframes
    return SlamCarry(
        track=TrackState(*(_t(getattr(tr, f), device) for f in TrackState._fields)),
        T_wc=_t(tree.T_wc, device),
        keyframes=KeyframeStore(*(_t(getattr(kf, f), device)
                                  for f in KeyframeStore._fields)),
        ref_pyr=tuple(_t(level, device) for level in tree.ref_pyr),
        key=keys if words.ndim == 2 else keys[0],
        frame_idx=int(frame_idx[0]),
        dT=_t(tree.dT, device),
        dT_valid=_t(tree.dT_valid, device),
        stereo_flow=_t(tree.stereo_flow, device),
        ba=(None if getattr(tree, "ba", None) is None
            else BAState(*(_t(getattr(tree.ba, f), device) for f in BAState._fields))),
    )


def carry_to_numpy(carry: SlamCarry) -> SlamCarry:
    """Port ``SlamCarry`` -> the same fields as numpy arrays, in the JAX
    package's dtypes (``key`` as uint32[2], ``frame_idx`` as int32; a
    lane-stacked carry gives (B, 2) keys and (B,) frame indices)."""

    def n(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    lanes = isinstance(carry.key, tuple)
    keys = carry.key if lanes else (carry.key,)
    key = np.array([[(k >> 32) & 0xFFFFFFFF, k & 0xFFFFFFFF] for k in keys], dtype=np.uint32)

    return SlamCarry(
        track=TrackState(*(n(x) for x in carry.track)),
        T_wc=n(carry.T_wc),
        keyframes=KeyframeStore(*(n(x) for x in carry.keyframes)),
        ref_pyr=tuple(n(level) for level in carry.ref_pyr),
        key=key if lanes else key[0],
        frame_idx=(np.full(len(keys), carry.frame_idx, np.int32) if lanes
                   else np.int32(carry.frame_idx)),
        dT=n(carry.dT),
        dT_valid=n(carry.dT_valid),
        stereo_flow=n(carry.stereo_flow),
        ba=None if carry.ba is None else BAState(*(n(x) for x in carry.ba)),
    )


def vocab_from_numpy(src, device: torch.device | str) -> Vocabulary:
    """A vocabulary of the JAX package -> port :class:`~.vocab.Vocabulary`.

    `src` is a path to the npz that ``Vocabulary.save`` (or the bench's
    vocabulary cache) writes, or any object with ``k``, ``levels``,
    ``centers`` (per-level (k^(l+1), 256) sign arrays) and ``idf``.
    """
    if isinstance(src, (str, os.PathLike)):
        return Vocabulary.load(os.fspath(src), device)
    return Vocabulary(
        k=int(src.k), levels=int(src.levels),
        centers=[torch.from_numpy(np.asarray(c).astype(np.int8)).to(device)
                 for c in src.centers],
        idf=torch.from_numpy(np.asarray(src.idf, dtype=np.float32).copy()).to(device),
    )


def lc_state_from_numpy(tree, device: torch.device | str) -> LCScanState:
    """JAX ``LCScanState`` of numpy arrays (one lane, or lane-stacked) ->
    port ``LCScanState``.

    The packed descriptors keep their bits (uint32 -> int32); the bf16
    bins go through float32, which holds every bf16 value exactly.
    """
    def conv(name):
        a = np.asarray(getattr(tree, name))
        if name == "db_bits":
            return torch.from_numpy(a.astype(np.uint32).view(np.int32).copy()).to(device)
        if name == "db_bins":
            return torch.from_numpy(a.astype(np.float32)).to(device).to(torch.bfloat16)
        return _t(a, device)

    return LCScanState(*(conv(f) for f in LCScanState._fields))


def lc_state_to_numpy(lc: LCScanState) -> LCScanState:
    """Port ``LCScanState`` -> numpy arrays in the JAX package's dtypes,
    except ``db_bins``, which comes back as float32 (numpy has no bf16)."""
    def conv(name, t):
        if name == "db_bits":
            return t.cpu().numpy().view(np.uint32)
        if name == "db_bins":
            return t.to(torch.float32).cpu().numpy()
        return t.cpu().numpy()

    return LCScanState(*(conv(f, getattr(lc, f)) for f in LCScanState._fields))


def _config_of(cls, cfg):
    """A config dataclass of the JAX package -> the port's copy of it."""
    return cls(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cls)})


def detector_from_numpy(det, vocab: Vocabulary, device: torch.device | str) -> LoopDetector:
    """The JAX package's streaming ``LoopDetector`` -> port
    :class:`~.loop_closure.LoopDetector` on `device`: its database through
    :func:`lc_state_from_numpy`, its previous frame's BoW (``_last``, None
    before the first add) and its gates' temporal window."""
    nf = np.asarray(det.db_words).shape[-1]
    last = det._last
    db = {f: getattr(det, f) for f in LCScanState._fields if f.startswith("db_")}
    db.update(
        last_words=np.zeros(nf, np.int32) if last is None else np.asarray(last[0], np.int32),
        last_wvals=np.zeros(nf, np.float32) if last is None else np.asarray(last[1]),
        have_last=np.bool_(last is not None),
    )
    out = LoopDetector(vocab, _config_of(LoopClosureConfig, det.config), device,
                       lc=lc_state_from_numpy(SimpleNamespace(**db), device))
    out._gater._window = [tuple(int(x) for x in w) for w in det._gater._window]
    return out


def graph_from_numpy(g, device: torch.device | str) -> PoseGraph:
    """The JAX package's ``PoseGraph`` (its arrays as they are, or numpy) ->
    port :class:`~.pose_graph.PoseGraph` on `device`."""
    out = PoseGraph(_config_of(PGOConfig, g.config), device)
    out.odo_Z = _t(np.asarray(g.odo_Z, np.float32), device)
    out.loop_i = _t(np.asarray(g.loop_i, np.int32), device)
    out.loop_j = _t(np.asarray(g.loop_j, np.int32), device)
    out.loop_Z = _t(np.asarray(g.loop_Z, np.float32), device)
    out.loop_valid = _t(np.asarray(g.loop_valid, bool), device)
    out.count, out.n_loops = int(g.count), int(g.n_loops)
    return out
