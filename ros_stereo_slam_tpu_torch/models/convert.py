"""State carried across between the JAX package and this port.

The system has no weights; what it carries is the SLAM state.  The JAX
package's ``SlamCarry`` (after ``jax.device_get``: NamedTuples of numpy
arrays) becomes this package's :class:`~.step.SlamCarry` and back.  The
input is read by field name only, so this module needs nothing of JAX.

The random key maps to the port's integer ``key`` as the 64-bit number of
its two uint32 words and back.  The port's random streams are its own, so
a converted carry continues the same trajectory up to the RANSAC draws.
"""

from __future__ import annotations

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.models.state import KeyframeStore, TrackState
from ros_stereo_slam_tpu_torch.models.step import SlamCarry


def _t(a, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def carry_from_numpy(tree, device: torch.device | str) -> SlamCarry:
    """JAX ``SlamCarry`` of numpy arrays -> port ``SlamCarry`` on `device`."""
    if getattr(tree, "ba", None) is not None:
        raise NotImplementedError("a carry with BA state is not ported")
    words = np.asarray(tree.key, dtype=np.uint64).ravel()
    if words.shape != (2,):
        raise ValueError(f"expected a uint32[2] PRNG key, got shape {words.shape}")
    tr, kf = tree.track, tree.keyframes
    return SlamCarry(
        track=TrackState(*(_t(getattr(tr, f), device) for f in TrackState._fields)),
        T_wc=_t(tree.T_wc, device),
        keyframes=KeyframeStore(*(_t(getattr(kf, f), device)
                                  for f in KeyframeStore._fields)),
        ref_pyr=tuple(_t(level, device) for level in tree.ref_pyr),
        key=(int(words[0]) << 32) | int(words[1]),
        frame_idx=int(tree.frame_idx),
        dT=_t(tree.dT, device),
        dT_valid=_t(tree.dT_valid, device),
        stereo_flow=_t(tree.stereo_flow, device),
    )


def carry_to_numpy(carry: SlamCarry) -> SlamCarry:
    """Port ``SlamCarry`` -> the same fields as numpy arrays, in the JAX
    package's dtypes (``key`` as uint32[2], ``frame_idx`` as int32)."""

    def n(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    return SlamCarry(
        track=TrackState(*(n(x) for x in carry.track)),
        T_wc=n(carry.T_wc),
        keyframes=KeyframeStore(*(n(x) for x in carry.keyframes)),
        ref_pyr=tuple(n(level) for level in carry.ref_pyr),
        key=np.array([(carry.key >> 32) & 0xFFFFFFFF, carry.key & 0xFFFFFFFF],
                     dtype=np.uint32),
        frame_idx=np.int32(carry.frame_idx),
        dT=n(carry.dT),
        dT_valid=n(carry.dT_valid),
        stereo_flow=n(carry.stereo_flow),
    )
