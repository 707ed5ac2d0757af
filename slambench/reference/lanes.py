"""The lanes of a lane driver: the same recorded drive at another exposure.

Lane b of a session sees each 8-bit value `v` of the mix's frames as
``round(v * num / den)`` for its gain ``GAINS[b] = (num, den)``, halves
rounded up, through a 256-entry table, as a camera set to a shorter
exposure records the same scene.  Lane 0 is the frames as rendered.  The
ground truth is every lane's.
"""

from __future__ import annotations

import torch

GAINS = ((1, 1), (17, 20))  # lane 0 as rendered; lane 1 at 0.85


def table(lane: int) -> torch.Tensor:
    """(256,) uint8: the value lane `lane` records for each 8-bit value."""
    num, den = GAINS[lane]
    v = torch.arange(256, dtype=torch.int64)
    return ((v * num + den // 2) // den).to(torch.uint8)


def lane_frames(frames, lane: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """(F, H, W) uint8 frames (a tensor, or a numpy array) as lane `lane`
    records them, on the frames' device (into `out` where given)."""
    frames = torch.as_tensor(frames)
    out = torch.empty_like(frames) if out is None else out
    num, den = GAINS[lane]
    if num == den:
        return out.copy_(frames)
    tab = table(lane).to(frames.device)
    for f in range(frames.shape[0]):  # a frame at a time: the indices are int64
        out[f] = tab[frames[f].long()]
    return out


def stacks(frames, lanes: int) -> torch.Tensor:
    """(lanes, F, H, W) uint8: every lane's copy of (F, H, W) frames."""
    frames = torch.as_tensor(frames)
    out = torch.empty((lanes, *frames.shape), dtype=frames.dtype, device=frames.device)
    for b in range(lanes):
        lane_frames(frames, b, out[b])
    return out


class Frames:
    """One lane's (F, H, W) uint8 left and right frames."""

    def __init__(self, left: torch.Tensor, right: torch.Tensor):
        self.left, self.right = left, right


def lane_stacks(left, right, b: int) -> Frames:
    """Lane `b`'s copies of a mix's (F, H, W) uint8 left and right frames:
    what ``slambench.check.FrameIndex`` finds a lane's images among."""
    return Frames(lane_frames(left, b), lane_frames(right, b))
