"""FAST-9 corner response as dense tensor ops.

Port of ``ros_stereo_slam_tpu/ops/fast.py``: the whole FAST-9 test runs
for every pixel at once from 16 shifted copies of the image (edge
rolls, as the reference).  The per-pixel scores are summed over the ring
in ring order, one term at a time, so they are bitwise the reference's
on the CPU; ties between corners then resolve the same way.

:func:`top_corners` is the reference's exact variant (``exact=True``).
Its default, ``lax.approx_max_k``, is a TPU mechanic: off the TPU the
JAX package is exact too.

Lane form: both functions also take a (B, H, W) stack of lane images and
work on the last two axes (the batched-lane drivers).
"""

from __future__ import annotations

import torch

from ros_stereo_slam_tpu_torch.ops.topk import top_k

# Bresenham circle of radius 3: (dy, dx) offsets, clockwise from 12 o'clock.
_CIRCLE = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)
_ARC = 9  # FAST-9


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """img shifted so out[y, x] = img[y + dy, x + dx] (rolled edges)."""
    return torch.roll(img, (-dy, -dx), dims=(-2, -1))


def _contiguous_any(mask16: torch.Tensor) -> torch.Tensor:
    """A run of >= 9 contiguous Trues on the 16-ring, by binary doubling:
    R_{2k}[s] = R_k[s] & R_k[s+k], so R9 = R8 & R1[s+8]."""

    def rot(m, j):
        return torch.roll(m, -j, dims=0)  # rot(m, j)[s] = m[(s + j) % 16]

    r2 = mask16 & rot(mask16, 1)
    r4 = r2 & rot(r2, 2)
    r8 = r4 & rot(r4, 4)
    r9 = r8 & rot(mask16, 8)
    return r9.any(dim=0)


def fast_score(img: torch.Tensor, thresh: float = 12.0 / 255.0) -> torch.Tensor:
    """FAST-9 corner response per pixel (0 where not a corner).

    Score = sum of bright excesses where a bright arc qualifies plus the
    sum of dark excesses where a dark arc does.  The 3 px border is zeroed.
    """
    ring = torch.stack([_shift(img, dy, dx) for dy, dx in _CIRCLE])  # (16, H, W)
    diff = ring - img[None]
    bright = diff > thresh
    dark = diff < -thresh
    zero = torch.zeros_like(img)
    bright_score, dark_score = zero, zero
    for s in range(len(_CIRCLE)):  # ring order, as the reference's reduction
        bright_score = bright_score + torch.where(bright[s], diff[s] - thresh, zero)
        dark_score = dark_score + torch.where(dark[s], -diff[s] - thresh, zero)
    score = (torch.where(_contiguous_any(bright), bright_score, zero)
             + torch.where(_contiguous_any(dark), dark_score, zero))
    h, w = img.shape[-2:]
    interior = torch.zeros((h, w), dtype=torch.bool, device=img.device)
    interior[3:h - 3, 3:w - 3] = True
    return torch.where(interior, score, zero)


def top_corners(
    score: torch.Tensor, capacity: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-`capacity` 3x3 peaks -> ((N, 2) xy points, (N,) scores, (N,) valid)
    (lane form: (B, H, W) scores -> (B, N, 2), (B, N), (B, N)).

    Exact top-k; among equal scores the lowest raster index comes first.
    """
    m = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                m = torch.maximum(m, _shift(score, dy, dx))
    peak = torch.where(score >= m, score, torch.zeros_like(score))
    flat = peak.flatten(-2)
    vals, idx = top_k(flat, min(capacity, flat.shape[-1]))
    w = score.shape[-1]
    pts = torch.stack([(idx % w).to(torch.float32),
                       torch.div(idx, w, rounding_mode="floor").to(torch.float32)], dim=-1)
    return pts, vals, vals > 0.0
