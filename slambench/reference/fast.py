"""FAST-9 corners on an image pyramid in plain PyTorch, for the vocabulary
the benchmark trains (:mod:`slambench.vocabulary`).

A pixel is a corner when 9 or more contiguous pixels of the 16 on the
radius-3 Bresenham circle are all brighter than it by more than the
threshold, or all darker; its score is the summed excess of the arc's
side.  Corners are 3x3 score peaks, the strongest first.  Level l of the
pyramid is the image resized by ``scale ** -l`` with bilinear sampling at
pixel centres.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

CIRCLE = ((0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
          (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3))
ARC = 9


def _arc(side: torch.Tensor) -> torch.Tensor:
    """(16, H, W) bool -> (H, W): some ARC contiguous entries of the ring hold."""
    ring = torch.cat([side, side[: ARC - 1]]).to(torch.int32)  # wrap around
    run = torch.stack([ring[s:s + ARC].sum(0) for s in range(len(CIRCLE))])
    return (run == ARC).any(0)


def score(img: torch.Tensor, thresh: float) -> torch.Tensor:
    """(H, W) FAST-9 scores of an (H, W) image; 0 off corners and within
    3 px of the border."""
    h, w = img.shape
    pad = F.pad(img[None, None], (3, 3, 3, 3), mode="replicate")[0, 0]
    ring = torch.stack([pad[3 + dy:3 + dy + h, 3 + dx:3 + dx + w] for dy, dx in CIRCLE])
    diff = ring - img
    bright, dark = diff > thresh, diff < -thresh
    s = (torch.where(_arc(bright), torch.where(bright, diff - thresh, 0).sum(0), 0)
         + torch.where(_arc(dark), torch.where(dark, -diff - thresh, 0).sum(0), 0))
    s[:3], s[-3:], s[:, :3], s[:, -3:] = 0, 0, 0, 0
    return s


def corners(img: torch.Tensor, thresh: float, n: int, margin: int) -> torch.Tensor:
    """Up to `n` (x, y) float32 corners of an (H, W) image: 3x3 score
    peaks at least `margin` px inside, strongest first."""
    s = score(img, thresh)
    peak = F.max_pool2d(s[None, None], 3, stride=1, padding=1)[0, 0]
    keep = (s > 0) & (s == peak)
    keep[:margin], keep[-margin:], keep[:, :margin], keep[:, -margin:] = False, False, False, False
    ys, xs = keep.nonzero(as_tuple=True)
    top = torch.argsort(s[ys, xs], descending=True, stable=True)[:n]
    return torch.stack([xs[top], ys[top]], -1).to(torch.float32)


def pyramid(img: torch.Tensor, levels: int, scale: float) -> list:
    """[level 0 = `img`, level l resized by scale^-l], each (H_l, W_l)."""
    h, w = img.shape
    out = [img]
    for lv in range(1, levels):
        size = (max(round(h / scale**lv), 32), max(round(w / scale**lv), 32))
        out.append(F.interpolate(img[None, None], size=size, mode="bilinear",
                                 align_corners=False)[0, 0])
    return out
