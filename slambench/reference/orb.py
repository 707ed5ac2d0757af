"""Oriented-BRIEF signs in plain PyTorch: the work of kernel K2.

The intensity-centroid moments over the radius-15 circular patch give a
corner's orientation; the 256 fixed Gaussian pairs, rotated by it and
sampled bilinearly at absolute image positions (clamped to the image),
give its bits: +1 where the first sample is darker.  The pattern is drawn
as the reference ORB draws it (seed 20260817, sigma = 31 / 5).
"""

from __future__ import annotations

import numpy as np
import torch

N_BITS = 256
PATCH = 31
PATTERN_SEED = 20260817


def pattern() -> tuple[np.ndarray, np.ndarray]:
    """(256, 2) + (256, 2) offsets."""
    rng = np.random.default_rng(PATTERN_SEED)
    sigma, lim = PATCH / 5.0, PATCH // 2 - 1
    p = np.clip(rng.normal(0, sigma, (N_BITS, 2)), -lim, lim)
    q = np.clip(rng.normal(0, sigma, (N_BITS, 2)), -lim, lim)
    return p.astype(np.float32), q.astype(np.float32)


def centroid_offsets() -> np.ndarray:
    r = PATCH // 2
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    keep = ys**2 + xs**2 <= r**2
    return np.stack([xs[keep], ys[keep]], axis=1).astype(np.float32)


def sample(img, pts):
    """Bilinear samples of an (H, W) image at (N, 2) xy, clamped inside."""
    h, w = img.shape
    x = torch.clamp(torch.nan_to_num(pts[:, 0]), 0.0, w - 1.001)
    y = torch.clamp(torch.nan_to_num(pts[:, 1]), 0.0, h - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = (x - x0).to(img.dtype), (y - y0).to(img.dtype)
    flat = img.reshape(-1)
    base = y0 * w + x0
    return (flat[base] * (1 - fy) * (1 - fx) + flat[base + 1] * (1 - fy) * fx
            + flat[base + w] * fy * (1 - fx) + flat[base + w + 1] * fy * fx)


def signs(img, pts, valid, dtype=torch.float32):
    """(N, 256) float32 signs of (N, 2) corners on an (H, W) image in
    [0, 1], computed in `dtype`; rows of invalid corners are 0."""
    dev = img.device
    im = img.to(dtype)
    p, q = (torch.from_numpy(a).to(dev) for a in pattern())
    cent = torch.from_numpy(centroid_offsets()).to(dev)
    n = pts.shape[0]
    pts = pts.to(torch.float32)
    vals = sample(im, (pts[:, None, :] + cent).reshape(-1, 2)).reshape(n, -1)
    m10 = (vals * cent[:, 0].to(dtype)).sum(1).float()
    m01 = (vals * cent[:, 1].to(dtype)).sum(1).float()
    ang = torch.atan2(m01, m10)
    ca, sa = torch.cos(ang)[:, None], torch.sin(ang)[:, None]

    def rotated(o):
        return torch.stack([ca * o[:, 0] - sa * o[:, 1], sa * o[:, 0] + ca * o[:, 1]], -1) \
            + pts[:, None, :]

    vp = sample(im, rotated(p).reshape(-1, 2)).reshape(n, N_BITS)
    vq = sample(im, rotated(q).reshape(-1, 2)).reshape(n, N_BITS)
    return torch.where(vp < vq, 1.0, -1.0) * valid[:, None].float()
