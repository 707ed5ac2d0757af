"""One Lucas-Kanade pyramid level in plain PyTorch.

Forward-additive LK with template-side Scharr gradients, a masked epsilon
stop and a contrast-normalized residual, every point at once: the work
that kernel K1 does for one level.  Near image borders the kernel clamps
its tiles its own way, so the comparison keeps to points whose results lie
`BORDER_PX` inside the image.
"""

from __future__ import annotations

import torch

BORDER_PX = 10.0


def _filter1d(img, taps, axis: int):
    """Symmetric FIR along `axis` with edge replication (zero taps skipped)."""
    r, n = len(taps) // 2, img.shape[axis]
    centers = torch.arange(n, device=img.device)
    out = None
    for i, w in enumerate(taps):
        if w:
            term = w * img.index_select(axis, torch.clamp(centers + i - r, 0, n - 1))
            out = term if out is None else out + term
    return out


def scharr(img):
    """(Ix, Iy) by the separable 3x3 Scharr operator."""
    smooth, diff = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0), (-0.5, 0.0, 0.5)
    return (_filter1d(_filter1d(img, diff, -1), smooth, -2),
            _filter1d(_filter1d(img, diff, -2), smooth, -1))


def patches(img, centers, size: int):
    """(N, 2) xy centers -> (N, size, size) bilinear samples at
    centre - (size - 1) / 2 + (r, c); the (size + 1)^2 integer tile starts
    at the floor, clamped into the image, the fraction from the unclamped
    floor."""
    H, W = img.shape
    half = (size - 1) * 0.5
    x0, y0 = centers[:, 0] - half, centers[:, 1] - half
    xi, yi = torch.floor(x0), torch.floor(y0)
    fx = (x0 - xi).to(img.dtype)[:, None, None]
    fy = (y0 - yi).to(img.dtype)[:, None, None]
    ys = torch.clamp(torch.nan_to_num(yi), 0, H - (size + 1)).long()
    xs = torch.clamp(torch.nan_to_num(xi), 0, W - (size + 1)).long()
    off = torch.arange(size + 1, device=img.device)
    flat = (ys[:, None, None] + off[:, None]) * W + xs[:, None, None] + off[None, :]
    p = img.reshape(-1)[flat]
    top = p[:, :-1, :-1] * (1 - fx) + p[:, :-1, 1:] * fx
    bot = p[:, 1:, :-1] * (1 - fx) + p[:, 1:, 1:] * fx
    return top * (1 - fy) + bot * fy


def track_level(ref_img, cur_img, ref_pts, guesses, window: int, iters: int, walk_iters: int,
                eps: float, min_eig: float, dtype=torch.float32):
    """Refine (N, 2) `guesses` of `ref_pts` on one level, computing in
    `dtype`.  Returns (points, residual, ok, converged) in float32 / bool;
    a point whose structure tensor is too weak keeps its guess; a point
    has converged when its last step was under `eps` (it had stopped)."""
    w = window
    ref, cur = ref_img.to(dtype), cur_img.to(dtype)
    pts = ref_pts.to(torch.float32)
    ix, iy = scharr(ref)
    tmpl, gx, gy = patches(ref, pts, w), patches(ix, pts, w), patches(iy, pts, w)
    a, b, c = (gx * gx).sum((1, 2)), (gx * gy).sum((1, 2)), (gy * gy).sum((1, 2))
    det, tr = a * c - b * b, a + c
    lam = (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))) * 0.5 / (w * w)
    ok = lam.to(torch.float32) > min_eig
    inv_det = torch.where(det > 1e-12, 1.0 / torch.clamp(det, min=1e-12), torch.zeros_like(det))

    moving = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)

    def step(g, pos):
        nonlocal moving
        it = patches(cur, pos, w) - tmpl
        bx, by = (gx * it).sum((1, 2)), (gy * it).sum((1, 2))
        delta = torch.stack([(c * bx - b * by) * inv_det, (a * by - b * bx) * inv_det], -1)
        delta = delta.to(torch.float32)
        moving = ~(torch.linalg.vector_norm(delta, dim=-1) < eps)
        return g - moving[:, None] * delta

    walk = min(iters, walk_iters)
    g = guesses.to(torch.float32)
    for _ in range(walk):
        g = step(g, g)
    g_res = g
    if iters > walk:  # freeze-polish: samples from a ~1 px cell around the anchor
        h_i, w_i = cur.shape
        half = (w - 1) * 0.5
        hi = torch.tensor([w_i - w - 3.0, h_i - w - 3.0], device=g.device)
        base = torch.minimum(torch.clamp(torch.floor(g - half) - 1.0, min=0.0), hi)

        def clamp_pos(gp):
            return base + torch.clamp(gp - half - base, 0.0, 2.0 - 1e-4) + half

        for _ in range(iters - walk):
            g = step(g, clamp_pos(g))
        g_res = clamp_pos(g)
    contrast = torch.std(tmpl.float(), dim=(1, 2), correction=0) + 1e-3
    resid = (patches(cur, g_res, w) - tmpl).abs().float().mean((1, 2)) / contrast
    return torch.where(ok[:, None], g, guesses.to(torch.float32)), resid, ok, ~moving


def interior(pts, h: int, w: int, margin: float = BORDER_PX):
    """(N,) bool: the point lies `margin` px inside an h x w image."""
    return ((pts[:, 0] >= margin) & (pts[:, 0] < w - margin)
            & (pts[:, 1] >= margin) & (pts[:, 1] < h - margin))
