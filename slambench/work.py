"""The operations and bytes a kernel's call needs, and the card's peaks.

A frozen copy of ``chip_smoke.py``'s ``lk_work`` / ``_sectors`` /
``_tile_start`` / ``lk_evals`` / ``_bound`` (kernel K1, one LK level).
A call's least time on the card is the larger of its bytes over the
memory rate and its operations over the float32 rate; its roofline share
is that time over the time the trace gives the kernel.
"""

from __future__ import annotations

import torch

# One NVIDIA H100 SXM (data sheet, dense, at its 700 W limit).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def bound(nbytes: float, ops: float, peak_ops: float = PEAK_F32_S) -> dict:
    """The least seconds a call's work can take, and which rate sets it."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / peak_ops
    return {"bound_s": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops
            else "operations", "bytes": nbytes, "ops": ops}


def sectors(H: int, W: int, y0, x0, h: int, w: int) -> int:
    """Distinct 32-byte sectors (8 float32 pixels of the flat, lane-major
    layout) of (B, H, W) images that boxes cover: box m of lane b covers
    rows y0[b, m] .. + h - 1 and columns x0[b, m] .. + w - 1."""
    dev = y0.device
    lane = torch.arange(y0.shape[0], device=dev).reshape(-1, 1, 1, 1)
    rows = y0[..., None, None] + torch.arange(h, device=dev)[:, None]
    cols = x0[..., None, None] + torch.arange(w, device=dev)
    flat = (lane * H + rows) * W + cols
    return int(torch.unique(flat.reshape(-1) // 8).numel())


def tile_start(pos, n: int, dim: int):
    """lk_level.cu's tile start: floor(pos) clamped to [0, dim - (n + 1)]."""
    return torch.clamp(torch.floor(torch.nan_to_num(pos, nan=0.0)), 0, dim - (n + 1)).long()


def lk_evals(track, guesses, out, iters: int) -> int:
    """Gauss-Newton steps K1 evaluated over all points of one call.  A
    point stops at the first step under eps, and a point that stopped at
    step j gives the same result with `iters` = j, so j is the fewest
    iterations that reproduce `out`; `track(k)` reruns the call with k."""
    j = torch.full(out.shape[:-1], iters, dtype=torch.long, device=out.device)
    for k in range(iters - 1, -1, -1):
        same = ((guesses if k == 0 else track(k)[0]) == out).all(-1)
        j = torch.where(same, torch.full_like(j, k), j)
    return int(torch.where(j < iters, j + 1, j).sum())


def lk_work(ref_pts, guesses, out_pts, H: int, W: int, S: int, evals: int) -> dict:
    """K1's work on (B, N, 2) points of B lanes.  Bytes: the sectors that the
    (S+3)^2 template tiles cover in the reference images and the (S+1)^2
    sample tiles at the guess and at the result cover in the current
    images (each read once), the points and guesses read, the points,
    residuals and flags written.  Operations per point: the (S+2)^2
    template samples (9 each), gradients and structure tensor (16 per
    pixel) and the residual (12 per pixel), and `evals` Gauss-Newton steps
    of S^2 samples and products (14 per pixel) over all points."""
    T, half = S + 2, (S - 1) * 0.5
    B, n = ref_pts.shape[:2]
    ry = tile_start(ref_pts[..., 1] - half - 1.0, T, H)
    rx = tile_start(ref_pts[..., 0] - half - 1.0, T, W)
    cur = torch.cat([guesses, out_pts], dim=1)
    cy = tile_start(cur[..., 1] - half, S, H)
    cx = tile_start(cur[..., 0] - half, S, W)
    n_sec = sectors(H, W, ry, rx, T + 1, T + 1) + sectors(H, W, cy, cx, S + 1, S + 1)
    nbytes = n_sec * 32 + B * n * (4 * 4 + 2 * 4 + 4 + 1)
    ops = B * n * (9 * T * T + S * S * (16 + 12)) + evals * S * S * 14
    return bound(nbytes, ops)


def k1_call_work(track_level, call) -> dict:
    """The work of one recorded single-lane K1 call (ref_img, cur_img,
    ref_pts, guesses, out_pts, params); `track_level` is the kernel's
    entry point, rerun with fewer iterations to count the steps taken."""
    ref_img, cur_img, ref_pts, guesses, out_pts, params = call
    H, W = ref_img.shape[-2:]

    def track(k):
        return track_level(ref_img, cur_img, ref_pts, guesses,
                           params._replace(iters=k, walk_iters=min(k, params.walk_iters)))

    evals = lk_evals(track, guesses, out_pts, params.iters)
    return lk_work(ref_pts[None], guesses[None], out_pts[None], H, W, params.window, evals)
