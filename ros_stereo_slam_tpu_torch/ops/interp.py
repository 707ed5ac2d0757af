"""Bilinear patch sampling, batched over points.

Port of ``ros_stereo_slam_tpu/ops/interp.py``.  The reference reads each
patch with ``lax.dynamic_slice``, whose start index is CLAMPED into the
image while the sub-pixel fraction still comes from the unclamped floor;
:func:`extract_patches` does the same (a per-pixel clamp or a zero pad
gives different numbers near borders).  One difference: ``dynamic_slice``
first wraps a NEGATIVE start by the dimension, so the reference reads a
tile that starts above or left of the image from the opposite border; here
such a start clamps to 0, as the Pallas LK kernel's tile select does.

Lane form: every function also takes a (B, H, W) stack of images with
(B, N, 2) points, lane b of the points sampling image b (the batched-lane
drivers, where the reference vmaps over lanes).
"""

from __future__ import annotations

import torch


def _lane_offsets(img: torch.Tensor, ndim: int) -> torch.Tensor | int:
    """Flat offset of each lane's image in a (B, H, W) stack, shaped to
    broadcast against an index tensor of `ndim` dims (0 for one image)."""
    if img.dim() == 2:
        return 0
    H, W = img.shape[-2:]
    lanes = torch.arange(img.shape[0], device=img.device) * (H * W)
    return lanes.reshape((-1,) + (1,) * (ndim - 1))


def extract_patches(img: torch.Tensor, centers_xy: torch.Tensor, size: int) -> torch.Tensor:
    """(N, 2) float (x, y) centers -> (N, size, size) bilinear patches
    (lane form: (B, H, W) images, (B, N, 2) centers -> (B, N, size, size)).

    Patch pixel (r, c) samples img at (y - (size-1)/2 + r, x - (size-1)/2 + c).
    The (size+1)^2 integer tile's start is clamped to [0, dim - (size+1)]
    (``lax.dynamic_slice`` semantics); callers keep validity masks.
    """
    H, W = img.shape[-2:]
    half = (size - 1) * 0.5
    x0 = centers_xy[..., 0] - half
    y0 = centers_xy[..., 1] - half
    xi = torch.floor(x0)
    yi = torch.floor(y0)
    fx = (x0 - xi)[..., None, None]
    fy = (y0 - yi)[..., None, None]
    ys = torch.clamp(torch.nan_to_num(yi), 0, H - (size + 1)).long()
    xs = torch.clamp(torch.nan_to_num(xi), 0, W - (size + 1)).long()
    off = torch.arange(size + 1, device=img.device)
    flat = ((ys[..., None, None] + off[:, None]) * W + (xs[..., None, None] + off[None, :])
            + _lane_offsets(img, xs.dim() + 2))
    patch = img.reshape(-1)[flat]  # (..., N, size+1, size+1)
    top = patch[..., :-1, :-1] * (1.0 - fx) + patch[..., :-1, 1:] * fx
    bot = patch[..., 1:, :-1] * (1.0 - fx) + patch[..., 1:, 1:] * fx
    return top * (1.0 - fy) + bot * fy


def extract_patch(img: torch.Tensor, center_xy: torch.Tensor, size: int) -> torch.Tensor:
    """Single-point form of :func:`extract_patches`: (2,) -> (size, size)."""
    return extract_patches(img, center_xy[None], size)[0]


def bilinear_at(img: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """Bilinear point samples: (N, 2) float (x, y) -> (N,) values (lane
    form: (B, H, W) images, (B, N, 2) points -> (B, N))."""
    h, w = img.shape[-2:]
    # nan_to_num keeps a NaN point's gather in range (its value is garbage
    # either way, as in the reference).
    x = torch.clamp(torch.nan_to_num(pts_xy[..., 0]), 0.0, w - 1.001)
    y = torch.clamp(torch.nan_to_num(pts_xy[..., 1]), 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = x - x0
    fy = y - y0
    flat = img.reshape(-1)
    base = y0 * w + x0 + _lane_offsets(img, x0.dim())
    v00 = flat[base]
    v01 = flat[base + 1]
    v10 = flat[base + w]
    v11 = flat[base + w + 1]
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def bilinear_at_rgb(img: torch.Tensor, pts_xy: torch.Tensor) -> torch.Tensor:
    """:func:`bilinear_at` of each channel of an (H, W, 3) image at (N, 2)
    points, in one gather: (N, 3) (lane form: (B, H, W, 3), (B, N, 2) ->
    (B, N, 3)).  A uint8 image is scaled to [0, 1]; scaling the four
    corners gives what scaling the whole image first would, bit for bit."""
    h, w, ch = img.shape[-3:]
    x = torch.clamp(torch.nan_to_num(pts_xy[..., 0]), 0.0, w - 1.001)
    y = torch.clamp(torch.nan_to_num(pts_xy[..., 1]), 0.0, h - 1.001)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    base = y0 * w + x0
    if img.dim() == 4:
        base = base + (torch.arange(img.shape[0], device=img.device) * (h * w))[:, None]
    base = base[..., None] * ch + torch.arange(ch, device=img.device)
    flat = img.reshape(-1)
    v00, v01, v10, v11 = (flat[i] for i in (base, base + ch, base + w * ch, base + (w + 1) * ch))
    if img.dtype == torch.uint8:
        v00, v01, v10, v11 = (v.to(torch.float32) * (1.0 / 255.0) for v in (v00, v01, v10, v11))
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def in_bounds(pts_xy: torch.Tensor, h: int, w: int, margin: float) -> torch.Tensor:
    """(..., N) bool mask: point at least `margin` px inside the image."""
    return (
        (pts_xy[..., 0] >= margin)
        & (pts_xy[..., 0] < w - margin)
        & (pts_xy[..., 1] >= margin)
        & (pts_xy[..., 1] < h - margin)
    )
