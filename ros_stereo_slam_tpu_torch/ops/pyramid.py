"""Image pyramids and Scharr gradients as shifted adds.

Port of ``ros_stereo_slam_tpu/ops/pyramid.py``: a 5-tap binomial blur
with edge replication followed by 2x decimation, written as index
gathers and adds (no convolution, so no cuDNN TF32 path is involved).
The reference folds blur + decimation into a matmul, a TPU device; the
math is the same: output row i is sum_k w_k x[clip(2i + k - 2)].

Every function works on the last two axes, so a (B, H, W) stack of lane
images gives a pyramid of (B, h, w) levels.
"""

from __future__ import annotations

import torch

# 5-tap binomial kernel (1, 4, 6, 4, 1) / 16 — OpenCV pyrDown's kernel.
_K5 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _filter1d(img: torch.Tensor, taps, axis: int, stride: int = 1) -> torch.Tensor:
    """Symmetric odd-length FIR along `axis` with edge replication, keeping
    every `stride`-th output sample ((n + stride - 1) // stride outputs).

    Zero taps are skipped (adding +0.0 changes no finite value).
    """
    r = len(taps) // 2
    n = img.shape[axis]
    centers = torch.arange(0, n, stride, device=img.device)
    out = None
    for i, w in enumerate(taps):
        if w == 0.0:
            continue
        idx = torch.clamp(centers + (i - r), 0, n - 1)
        term = w * img.index_select(axis, idx)
        out = term if out is None else out + term
    return out


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur + 2x decimate; an odd size n gives (n + 1) // 2 samples."""
    return _filter1d(_filter1d(img, _K5, -2, stride=2), _K5, -1, stride=2)


def build_pyramid(img: torch.Tensor, levels: int) -> list[torch.Tensor]:
    """Return [img, down1, down2, ...] with `levels` entries."""
    out = [img]
    for _ in range(levels - 1):
        out.append(pyr_down(out[-1]))
    return out


def scharr_gradients(img: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ix, Iy) via the 3x3 Scharr operator (OpenCV LK's derivative filter).

    Separable: smooth = (3, 10, 3)/16, diff = (-1, 0, 1)/2.
    """
    smooth = (3.0 / 16.0, 10.0 / 16.0, 3.0 / 16.0)
    diff = (-0.5, 0.0, 0.5)
    ix = _filter1d(_filter1d(img, diff, -1), smooth, -2)
    iy = _filter1d(_filter1d(img, diff, -2), smooth, -1)
    return ix, iy
