"""Dense grid keypoint sampling (reference C2).

TPU equivalent of ``visualSLAM::denseKeypointExtractor``
(``reference/src/tracking.cpp:4-12``): a regular grid with step
``stepSize`` starting at (step, step), exclusive of a `step` border.  The
output is a STATIC-shape (capacity, 2) array + validity mask, padded or
truncated to `capacity`, so downstream jitted stages never see dynamic
point counts.
"""

from __future__ import annotations

import numpy as np


def grid_points(height: int, width: int, step: int, capacity: int) -> tuple[np.ndarray, np.ndarray]:
    """Returns (pts (capacity, 2) float32 xy, mask (capacity,) bool).

    Matches the reference's loop bounds: y, x in [step, dim - step) with
    stride `step`.  Computed host-side once per image geometry (static).
    """
    ys = np.arange(step, height - step, step)
    xs = np.arange(step, width - step, step)
    xx, yy = np.meshgrid(xs, ys)
    pts = np.stack([xx.ravel(), yy.ravel()], axis=1).astype(np.float32)
    n = pts.shape[0]
    if n >= capacity:
        # Evenly subsample to capacity to preserve coverage.
        idx = np.linspace(0, n - 1, capacity).astype(np.int64)
        return pts[idx], np.ones((capacity,), dtype=bool)
    out = np.zeros((capacity, 2), dtype=np.float32)
    out[:n] = pts
    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return out, mask
