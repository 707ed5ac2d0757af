"""Statistical outlier removal on a masked point block.

Port of ``ros_stereo_slam_tpu/ops/sor.py``: the kNN mean distance comes
from the full masked pairwise-distance matrix (Gram trick) and a top-k.
Lane form: (B, N, 3) points and (B, N) masks, one (B, N, N) distance
block, statistics per lane.
"""

from __future__ import annotations

import torch

_BIG = 1e30


def sor_filter(
    points: torch.Tensor,
    mask: torch.Tensor,
    mean_k: int = 32,
    std_mul: float = 1.0,
    max_depth: float = 500.0,
) -> torch.Tensor:
    """Masked SOR: returns the filtered validity mask.

    points: (N, 3); mask: (N,) bool.  A point survives iff its mean
    distance to its `mean_k` nearest valid neighbours is within
    mu + std_mul * sigma of the population, and its z is in (0, max_depth).
    """
    z_ok = (points[..., 2] > 0.0) & (points[..., 2] < max_depth)
    m = mask & z_ok
    sq = (points * points).sum(-1)
    d2 = torch.clamp(sq[..., :, None] + sq[..., None, :]
                     - 2.0 * (points @ points.transpose(-1, -2)), min=0.0)
    n = points.shape[-2]
    eye = torch.eye(n, dtype=torch.bool, device=points.device)
    d2 = torch.where(m[..., None, :] & ~eye, d2, torch.full_like(d2, _BIG))
    # kNN mean distance per point (the k smallest squared distances).
    near = torch.topk(d2, mean_k, dim=-1, largest=False).values
    knn_d = torch.sqrt(torch.clamp(near, min=0.0))
    knn_valid = near < _BIG * 0.5
    counts = torch.clamp(knn_valid.sum(-1), min=1)
    mean_d = torch.where(knn_valid, knn_d, torch.zeros_like(knn_d)).sum(-1) / counts
    # Population statistics over valid points.
    n_valid = torch.clamp(m.sum(-1, keepdim=True), min=1)
    zero = torch.zeros_like(mean_d)
    mu = torch.where(m, mean_d, zero).sum(-1, keepdim=True) / n_valid
    var = torch.where(m, (mean_d - mu) ** 2, zero).sum(-1, keepdim=True) / n_valid
    sigma = torch.sqrt(torch.clamp(var, min=0.0))
    return m & (mean_d <= mu + std_mul * sigma)
