"""Minimal-set sampling for the RANSAC solvers.

Port of ``_sample_minimal_sets`` from ``ros_stereo_slam_tpu/ops/ransac.py``
(Gumbel top-k over the validity mask).  The draws come from a
``torch.Generator``; they are not JAX's streams, so parity tests inject
index sets drawn by the JAX function instead (see ``ops/pnp.py``).
``fmat_ransac`` is not on the odometry path and is not ported yet.
"""

from __future__ import annotations

import torch


def _sample_minimal_sets(gen: torch.Generator, mask: torch.Tensor, k_hyp: int,
                         m: int) -> torch.Tensor:
    """(k_hyp, m) indices of valid points, sampled w/o replacement per row."""
    n = mask.shape[0]
    u = torch.rand((k_hyp, n), generator=gen, device=mask.device)
    g = -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype).tiny)))
    scores = torch.where(mask[None, :], g, torch.full_like(g, -torch.inf))
    return torch.topk(scores, m, dim=1).indices
