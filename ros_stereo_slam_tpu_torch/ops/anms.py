"""Adaptive non-maximal suppression.

Port of ``ros_stereo_slam_tpu/ops/anms.py``: one masked (N, N) squared
distance matrix, a row minimum and a top-k,

  radius_i = min_j { ||p_i - p_j|| : score_j > robust_coeff * score_i },

keeping the `num_keep` points with the largest radii.  Corners sit on
integer pixels, so the squared distances are exact integers and tie often;
:func:`~ros_stereo_slam_tpu_torch.ops.topk.top_k` keeps the reference's
lowest-index-first order among them.

Lane form: (B, N, 2) points with (B, N) scores and masks, one (B, N, N)
distance block, each lane selecting among its own points.
"""

from __future__ import annotations

import torch

from ros_stereo_slam_tpu_torch.ops.topk import top_k

_BIG = 1e30


def anms(
    pts: torch.Tensor,
    scores: torch.Tensor,
    mask: torch.Tensor,
    num_keep: int,
    robust_coeff: float = 1.11,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Select `num_keep` spatially spread strong keypoints.

    pts (N, 2) xy, scores (N,), mask (N,) validity.  Returns the selected
    (num_keep, 2) points and their (num_keep,) validity.
    """
    sq = (pts * pts).sum(-1)
    d2 = torch.clamp(sq[..., :, None] + sq[..., None, :]
                     - 2.0 * (pts @ pts.transpose(-1, -2)), min=0.0)
    stronger = ((scores[..., None, :] > robust_coeff * scores[..., :, None])
                & mask[..., None, :])
    d2 = torch.where(stronger, d2, torch.full_like(d2, _BIG))
    radius2 = d2.min(dim=-1).values  # _BIG for the global maximum: kept first
    radius2 = torch.where(mask, radius2, torch.full_like(radius2, -1.0))
    vals, idx = top_k(radius2, num_keep)
    return torch.gather(pts, -2, idx[..., None].expand(idx.shape + (2,))), vals > 0.0
