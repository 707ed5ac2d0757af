"""Mutual-nearest binary-descriptor matching.

Port of ``ros_stereo_slam_tpu/ops/match.py``, the reference's non-dense
stereo matcher (BFMatcher, ``reference/src/triangulation.cpp:104-134``):
every pairwise Hamming distance at once as one sign-vector product
(:func:`.orb.hamming_mxu`: ``(256 - sa @ sb^T) / 2``), then a masked row
argmin for the best match, a second pass with the best column set to
``big`` for Lowe's ratio test, and a column argmin for the mutual check.

The products of +/-1 entries summed in float32 are exact integers only
with TF32 off, which the package sets at import; ``torch.argmin`` returns
the first index among ties, as ``jnp.argmin`` does, so the two packages
pick the same match.

Lane form: (B, N, 256) and (B, M, 256) signs with (B, N), (B, M) flags
(and a (B, N, M) pair mask) give (B, N) results, from one batched product.
The distances are exact integers, so a lane equals its single-lane call.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ros_stereo_slam_tpu_torch.ops.orb import N_BITS, hamming_mxu


class MatchResult(NamedTuple):
    idx: torch.Tensor  # (N,) int64: index into B for each A row
    dist: torch.Tensor  # (N,) float32: Hamming distance of the match
    valid: torch.Tensor  # (N,) bool


def mutual_hamming_match(
    sign_a: torch.Tensor,  # (N, 256) +/-1 rows (invalid rows all-zero)
    valid_a: torch.Tensor,  # (N,) bool
    sign_b: torch.Tensor,  # (M, 256)
    valid_b: torch.Tensor,  # (M,) bool
    max_dist: float = 64.0,
    ratio: float = 0.8,
    pair_mask: torch.Tensor | None = None,  # (N, M) optional extra gate
) -> MatchResult:
    """Mutual-nearest + Lowe-ratio matching over a full distance matrix."""
    big = float(4 * N_BITS)
    d = hamming_mxu(sign_a, sign_b)  # (..., N, M)
    gate = valid_a[..., :, None] & valid_b[..., None, :]
    if pair_mask is not None:
        gate = gate & pair_mask
    d = torch.where(gate, d, torch.full_like(d, big))

    best_j = torch.argmin(d, dim=-1)  # (..., N)
    best_d = torch.gather(d, -1, best_j[..., None])[..., 0]
    # second best for the neighbour-ratio test
    d2 = d.scatter(-1, best_j[..., None], big)
    second_d = d2.min(dim=-1).values
    # mutual check: is A-row i also the best for column best_j[i]?
    best_i_of_b = torch.argmin(d, dim=-2)  # (..., M)
    rows = torch.arange(d.shape[-2], device=d.device)
    mutual = torch.gather(best_i_of_b, -1, best_j) == rows

    valid = (valid_a & mutual & (best_d <= max_dist)
             # strict: an exact tie (duplicate descriptor in B) is ambiguous
             & (best_d < ratio * second_d))
    return MatchResult(idx=best_j, dist=best_d, valid=valid)
