"""Top-k with the reference's tie order.

``lax.top_k`` returns, among equal values, the lowest index first.
``torch.topk`` promises no order among ties, and its CUDA kernel orders
them differently from its CPU one.  Ties are common on the detection
path: ANMS radii between integer corners are exact integers, FAST scores
and rescored similarities are often exactly 0, and masked entries all
carry the same sentinel.  Every top-k of the port goes through
:func:`top_k`, a stable descending sort, so both devices pick the same
entries in the same order as the JAX package.
"""

from __future__ import annotations

import torch


def top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The `k` largest entries along the last axis, ties by lowest index.

    Returns (values, int64 indices), each (..., k), largest first.
    """
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
