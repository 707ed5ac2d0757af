"""The vocabulary descent in plain PyTorch: the work of kernel K3.

A descriptor walks from the root to a leaf; at each level it takes the
first of its node's k children whose sign centre has the largest dot
product with it (the smallest Hamming distance).  An invalid descriptor
takes child 0 at every level.  Integer dot products of +-1 vectors are
exact in float32, so the words are exact.
"""

from __future__ import annotations

import torch


def unpack(packed):
    """(N, 8) int32 words -> (N, 256) +-1 float32 (bit j of word w is
    component 32 w + j)."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    bits = ((packed.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return torch.where(bits.reshape(packed.shape[0], 256) > 0, 1.0, -1.0)


def words(packed, valid, centers, k: int, dtype=torch.float32):
    """(N,) int64 leaf ids of (N, 8) packed descriptors over the int8 sign
    tables `centers` (level l: (k^(l+1), 256)), dots in `dtype`."""
    q = unpack(packed).to(dtype)
    node = torch.zeros(packed.shape[0], dtype=torch.int64, device=packed.device)
    kk = torch.arange(k, device=packed.device)
    for c in centers:
        first = node * k
        cand = c[first[:, None] + kk].to(dtype)  # (N, k, 256)
        dots = (cand * q[:, None, :]).float().sum(-1)
        node = torch.where(valid, first + torch.argmax(dots, dim=1), first)
    return node
