"""Hierarchical binary-descriptor vocabulary and sparse bag-of-words scoring.

Port of ``ros_stereo_slam_tpu/models/vocab.py``.  The tree is a dense
per-level table of int8 sign centers (``centers[l]``: (k^(l+1), 256));
node n's children are rows [n k, (n + 1) k).  At the reference scale
(k = 9, L = 6: 531,441 words) the tables hold ~153 MB.

- :func:`_descend` walks descriptors down the tree by argmax of the sign
  dot product.  Levels of at most ``_DESCEND_MASKED_ARGMAX_MAX_NODES``
  rows are scored densely with a masked argmax; the deeper levels go
  through :func:`.vocab_cuda.deep_descend` (kernel K3 on CUDA tensors,
  :func:`_deep_descend_plain`, the gather route, on CPU tensors).  All
  dots are exact integers and every argmax takes the first max, so every
  route gives the reference's word ids bit for bit.
- :func:`train_batched` is the level-synchronous trainer.  Its random
  draws come from a CPU ``torch.Generator`` and are moved to the device;
  everything after them is exact integer work, so a seed gives the same
  vocabulary on the CPU and on the card (not JAX's: its keys differ).
- The sparse BoW, binned shortlist and exact min-intersection rescore
  are the reference's formulas (see its module docstring).  Each also
  takes a leading lane axis (the batched-lane drivers), every lane
  sorted, merged and scored on its own; lanes descend the tree as one
  flattened (B N, 256) batch.

The reference's deep-table tail pad (``prepare_centers_for_scan``,
``vocab_pallas.pad_table``) is a TPU mechanic and is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.ops.orb import N_BITS

# Levels whose table has at most this many rows are scored with one dense
# matmul against the whole level and a masked argmax; deeper levels read
# only each descriptor's k sibling rows.
_DESCEND_MASKED_ARGMAX_MAX_NODES = 8192
# Descriptors per dense block in transform_words and the trainer.
_CHUNK = 8192


@dataclass
class Vocabulary:
    k: int  # branching factor
    levels: int  # tree depth (leaves = k**levels words)
    centers: list  # per level l: (k**(l+1), 256) int8 sign vectors (tensors)
    idf: torch.Tensor  # (k**levels,) float32 word weights

    @property
    def n_words(self) -> int:
        return self.k**self.levels

    def to(self, device) -> "Vocabulary":
        return Vocabulary(k=self.k, levels=self.levels,
                          centers=[c.to(device) for c in self.centers],
                          idf=self.idf.to(device))

    # -- persistence: the reference's npz layout ---------------------------

    def save(self, path: str) -> None:
        arrs = {f"level_{i}": c.cpu().numpy().astype(np.int8)
                for i, c in enumerate(self.centers)}
        np.savez_compressed(path, k=self.k, levels=self.levels,
                            idf=self.idf.cpu().numpy().astype(np.float32), **arrs)

    @staticmethod
    def load(path: str, device="cuda") -> "Vocabulary":
        with np.load(path) as z:
            levels = int(z["levels"])
            return Vocabulary(
                k=int(z["k"]), levels=levels,
                centers=[torch.from_numpy(np.asarray(z[f"level_{i}"], np.int8)).to(device)
                         for i in range(levels)],
                idf=torch.from_numpy(np.asarray(z["idf"], np.float32)).to(device),
            )


def _idf_of(voc: Vocabulary, X: torch.Tensor, doc_ids: np.ndarray | None) -> None:
    """TF-IDF word weights from the training corpus (in place)."""
    if doc_ids is None or X.shape[0] == 0:
        return
    words = transform_words(voc, X).cpu().numpy()
    docs = np.asarray(doc_ids)
    n_docs = len(np.unique(docs))
    # document frequency: count each (doc, word) pair once
    pair = docs.astype(np.int64) * voc.n_words + words.astype(np.int64)
    uniq = np.unique(pair)
    df = np.bincount((uniq % voc.n_words).astype(np.int64), minlength=voc.n_words)
    idf = np.log(n_docs / np.maximum(df, 1)).astype(np.float32)
    idf[df == 0] = 0.0
    voc.idf = torch.from_numpy(idf).to(voc.centers[0].device)


# -- level-synchronous batched trainer (reference scale) --------------------


def _assign_level(X: torch.Tensor, node: torch.Tensor, C: torch.Tensor, k: int) -> torch.Tensor:
    """E-step: each descriptor picks the best of its node's k children.

    Returns the (N,) child group ids; the (chunk, k, 256) candidate block
    keeps memory bounded for any corpus size.
    """
    out = torch.empty_like(node)
    kk = torch.arange(k, device=X.device)
    for s in range(0, X.shape[0], _CHUNK):
        xc, nc = X[s:s + _CHUNK], node[s:s + _CHUNK]
        cand = C[nc[:, None] * k + kk[None, :]].to(torch.float32)  # (chunk, k, 256)
        d = torch.einsum("nd,nkd->nk", xc, cand)
        out[s:s + _CHUNK] = nc * k + torch.argmax(d, dim=1)
    return out


def _update_level(X: torch.Tensor, g: torch.Tensor, C: torch.Tensor, G: int) -> torch.Tensor:
    """M-step: per-group bit-wise majority vote (sign of the sum); empty
    groups keep their current center."""
    S = torch.zeros((G, N_BITS), dtype=torch.float32, device=X.device).index_add_(0, g, X)
    cnt = torch.zeros((G,), dtype=torch.float32, device=X.device).index_add_(
        0, g, torch.ones_like(g, dtype=torch.float32))
    newC = torch.where(S >= 0, 1, -1).to(torch.int8)
    return torch.where(cnt[:, None] > 0, newC, C)


def _init_level(gen: torch.Generator, X: torch.Tensor, node: torch.Tensor, k: int,
                G: int) -> torch.Tensor:
    """Initial centers: k distinct random members per node (a random
    partition would vote every child of a node to the same sign vector),
    random signs for children of nodes with fewer than k members.

    The random numbers come from `gen`, a CPU generator, and move to the
    descriptors' device.
    """
    n = X.shape[0]
    dev = X.device
    r = torch.rand((n,), generator=gen).to(dev)
    flips = (torch.rand((G, N_BITS), generator=gen) < 0.5).to(dev)
    # lexsort by (node, r): sort by r, then stably by node
    by_r = torch.argsort(r, stable=True)
    order = by_r[torch.argsort(node[by_r], stable=True)]
    sn = node[order]
    seg_start = torch.ones((n,), dtype=torch.bool, device=dev)
    seg_start[1:] = sn[1:] != sn[:-1]
    idxs = torch.arange(n, device=dev)
    start_idx = torch.cummax(torch.where(seg_start, idxs, torch.zeros_like(idxs)), 0).values
    rank = idxs - start_idx
    target = sn * k + rank
    keep = rank < k
    C = torch.where(flips, 1, -1).to(torch.int8)
    C[target[keep]] = X[order][keep].to(torch.int8)
    return C


def _train_levels(X: torch.Tensor, k: int, levels: int, iters: int, init_level) -> list:
    """Train every level; `init_level(level, node, G)` gives its initial centers."""
    node = torch.zeros((X.shape[0],), dtype=torch.int64, device=X.device)
    centers = []
    for level in range(levels):
        G = k ** (level + 1)
        C = init_level(level, node, G)
        for _ in range(iters):
            C = _update_level(X, _assign_level(X, node, C, k), C, G)
        node = _assign_level(X, node, C, k)
        centers.append(C)
    return centers


def train_batched(
    descriptors, k: int = 9, levels: int = 6, iters: int = 6, seed: int = 0,
    doc_ids: np.ndarray | None = None, device="cuda",
) -> Vocabulary:
    """Level-synchronous trainer from (N, 256) sign descriptors (array or tensor).

    All k^l nodes of a level train their k children at once: assignment
    is a gathered (N, k, 256) contraction, the center update a
    segment-sum majority vote over (G, 256).  `doc_ids` (N,) frame ids
    give TF-IDF weights (uniform weights without them).
    """
    X = torch.as_tensor(descriptors, dtype=torch.float32, device=device)
    gen = torch.Generator().manual_seed(int(seed))
    centers = _train_levels(
        X, k, levels, iters, lambda level, node, G: _init_level(gen, X, node, k, G))
    voc = Vocabulary(k=k, levels=levels, centers=centers,
                     idf=torch.ones((k**levels,), dtype=torch.float32, device=X.device))
    _idf_of(voc, X, doc_ids)
    return voc


# -- transform ---------------------------------------------------------------


def _deep_descend_plain(q: torch.Tensor, node: torch.Tensor, tables, k: int) -> torch.Tensor:
    """The plain version of kernel K3: the gather route of the descent.

    Per level, gather the k contiguous sibling rows of each descriptor's
    node, dot, take the first max (``torch.argmax``).  Exact: every dot is
    an integer.  Returns (N,) int64 node ids after the last table.
    """
    q = q.to(torch.float32)
    for tbl in tables:
        cand = tbl.reshape(-1, k, N_BITS)[node].to(torch.float32)  # (N, k, 256)
        dots = torch.einsum("nd,nkd->nk", q, cand)
        node = node * k + torch.argmax(dots, dim=1)
    return node


def _descend(centers: list, desc_sign: torch.Tensor, k: int, upto: int) -> torch.Tensor:
    """Argmax descent: (N, 256) sign descriptors -> (N,) int64 node ids at
    level `upto`."""
    from ros_stereo_slam_tpu_torch.ops import vocab_cuda

    q = desc_sign.to(torch.float32)
    node = torch.zeros((q.shape[0],), dtype=torch.int64, device=q.device)
    for l in range(upto):
        G = centers[l].shape[0]
        if G > _DESCEND_MASKED_ARGMAX_MAX_NODES:
            # every remaining level is deep
            return vocab_cuda.deep_descend(q, node, centers[l:upto], k)
        dots_all = q @ centers[l].to(torch.float32).T  # (N, G), exact integers
        owner = torch.arange(G, device=q.device) // k  # parent of column g
        masked = torch.where(owner[None, :] == node[:, None], dots_all,
                             torch.full_like(dots_all, -torch.inf))
        node = torch.argmax(masked, dim=1)  # first max
    return node


def transform_words(voc: Vocabulary, desc_sign: torch.Tensor) -> torch.Tensor:
    """(N, 256) sign descriptors -> (N,) int64 word ids (leaf indices)."""
    if desc_sign.shape[0] <= _CHUNK:
        return _descend(voc.centers, desc_sign, voc.k, voc.levels)
    return torch.cat([_descend(voc.centers, desc_sign[s:s + _CHUNK], voc.k, voc.levels)
                      for s in range(0, desc_sign.shape[0], _CHUNK)])


# -- sparse BoW -------------------------------------------------------------


def bow_sparse(words: torch.Tensor, valid: torch.Tensor, idf: torch.Tensor,
               n_words: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(N,) word ids + validity -> fixed-width sparse BoW.

    Returns ``(uwords, uvals)``, each (N,): unique word ids with merged,
    L1-normalized TF-IDF weights; padding entries are (word 0, weight 0).
    Lane form: (B, N) in, (B, N) out, each lane on its own.
    """
    del n_words  # the reference's static width; the shapes carry it here
    w = torch.where(valid, idf[words], 0.0)
    big = torch.iinfo(torch.int32).max
    order = torch.argsort(torch.where(valid, words, big), dim=-1, stable=True)
    sw, sv = words.gather(-1, order), valid.gather(-1, order)
    svw = torch.where(sv, w.gather(-1, order), 0.0)
    first = sv.clone()
    first[..., 1:] &= sw[..., 1:] != sw[..., :-1]
    # duplicate merge as a segment sum over the sorted runs; invalid rows
    # sort to the tail with zero weight
    seg = torch.clamp(torch.cumsum(first.to(torch.int64), -1) - 1, min=0)
    sums = torch.zeros_like(svw).scatter_add_(-1, seg, svw)
    uw = torch.where(first, sw, torch.zeros_like(sw))
    uv = torch.where(first, sums.gather(-1, seg), 0.0)
    return uw, uv / torch.clamp(uv.sum(-1, keepdim=True), min=1e-12)


def bin_of_sparse(uw: torch.Tensor, uv: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Sparse BoW -> (n_bins,) histogram over word id mod n_bins ((B, n_bins)
    for (B, N) lanes)."""
    return torch.zeros(uv.shape[:-1] + (n_bins,), dtype=torch.float32,
                       device=uv.device).scatter_add_(-1, uw.to(torch.int64) % n_bins, uv)


def score_db_binned(q_bins: torch.Tensor, db_bins: torch.Tensor) -> torch.Tensor:
    """Shortlist scores: one (capacity, n_bins) @ (n_bins,) bf16 matvec
    (per lane for (B, capacity, n_bins) and (B, n_bins))."""
    q = q_bins.to(torch.bfloat16)[..., None]
    return (db_bins.to(torch.bfloat16) @ q)[..., 0].to(torch.float32)


def score_pair_min(uw, uv, w, v) -> torch.Tensor:
    """Exact min-intersection of two merged-unique sparse rows (per lane
    for (B, N) rows)."""
    eq = w[..., :, None] == uw[..., None, :]
    m = torch.minimum(v[..., :, None], uv[..., None, :])
    return torch.where(eq, m, 0.0).sum((-2, -1))


def rescore_min(uw, uv, cw, cv) -> torch.Tensor:
    """Exact min-intersection of the query vs C candidate sparse rows: (C,)
    (lane form: (B, N) query, (B, C, N) candidates -> (B, C))."""
    eq = cw[..., :, :, None] == uw[..., None, None, :]
    m = torch.minimum(cv[..., :, :, None], uv[..., None, None, :])
    return torch.where(eq, m, 0.0).sum(dim=(-2, -1))
