"""Hierarchical binary-descriptor vocabulary and sparse bag-of-words scoring.

Port of ``ros_stereo_slam_tpu/models/vocab.py``.  The tree is a dense
per-level table of int8 sign centers (``centers[l]``: (k^(l+1), 256));
node n's children are rows [n k, (n + 1) k).  At the reference scale
(k = 9, L = 6: 531,441 words) the tables hold ~153 MB.  They stay the
persistent form (save, load, :mod:`.convert`).

- :func:`pack_centers` packs every level at one bit per component into
  one (R, 8) int32 table, :class:`PackedTree` (19.1 MB at the reference
  scale), the port's counterpart of the reference's
  ``prepare_centers_for_scan``: a one-time preparation before any frame
  loop.  :meth:`Vocabulary.packed` builds it once per vocabulary.
- The descent walks descriptors from the root down the packed tree by
  the first min of the Hamming distance, which for +-1 vectors is the
  first max of the sign dot product (dot = 256 - 2 ham), so the word
  ids are the reference's bit for bit.  :func:`.vocab_cuda.descend`
  launches kernel K3 for all levels on CUDA tensors and takes
  :func:`_descend_packed_plain` on CPU tensors.  :func:`_descend` is the
  counterpart of the reference's ``_descend`` on sign rows; the full-SLAM
  path descends ORB's packed words directly.
- :func:`train` is the reference's host-recursive trainer (the
  small-vocabulary oracle): numpy's ``default_rng`` draws, first-max
  argmax assignments on `device`.  Dots of +-1 vectors are exact
  integers in float32, so its centres and IDF equal the reference's bit
  for bit, on the CPU and on the card.
- :func:`train_batched` is the level-synchronous trainer.  Its random
  draws come from a CPU ``torch.Generator`` and are moved to the device;
  everything after them is exact integer work, so a seed gives the same
  vocabulary on the CPU and on the card (not JAX's: its keys differ).
- The dense BoW oracles (:func:`bow_row`, :func:`score_l1`,
  :func:`dense_of_sparse`, :func:`score_db_sparse`,
  :func:`score_pair_sparse`) are the reference's test forms, O(n_words)
  per row: not for the reference scale.
- The sparse BoW, binned shortlist and exact min-intersection rescore
  are the reference's formulas (see its module docstring).  Each also
  takes a leading lane axis (the batched-lane drivers), every lane
  sorted, merged and scored on its own; lanes descend the tree as one
  flattened (B N, 8) batch.

The reference's dense masked-argmax levels and its deep-table tail pad
(``vocab_pallas.pad_table``) are TPU mechanics and are not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.ops import orb
from ros_stereo_slam_tpu_torch.ops.orb import N_BITS

# Descriptors (or table rows) per block in the trainer and pack_centers.
_CHUNK = 8192


@dataclass(frozen=True)
class PackedTree:
    """Every level's sign centers at one bit per component, levels one
    after another (:func:`pack_centers`)."""

    words: torch.Tensor  # (R, 8) int32: bit j of word w = component 32 w + j is +1
    offsets: tuple  # (L + 1,) ints: level l is rows offsets[l] .. offsets[l + 1] - 1

    @property
    def levels(self) -> int:
        return len(self.offsets) - 1

    def to(self, device) -> "PackedTree":
        return PackedTree(words=self.words.to(device), offsets=self.offsets)


def pack_centers(centers, k: int) -> PackedTree:
    """Pack the int8 sign tables (level l: (k^(l+1), 256)) into one
    :class:`PackedTree`, in ``orb.pack_bits``'s layout.

    Raises ValueError, naming the level and row, on a table of another
    shape or on any entry outside {-1, +1}: the packed descent is exact
    only for sign vectors (both trainers give nothing else).
    """
    words, offsets = [], [0]
    for l, c in enumerate(centers):
        if c.dim() != 2 or tuple(c.shape) != (k ** (l + 1), N_BITS):
            raise ValueError(f"level {l}: table of shape {tuple(c.shape)}, expected "
                             f"({k ** (l + 1)}, {N_BITS})")
        bad = (c != 1) & (c != -1)
        if bool(bad.any()):
            row, col = (int(i) for i in bad.nonzero()[0])
            raise ValueError(f"level {l} row {row}: entry {int(c[row, col])} at component "
                             f"{col}; centers must be -1 or +1")
        words += [orb.pack_bits(c[s:s + _CHUNK] > 0) for s in range(0, c.shape[0], _CHUNK)]
        offsets.append(offsets[-1] + c.shape[0])
    if not words:
        raise ValueError("no levels to pack")
    return PackedTree(words=torch.cat(words).contiguous(), offsets=tuple(offsets))


@dataclass
class Vocabulary:
    k: int  # branching factor
    levels: int  # tree depth (leaves = k**levels words)
    centers: list  # per level l: (k**(l+1), 256) int8 sign vectors (tensors)
    idf: torch.Tensor  # (k**levels,) float32 word weights
    # The packed tree, built by packed() on first use; centers are not to
    # be changed after that.
    _tree: PackedTree | None = field(default=None, repr=False, compare=False)

    @property
    def n_words(self) -> int:
        return self.k**self.levels

    def packed(self) -> PackedTree:
        """The tree packed for the descent, built once per vocabulary."""
        if self._tree is None:
            self._tree = pack_centers(self.centers, self.k)
        return self._tree

    def to(self, device) -> "Vocabulary":
        return Vocabulary(k=self.k, levels=self.levels,
                          centers=[c.to(device) for c in self.centers],
                          idf=self.idf.to(device),
                          _tree=None if self._tree is None else self._tree.to(device))

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


def _kmeans_signs(X: np.ndarray, k: int, iters: int = 8, seed: int = 0,
                  device="cpu") -> np.ndarray:
    """Binary k-means on (N, 256) {-1,+1} vectors -> (k, 256) sign centers.

    The reference's draws (numpy ``default_rng(seed)``) and votes on the
    host; the assignment dots on `device`."""
    n = X.shape[0]
    rng = np.random.default_rng(seed)
    if n == 0:
        return rng.choice([-1.0, 1.0], size=(k, N_BITS)).astype(np.float32)
    init = X[rng.choice(n, size=min(k, n), replace=False)]
    C = np.concatenate(
        [init, rng.choice([-1.0, 1.0], size=(k - init.shape[0], N_BITS))]
    ).astype(np.float32)
    Xd = torch.from_numpy(X).to(device)
    for _ in range(iters):
        # Hamming == argmax dot for sign vectors (first max on ties).
        assign = _argmax_dot(Xd, C)
        for c in range(k):
            sel = X[assign == c]
            if sel.shape[0]:
                # bit-wise majority vote == sign of mean
                m = sel.mean(axis=0)
                C[c] = np.where(m >= 0, 1.0, -1.0)
            else:
                C[c] = X[rng.integers(n)]
    return C


def _argmax_dot(Xd: torch.Tensor, C: np.ndarray) -> np.ndarray:
    """(N,) first argmax over the k centers of each row's dot product."""
    Cd = torch.from_numpy(C).to(Xd.device)
    return torch.argmax(Xd @ Cd.T, dim=1).cpu().numpy()


def train(
    descriptors, k: int = 9, levels: int = 4, seed: int = 0,
    doc_ids: np.ndarray | None = None, device="cuda",
) -> Vocabulary:
    """Host-recursive trainer from (N, 256) sign descriptors (array or tensor).

    The small-vocabulary oracle (tests, tiny worlds): the recursion visits
    every internal node in Python; for reference-scale vocabularies use
    :func:`train_batched`.  `doc_ids` (N,) frame ids give TF-IDF weights
    (uniform weights without them); the IDF's descent runs on `device`
    (kernel K3 on the card).
    """
    X = np.asarray(torch.as_tensor(descriptors).cpu(), dtype=np.float32)
    # per-level center tables
    centers = [np.zeros((k ** (l + 1), N_BITS), np.float32) for l in range(levels)]

    def recurse(data: np.ndarray, level: int, node: int, seed_: int):
        C = _kmeans_signs(data, k, seed=seed_, device=device)
        centers[level][node * k : (node + 1) * k] = C
        if level + 1 == levels:
            return
        if data.shape[0]:
            assign = _argmax_dot(torch.from_numpy(data).to(device), C)
        else:
            assign = np.zeros((0,), np.int64)
        for c in range(k):
            recurse(data[assign == c], level + 1, node * k + c, seed_ * k + c + 1)

    recurse(X, 0, 0, seed + 1)
    voc = Vocabulary(k=k, levels=levels,
                     centers=[torch.from_numpy(c.astype(np.int8)).to(device) for c in centers],
                     idf=torch.ones((k**levels,), dtype=torch.float32, device=device))
    _idf_of(voc, torch.from_numpy(X).to(device), doc_ids)
    return voc


def build_vocab(descriptors, k: int, levels: int, doc_ids: np.ndarray | None = None,
                device="cuda") -> Vocabulary:
    """The trainer the vocabulary CLI picks: :func:`train` up to 4,096
    words, :func:`train_batched` above (the reference tool's rule)."""
    trainer = train_batched if k ** levels > 4096 else train
    return trainer(descriptors, k=k, levels=levels, doc_ids=doc_ids, device=device)


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


def _descend_packed_plain(q_bits: torch.Tensor, valid: torch.Tensor, tree: PackedTree, k: int,
                          n_levels: int) -> torch.Tensor:
    """The plain version of kernel K3: (N, 8) packed words and (N,)
    validity -> (N,) int64 node ids at level `n_levels`.

    Per level, gather each descriptor's k packed sibling rows, XOR,
    count the set bits (a byte table), take the first min
    (``torch.argmin``); invalid rows take child 0.  Exact.
    """
    node = torch.zeros((q_bits.shape[0],), dtype=torch.int64, device=q_bits.device)
    table = orb.POPCOUNT8.to(q_bits.device)
    kk = torch.arange(k, device=q_bits.device)
    for l in range(n_levels):
        first = node * k
        cand = tree.words[tree.offsets[l] + first[:, None] + kk]  # (N, k, 8)
        x = (q_bits[:, None, :] ^ cand).contiguous().view(torch.uint8)  # (N, k, 32)
        ham = table[x.to(torch.int64)].sum(-1)  # (N, k)
        node = torch.where(valid, first + torch.argmin(ham, dim=1), first)
    return node


def _pack_signs(desc_sign: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 256) sign rows -> ((N, 8) packed words, (N,) valid = any nonzero).

    Raises ValueError unless every row is all +-1 or all 0 (a feature or
    an invalid feature's zero row)."""
    valid = (desc_sign != 0).any(1)
    signs = (desc_sign == 1) | (desc_sign == -1)
    bad = valid & ~signs.all(1)
    if bool(bad.any()):
        row = int(bad.nonzero()[0, 0])
        raise ValueError(f"descriptor row {row} is neither all +-1 nor all 0")
    return orb.pack_bits(desc_sign > 0), valid


def _descend(centers, desc_sign: torch.Tensor, k: int, upto: int) -> torch.Tensor:
    """Argmax descent: (N, 256) sign descriptors (invalid rows all zero) ->
    (N,) int64 node ids at level `upto`.

    `centers`: the int8 tables, or their :class:`PackedTree` (packed once
    by the caller).  Packs the rows and descends through
    :func:`.vocab_cuda.descend`.
    """
    from ros_stereo_slam_tpu_torch.ops import vocab_cuda

    tree = centers if isinstance(centers, PackedTree) else pack_centers(centers[:upto], k)
    q_bits, valid = _pack_signs(desc_sign)
    return vocab_cuda.descend(q_bits, valid, tree, k, upto)


def transform_words(voc: Vocabulary, desc_sign: torch.Tensor) -> torch.Tensor:
    """(N, 256) sign descriptors -> (N,) int64 word ids (leaf indices)."""
    return _descend(voc.packed(), desc_sign, voc.k, voc.levels)


# -- dense BoW (oracle form, small vocabularies) ------------------------------


def bow_row(words: torch.Tensor, valid: torch.Tensor, idf: torch.Tensor,
            n_words: int) -> torch.Tensor:
    """Sparse word list -> L1-normalized TF-IDF dense BoW row (n_words,).

    The test oracle for the sparse form below; O(n_words) storage.
    """
    w = torch.where(valid, idf[words], 0.0)
    row = torch.zeros((n_words,), dtype=torch.float32, device=w.device).index_add_(
        0, words.to(torch.int64), w)
    return row / torch.clamp(row.abs().sum(), min=1e-12)


def score_l1(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score: s = 1 - 0.5 * |q - d|_1, batched over db rows."""
    return 1.0 - 0.5 * torch.abs(query[None, :] - db).sum(1)


def dense_of_sparse(uw: torch.Tensor, uv: torch.Tensor, n_words: int) -> torch.Tensor:
    """Scatter a sparse BoW into its dense (n_words,) row."""
    return torch.zeros((n_words,), dtype=torch.float32, device=uv.device).index_add_(
        0, uw.to(torch.int64), uv)


def score_db_sparse(q_dense: torch.Tensor, db_words: torch.Tensor,
                    db_wvals: torch.Tensor) -> torch.Tensor:
    """Min-intersection L1 score of a dense query row against the sparse
    database (merged-unique rows, zero-weight padding): (capacity,)."""
    return torch.minimum(q_dense[db_words.to(torch.int64)], db_wvals).sum(1)


def score_pair_sparse(q_dense: torch.Tensor, w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Min-intersection score of a dense query row vs ONE sparse row."""
    return torch.minimum(q_dense[w.to(torch.int64)], v).sum()


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
