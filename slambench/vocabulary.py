"""The vocabulary a full-SLAM configuration loads, made by the benchmark.

It stands in for the pretrained file a user loads (DBoW2's practice): a
k-ary tree of sign centres over ORB descriptors, trained from worlds that
no cell measures.  The descriptors are rotated-BRIEF signs
(:func:`.reference.orb.signs`) at FAST-9 corners of those worlds' left
frames, found on an image pyramid by the plain detector
(:mod:`.reference.fast`) with the configuration's levels, scale and
threshold; the trainer is a frozen copy of the port's level-synchronous
``models/vocab.py::train_batched`` (k-means on signs, majority-vote
centres, TF-IDF weights).  Everything here is exact integer work after the
draws, which come from a CPU ``torch.Generator``, so the same
specification gives the same tables on any device.

The tables are made once per checkout and kept under
``build/slambench/``, keyed by the specification and the camera; later
runs load them, as a user loads the file.
"""

from __future__ import annotations

import hashlib
import json
import os
from pathlib import Path

import numpy as np
import torch

from slambench import world as world_mod
from slambench.reference import fast as fast_ref
from slambench.reference import orb as orb_ref

_CHUNK = 8192
N_BITS = 256


def _assign(X, node, C, k):
    out = torch.empty_like(node)
    kk = torch.arange(k, device=X.device)
    for s in range(0, X.shape[0], _CHUNK):
        xc, nc = X[s:s + _CHUNK], node[s:s + _CHUNK]
        d = torch.einsum("nd,nkd->nk", xc, C[nc[:, None] * k + kk].to(torch.float32))
        out[s:s + _CHUNK] = nc * k + torch.argmax(d, dim=1)
    return out


def _update(X, g, C, G):
    S = torch.zeros((G, N_BITS), dtype=torch.float32, device=X.device).index_add_(0, g, X)
    cnt = torch.zeros((G,), dtype=torch.float32, device=X.device).index_add_(
        0, g, torch.ones_like(g, dtype=torch.float32))
    return torch.where(cnt[:, None] > 0, torch.where(S >= 0, 1, -1).to(torch.int8), C)


def _init(gen, X, node, k, G):
    n, dev = X.shape[0], X.device
    r = torch.rand((n,), generator=gen).to(dev)
    flips = (torch.rand((G, N_BITS), generator=gen) < 0.5).to(dev)
    by_r = torch.argsort(r, stable=True)
    order = by_r[torch.argsort(node[by_r], stable=True)]
    sn = node[order]
    seg = torch.ones((n,), dtype=torch.bool, device=dev)
    seg[1:] = sn[1:] != sn[:-1]
    idx = torch.arange(n, device=dev)
    rank = idx - torch.cummax(torch.where(seg, idx, torch.zeros_like(idx)), 0).values
    keep = rank < k
    C = torch.where(flips, 1, -1).to(torch.int8)
    C[(sn * k + rank)[keep]] = X[order][keep].to(torch.int8)
    return C


def train(X: torch.Tensor, doc_ids: np.ndarray, k: int, levels: int, iters: int, seed: int):
    """(N, 256) +-1 float32 descriptors -> (centres per level, (k^L,) idf,
    the number of words that some descriptor reached)."""
    gen = torch.Generator().manual_seed(int(seed))
    node = torch.zeros((X.shape[0],), dtype=torch.int64, device=X.device)
    centers = []
    for level in range(levels):
        G = k ** (level + 1)
        C = _init(gen, X, node, k, G)
        for _ in range(iters):
            C = _update(X, _assign(X, node, C, k), C, G)
        node = _assign(X, node, C, k)
        centers.append(C)
    n_words = k**levels
    pair = np.asarray(doc_ids, np.int64) * n_words + node.cpu().numpy()
    df = np.bincount(np.unique(pair) % n_words, minlength=n_words)
    idf = np.log(len(np.unique(doc_ids)) / np.maximum(df, 1)).astype(np.float32)
    idf[df == 0] = 0.0
    return centers, torch.from_numpy(idf).to(X.device), int((df > 0).sum())


def descriptors(spec: dict, cam: dict, device):
    """The training descriptors ((N, 256) +-1 float32) and the frame each
    came from, over every scene of ``spec["train_scenes"]``."""
    c = spec["corners"]
    margin = orb_ref.PATCH // 2 + 2
    w = [c["scale"] ** -lv for lv in range(c["levels"])]
    budgets = [int(c["per_frame"] * x / sum(w)) for x in w]
    descs, docs = [], []
    for si, scene in enumerate(spec["train_scenes"]):
        seeds = {"scene": int(scene), "plan": 0, "noise": 0}
        frames = world_mod.make_frames(spec["train_world"], cam, device, seeds)
        for f in range(len(frames)):
            img = frames.left[f].to(torch.float32) / 255.0
            for lvl_img, n in zip(fast_ref.pyramid(img, c["levels"], c["scale"]), budgets):
                pts = fast_ref.corners(lvl_img, c["fast_thresh"] / 255.0, n, margin)
                valid = torch.ones(pts.shape[0], dtype=torch.bool, device=device)
                descs.append(orb_ref.signs(lvl_img, pts, valid))
                docs.append(np.full(pts.shape[0], si * len(frames) + f))
    return torch.cat(descs), np.concatenate(docs)


def _key(spec: dict, cam: dict) -> str:
    text = json.dumps({"spec": spec, "camera": cam}, sort_keys=True)
    return hashlib.sha256(text.encode()).hexdigest()[:20]


def make(spec: dict, cam: dict, device, cache: Path):
    """A configuration's ``vocabulary`` object -> (centres, idf, info) on
    `device`: loaded from `cache` when this checkout made them before,
    else trained and kept there.  `info` says which, with the number of
    training descriptors and of words that hold one."""
    path = Path(cache) / f"vocabulary-{_key(spec, cam)}.pt"
    if path.exists():
        got = torch.load(path, map_location=device)
        return got["centers"], got["idf"], dict(got["info"], loaded=True)
    X, docs = descriptors(spec, cam, device)
    centers, idf, used = train(X, docs, spec["k"], spec["levels"], spec["iters"], spec["seed"])
    info = {"descriptors": int(X.shape[0]), "words_used": used, "words": int(idf.numel())}
    del X
    path.parent.mkdir(parents=True, exist_ok=True)
    part = path.with_suffix(".partial")
    torch.save({"centers": [c.cpu() for c in centers], "idf": idf.cpu(), "info": info}, part)
    os.replace(part, path)
    return centers, idf, dict(info, loaded=False)
