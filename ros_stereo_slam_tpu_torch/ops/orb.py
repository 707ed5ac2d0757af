"""Oriented-BRIEF (ORB) keypoints and binary descriptors.

Port of ``ros_stereo_slam_tpu/ops/orb.py``: FAST-9 (:mod:`.fast`) and
ANMS (:mod:`.anms`) pick the corners; the intensity-centroid moments over
a radius-15 circular patch give each corner's orientation; 256 rotated
BRIEF pairs from the reference's fixed Gaussian pattern give its bits.

The descriptor stage goes through :func:`.orb_cuda.level_describe`,
which routes by device: the hand-written kernel K2 for CUDA tensors (the
masking of invalid corners and the bit packing folded into its launch),
:func:`_level_describe_plain` (the reference's jnp route,
:func:`_descriptors_plain`, and that epilogue) for CPU tensors.
The pyramid levels are resized with the reference's bilinear resize
matrices, as two matmuls.

The corner stage (:func:`_corner_stage`: the pyramid, then FAST-9, the
exact top corners and ANMS on every level) reads nothing back to the host
and runs at shapes fixed by the image and the ORB parameters, so it goes
through ORB's graph family (:data:`..utils.cuda_graph.ORB`): on the card
one CUDA graph per image signature replays it, and the CPU runs it
eagerly.  K2 stays an eager call on the replay's outputs, one launch a
level, so a Python wrapper of ``orb_cuda.level_describe`` still sees
every call.

Packed descriptors are (N, 8) int32 holding the reference's uint32 bit
patterns (torch has no full uint32 support): bit j of word w is
descriptor bit 32 w + j.

Lane form (the batched-lane drivers): :func:`detect_and_compute` also
takes a (B, H, W) stack of lane images and returns (B, N, ...) features;
each ORB level's descriptors then go through the batched entry point of
the same kernel, one launch for all lanes.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.ops import anms, fast, interp
from ros_stereo_slam_tpu_torch.utils import cuda_graph

N_BITS = 256
PATCH = 31  # descriptor patch diameter
_PATTERN_SEED = 20260817


def _brief_pattern() -> tuple[np.ndarray, np.ndarray]:
    """(256, 2) + (256, 2) sampling offsets, Gaussian sigma = PATCH/5."""
    rng = np.random.default_rng(_PATTERN_SEED)
    sigma = PATCH / 5.0
    lim = PATCH // 2 - 1
    p = np.clip(rng.normal(0, sigma, (N_BITS, 2)), -lim, lim)
    q = np.clip(rng.normal(0, sigma, (N_BITS, 2)), -lim, lim)
    return p.astype(np.float32), q.astype(np.float32)


_PAT_P, _PAT_Q = _brief_pattern()


def _centroid_offsets() -> np.ndarray:
    """Circular-patch offsets (M, 2) xy for the intensity centroid (radius 15)."""
    r = PATCH // 2
    ys, xs = np.mgrid[-r : r + 1, -r : r + 1]
    keep = ys**2 + xs**2 <= r**2
    return np.stack([xs[keep], ys[keep]], axis=1).astype(np.float32)


_CENT = _centroid_offsets()


class OrbFeatures(NamedTuple):
    pts: torch.Tensor  # (N, 2) xy, level-0 (full-resolution) coordinates
    angle: torch.Tensor  # (N,) radians
    desc_bits: torch.Tensor  # (N, 8) int32 holding uint32 bit patterns
    desc_sign: torch.Tensor  # (N, 256) float32 in {-1, +1}; invalid rows 0
    valid: torch.Tensor  # (N,) bool
    octave: torch.Tensor  # (N,) int32 pyramid level of detection


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 256) bool -> (..., 8) int32 (uint32 bit patterns)."""
    b = bits.reshape(bits.shape[:-1] + (8, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (b << shifts).sum(-1)  # < 2^32
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """(..., 8) packed -> (..., 256) bool (inverse of :func:`pack_bits`)."""
    shifts = torch.arange(32, dtype=torch.int64, device=packed.device)
    b = ((packed.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return b.reshape(packed.shape[:-1] + (N_BITS,)).to(torch.bool)


def sign_of_packed(packed: torch.Tensor) -> torch.Tensor:
    """(N, 8) packed -> (N, 256) {-1, +1} float32."""
    return torch.where(unpack_bits(packed), 1.0, -1.0).to(torch.float32)


# Set bits of every byte value.
POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact Hamming distances between (N, 8) and (M, 8) packed sets:
    (N, M) int32, by a byte popcount table."""
    x = (a[:, None, :] ^ b[None, :, :]).contiguous().view(torch.uint8)  # (N, M, 32)
    return POPCOUNT8.to(a.device)[x.to(torch.int64)].sum(-1).to(torch.int32)


def hamming_mxu(sa: torch.Tensor, sb: torch.Tensor) -> torch.Tensor:
    """Hamming distance from sign vectors: (..., N, 256) x (..., M, 256) -> (..., N, M)."""
    return (N_BITS - sa @ sb.transpose(-1, -2)) * 0.5


@lru_cache(maxsize=8)
def _consts(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(centroid offsets (M, 2), pattern P (256, 2), pattern Q (256, 2)) on `device`."""
    return tuple(torch.from_numpy(a).to(device) for a in (_CENT, _PAT_P, _PAT_Q))


def _descriptors_plain(img: torch.Tensor, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of kernel K2 (the reference's jnp route).

    For (N, 2) integer corners on an (H, W) float32 image: the moments
    m10/m01 over the circular patch, the angle atan2(m01, m10), and the
    256 rotated pairs sampled bilinearly at absolute image positions
    (``interp.bilinear_at``'s border clamp).  Returns ((N, 256) float32
    +1 where vp < vq else -1, (N, 2) moments (m10, m01)).
    """
    n = pts.shape[0]
    cent, pat_p, pat_q = _consts(img.device)
    sample = pts[:, None, :] + cent[None, :, :]  # (N, M, 2)
    vals = interp.bilinear_at(img, sample.reshape(-1, 2)).reshape(n, -1)
    m10 = (vals * cent[None, :, 0]).sum(1)
    m01 = (vals * cent[None, :, 1]).sum(1)
    angle = torch.atan2(m01, m10)
    ca, sa = torch.cos(angle), torch.sin(angle)
    rot = torch.stack([torch.stack([ca, -sa], -1), torch.stack([sa, ca], -1)], -2)  # (N, 2, 2)
    rp = torch.einsum("nij,bj->nbi", rot, pat_p) + pts[:, None, :]  # (N, 256, 2)
    rq = torch.einsum("nij,bj->nbi", rot, pat_q) + pts[:, None, :]
    vp = interp.bilinear_at(img, rp.reshape(-1, 2)).reshape(n, N_BITS)
    vq = interp.bilinear_at(img, rq.reshape(-1, 2)).reshape(n, N_BITS)
    sign = torch.where(vp < vq, 1.0, -1.0).to(torch.float32)
    return sign, torch.stack([m10, m01], dim=1)


def _level_describe_plain(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor):
    """The plain version of kernel K2 with its folded epilogue
    (``orb_cuda.level_describe``): :func:`_descriptors_plain`, then the signs
    of invalid corners set to 0 and the bits packed (0 where invalid).  (N, 2)
    corners with (N,) `valid` on an (H, W) image, or lane by lane for
    (B, N, 2), (B, N) on a (B, H, W) stack.  Returns ((..., 256) signs,
    (..., 2) moments, (..., 8) int32 packed bits)."""
    if img.dim() == 3:
        outs = [_level_describe_plain(img[b], pts[b], valid[b]) for b in range(img.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    sign_k, m = _descriptors_plain(img, pts)
    bits = (sign_k > 0.0) & valid[..., None]
    sign = sign_k * valid[..., None]  # invalid rows -> zero vectors
    return sign, m, pack_bits(bits)


def _level_corners(img: torch.Tensor, budget: int, fast_thresh: float):
    """FAST-9 + exact top corners + ANMS on one level: (budget, 2) integer
    corners and their validity (>= PATCH // 2 + 2 px inside the image)."""
    h, w = img.shape[-2:]
    score = fast.fast_score(img, fast_thresh)
    cand_pts, cand_scores, cand_mask = fast.top_corners(score, 4 * budget)
    pts, valid = anms.anms(cand_pts, cand_scores, cand_mask, budget)
    return pts.contiguous(), valid & interp.in_bounds(pts, h, w, PATCH // 2 + 2)


def _level_budgets(n_features: int, n_levels: int, s: float) -> list[int]:
    """Per-level feature budgets summing to n_features, decaying by the
    scale factor per level (cv::ORB's geometric series)."""
    if n_features < 8 * n_levels:
        raise ValueError(
            f"n_features={n_features} cannot fund {n_levels} pyramid "
            f"levels at >=8 features each; lower n_levels or raise "
            f"n_features"
        )
    w = [s**-l for l in range(n_levels)]
    tot = sum(w)
    b = [max(int(round(n_features * x / tot)), 8) for x in w]
    # Rebalance rounding/clamp drift into level 0, then (if level 0 fell
    # under 8) shed the remainder from the other levels, largest first.
    b[0] += n_features - sum(b)
    if b[0] < 8:
        need = 8 - b[0]
        b[0] = 8
        for j in sorted(range(1, n_levels), key=lambda j: -b[j]):
            take = min(need, b[j] - 8)
            b[j] -= take
            need -= take
        if need:
            raise RuntimeError(f"level budgets infeasible: {n_features}, {n_levels}, {b}")
    return b


def _resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) bilinear-resample matrix (pixel-center convention)."""
    M = np.zeros((n_out, n_in), np.float32)
    ratio = n_in / n_out
    x = (np.arange(n_out) + 0.5) * ratio - 0.5
    x0 = np.clip(np.floor(x).astype(np.int64), 0, n_in - 1)
    x1 = np.minimum(x0 + 1, n_in - 1)
    t = np.clip(x - x0, 0.0, 1.0).astype(np.float32)
    M[np.arange(n_out), x0] += 1.0 - t
    M[np.arange(n_out), x1] += t
    return M


@lru_cache(maxsize=32)
def _resize_matrix_on(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_resize_matrix(n_in, n_out)).to(device)


def level_images(img: torch.Tensor, n_levels: int, scale_factor: float) -> list:
    """The ORB pyramid: level l is `img` resized by scale_factor^-l (at least
    32 px a side) with the reference's bilinear resize matrices."""
    h, w = img.shape[-2:]
    out = [img]
    for l in range(1, n_levels):
        s = scale_factor**l
        hl, wl = max(int(round(h / s)), 32), max(int(round(w / s)), 32)
        My = _resize_matrix_on(h, hl, img.device)
        Mx = _resize_matrix_on(w, wl, img.device)
        out.append((My @ img @ Mx.T).contiguous())
    return out


class OrbCorners(NamedTuple):
    """ORB's corner stage, level by level (:func:`_corner_stage`)."""

    images: tuple  # the level images 1..L-1 (level 0 is the caller's image)
    pts: tuple  # per level: (budget, 2) integer corners, level coordinates
    valid: tuple  # per level: (budget,) bool


def _corner_stage(img: torch.Tensor, n_features: int, n_levels: int, scale_factor: float,
                  fast_thresh: float) -> OrbCorners:
    """The pyramid of `img` and each level's corners (:func:`_level_corners`
    at the level's budget); per lane for a (B, H, W) stack."""
    budgets = ([n_features] if n_levels <= 1
               else _level_budgets(n_features, n_levels, scale_factor))
    images = level_images(img, len(budgets), scale_factor)
    corners = [_level_corners(lvl, b, fast_thresh) for lvl, b in zip(images, budgets)]
    return OrbCorners(tuple(images[1:]), *(tuple(c) for c in zip(*corners)))


def detect_and_compute(
    img: torch.Tensor,
    n_features: int = 512,
    fast_thresh: float = 12.0 / 255.0,
    n_levels: int = 1,
    scale_factor: float = 1.25,
) -> OrbFeatures:
    """ORB on a [0, 1] float32 grayscale image, optionally multi-scale.

    With `n_levels` > 1 the features come from a bilinear image pyramid
    at per-level downscale `scale_factor`; points are reported in level-0
    coordinates with their detection level, and descriptors are computed
    on the level image.  A (B, H, W) stack gives (B, n_features, ...).

    The corner stage goes through ORB's graph family (replayed on the
    card, eager on the CPU); the description, K2 a level, runs eagerly.
    """
    from ros_stereo_slam_tpu_torch.ops import orb_cuda

    h, w = img.shape[-2:]
    c = cuda_graph.ORB(_corner_stage, img=img, n_features=n_features, n_levels=n_levels,
                       scale_factor=scale_factor, fast_thresh=fast_thresh)
    parts = []
    for l, (lvl_img, pts, valid) in enumerate(zip((img, *c.images), c.pts, c.valid)):
        sign, m, bits = orb_cuda.level_describe(lvl_img, pts, valid)
        angle = torch.atan2(m[..., 1], m[..., 0])
        if l > 0:  # pixel-center mapping back to level 0: x0 = (x_l + 0.5) s - 0.5
            sy = float(np.float32(h / lvl_img.shape[-2]))
            sx = float(np.float32(w / lvl_img.shape[-1]))
            pts = torch.stack([(pts[..., 0] + 0.5) * sx - 0.5,
                               (pts[..., 1] + 0.5) * sy - 0.5], dim=-1)
        octave = torch.full(valid.shape, l, dtype=torch.int32, device=img.device)
        parts.append((pts, angle, bits, sign, valid, octave))
    point_axis = img.dim() - 2
    return OrbFeatures(*(torch.cat([p[i] for p in parts], dim=point_axis) for i in range(6)))
