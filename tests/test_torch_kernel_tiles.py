"""The shared-memory tile addressing of kernels K1 and K2, emulated on the CPU.

The CUDA kernels stage a tile of the image per block and take every tap of
every bilinear sample from it.  What can go wrong there is the addressing,
and that is plain index arithmetic, written out here in PyTorch line by
line as ``csrc/orb_desc.cu`` and ``csrc/lk_level.cu`` do it:

- K2: the corner's 44 x 44 patch has the origin floor(corner) - 21, NOT
  clamped into the image; the sample position is clamped as
  ``interp.bilinear_at`` clamps it and then addressed relative to that
  origin.  Patch pixels outside the image are filled with NaN here (0 in
  the kernel), so a tap that touched one would show.  The sampled values
  must be bitwise ``interp.bilinear_at``'s, for the centroid offsets and
  for the rotated pattern at several angles, on corners 17, 18, 20 and 21
  px from every border (17 is the nearest a valid corner comes) and in
  the interior, at two image sizes.  For an integer corner the centroid
  sample is one patch read, bitwise ``bilinear_at``'s value again.
- K1: the (n + 1)^2 footprint at the clamped ``tile_start`` (as
  ``chip_smoke._tile_start`` states it), staged row by row; the samples
  taken from the staged tile must be bitwise the kernel's earlier four-tap
  reads from the image, every staged pixel must lie inside the image, and
  away from the borders the patch must be bitwise
  ``interp.extract_patches``'s.

- K3: the packed-tree addressing of ``csrc/vocab_descend.cu``: lane 2 j + h
  of a query's warp reads the tree as 16-byte vectors at index
  2 (offset[l] + node k + j) + h, 16 siblings a pass, over a random packed
  tree at the reference scale (k = 9, L = 6: 597,870 rows) and at k = 20
  (two passes).
  The emulated descent must give ``vocab._descend_packed_plain``'s node ids
  exactly, invalid rows included, and reach a planted word: the first
  (word 0), one in the middle, and the last group of the 531,441-row level.

Exact comparisons: the emulation and its reference evaluate the same f32
expression on the same pixels (K1, K2) or count the same bits (K3).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ros_stereo_slam_tpu_torch.data.synthetic import _smooth_noise_2d
from ros_stereo_slam_tpu_torch.models import vocab
from ros_stereo_slam_tpu_torch.ops import interp, orb

PATCH, CENTRE, RADIUS = 44, 21, 15  # kPatch, kCentre, kRadius of orb_desc.cu
SIZES = {"kitti_l3": (193, 635), "small": (64, 96)}
BORDER_DISTANCES = (17, 18, 20, 21)


def _image(shape):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    return torch.from_numpy(_smooth_noise_2d(shape, rng, octaves=4, base_period=16))


def _corner(shape, where, d):
    h, w = shape
    return {"left": (d, h // 2), "right": (w - 1 - d, h // 2 - 3), "top": (w // 2, d),
            "bottom": (w // 3, h - 1 - d), "interior": (w // 2, h // 2),
            "top_left": (d, d), "bottom_right": (w - 1 - d, h - 1 - d)}[where]


def _stage_patch(img, px, py):
    """orb_desc.cu's staging: origin floor(corner) - 21, unclamped; pixels
    outside the image NaN (the kernel writes 0 there and never reads it)."""
    h, w = img.shape
    ox, oy = int(np.floor(px)) - CENTRE, int(np.floor(py)) - CENTRE
    tile = torch.full((PATCH, PATCH), float("nan"))
    ys = torch.arange(PATCH) + oy
    xs = torch.arange(PATCH) + ox
    iy = (ys >= 0) & (ys < h)
    ix = (xs >= 0) & (xs < w)
    tile[iy[:, None] & ix[None, :]] = img[ys[iy]][:, xs[ix]].reshape(-1)
    return tile, ox, oy


def _patch_bilinear(tile, ox, oy, shape, pos):
    """orb_desc.cu's bilinear_at on the staged patch: clamp the position into
    the image, address relative to the patch origin; the same f32
    expression as interp.bilinear_at.  Returns (values, all taps in patch)."""
    h, w = shape
    x = torch.clamp(torch.nan_to_num(pos[:, 0]), 0.0, w - 1.001)
    y = torch.clamp(torch.nan_to_num(pos[:, 1]), 0.0, h - 1.001)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    fx, fy = x - x0, y - y0
    tx, ty = x0 - ox, y0 - oy
    in_patch = bool(((tx >= 0) & (tx < PATCH - 1) & (ty >= 0) & (ty < PATCH - 1)).all())
    v00, v01 = tile[ty, tx], tile[ty, tx + 1]
    v10, v11 = tile[ty + 1, tx], tile[ty + 1, tx + 1]
    val = (v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx
           + v10 * fy * (1 - fx) + v11 * fy * fx)
    return val, in_patch


CASES = [(size, where, d) for size in SIZES for where in ("left", "right", "top", "bottom")
         for d in BORDER_DISTANCES]
CASES += [(size, where, 17) for size in SIZES
          for where in ("interior", "top_left", "bottom_right")]


@pytest.mark.parametrize("size,where,d", CASES)
def test_k2_patch_taps_are_bilinear_at(size, where, d):
    shape = SIZES[size]
    img = _image(shape)
    px, py = _corner(shape, where, d)
    corner = torch.tensor([float(px), float(py)])
    tile, ox, oy = _stage_patch(img, px, py)
    cent = torch.from_numpy(orb._CENT)
    pat = torch.cat([torch.from_numpy(orb._PAT_P), torch.from_numpy(orb._PAT_Q)])
    # the centroid samples, then the pattern rotated by several angles
    groups = [corner + cent]
    for ang in (0.0, 0.7, 1.5707964, 2.9, -2.2, 3.1415927):
        ca, sa = np.float32(np.cos(ang)), np.float32(np.sin(ang))
        rot = torch.stack([ca * pat[:, 0] + (-sa) * pat[:, 1], sa * pat[:, 0] + ca * pat[:, 1]], 1)
        groups.append(rot + corner)
    for pos in groups:
        got, in_patch = _patch_bilinear(tile, ox, oy, shape, pos)
        assert in_patch  # no tap of a valid corner needs the kernel's image route
        want = interp.bilinear_at(img, pos)
        assert torch.isfinite(got).all()  # no tap touched a pixel outside the image
        assert torch.equal(got, want)
    # the integer-corner route: one patch read per centroid sample
    assert px - RADIUS >= 0 and px + RADIUS <= shape[1] - 2
    assert py - RADIUS >= 0 and py + RADIUS <= shape[0] - 2
    direct = tile[CENTRE + cent[:, 1].long(), CENTRE + cent[:, 0].long()]
    assert torch.equal(direct, interp.bilinear_at(img, corner + cent))


@pytest.mark.parametrize("px,py", [(20.5, 30.25), (70.75, 40.5)])
def test_k2_patch_taps_non_integer_corner(px, py):
    """A non-integer corner takes the general route for its centroid too."""
    shape = SIZES["small"]
    img = _image(shape)
    tile, ox, oy = _stage_patch(img, px, py)
    pos = torch.tensor([px, py]) + torch.from_numpy(orb._CENT)
    got, in_patch = _patch_bilinear(tile, ox, oy, shape, pos)
    assert in_patch
    assert torch.equal(got, interp.bilinear_at(img, pos))


def _k1_tile(img, pos_xy, n):
    """lk_level.cu's staged footprint for an n x n sample patch whose
    top-left sample sits at `pos_xy`: ((n + 1, n + 1) tile, y0, x0, fy, fx)
    with the start clamped and the fraction taken against the clamped start."""
    h, w = img.shape
    x0 = int(chip_smoke._tile_start(torch, pos_xy[0], n, w))
    y0 = int(chip_smoke._tile_start(torch, pos_xy[1], n, h))
    assert 0 <= y0 and y0 + n + 1 <= h and 0 <= x0 and x0 + n + 1 <= w  # reads stay inside
    k = torch.arange((n + 1) * (n + 1))  # the kernel's flat staging index
    r = k // (n + 1)
    tile = img.reshape(-1)[(y0 + r) * w + x0 + (k - r * (n + 1))].reshape(n + 1, n + 1)
    return tile, y0, x0, pos_xy[1] - y0, pos_xy[0] - x0


def _bilerp(p00, p01, p10, p11, fx, fy):
    top = p00 * (1.0 - fx) + p01 * fx
    bot = p10 * (1.0 - fx) + p11 * fx
    return top * (1.0 - fy) + bot * fy


K1_POINTS = {"interior": (48.3, 31.6), "left": (2.4, 30.0), "right": (93.7, 20.2),
             "top": (40.5, 1.1), "bottom": (50.0, 62.9), "corner": (0.0, 0.0),
             "outside": (-3.5, 70.0)}


@pytest.mark.parametrize("window", [15, 21])
@pytest.mark.parametrize("where", list(K1_POINTS))
def test_k1_staged_tile_matches_four_tap_reads(where, window):
    shape = SIZES["small"]
    img = _image(shape)
    h, w = shape
    pt = torch.tensor(K1_POINTS[where])
    half = (window - 1) * 0.5
    for n, pos in ((window, pt - half), (window + 2, pt - half - 1.0)):  # sample, template
        tile, y0, x0, fy, fx = _k1_tile(img, pos, n)
        from_tile = _bilerp(tile[:-1, :-1], tile[:-1, 1:], tile[1:, :-1], tile[1:, 1:], fx, fy)
        # the one-warp-per-point body: four reads from the image per sample
        rr, cc = torch.meshgrid(torch.arange(n), torch.arange(n), indexing="ij")
        base = (y0 + rr) * w + x0 + cc
        flat = img.reshape(-1)
        four_tap = _bilerp(flat[base], flat[base + 1], flat[base + w], flat[base + w + 1], fx, fy)
        assert torch.equal(from_tile, four_tap)
        inside = (half + 2 <= pt[0] < w - half - 2) and (half + 2 <= pt[1] < h - half - 2)
        if inside:  # no clamp: the plain version's patch, bitwise
            centre = pos + (n - 1) * 0.5
            assert torch.equal(from_tile, interp.extract_patches(img, centre[None], n)[0])


# -- K3: the packed-tree addressing of vocab_descend.cu ----------------------

K3_K, K3_L = 9, 6
K3_SIBLINGS_PER_PASS, K3_IDX_BITS = 16, 22  # kSiblingsPerPass, kIdxBits of vocab_descend.cu


def _random_tree(k, levels, seed):
    offsets = [0]
    for l in range(levels):
        offsets.append(offsets[-1] + k ** (l + 1))
    rng = np.random.default_rng(seed)
    words = rng.integers(-2**31, 2**31, size=(offsets[-1], 8), dtype=np.int64)
    return vocab.PackedTree(words=torch.from_numpy(words.astype(np.int32)),
                            offsets=tuple(offsets))


@pytest.fixture(scope="module")
def k3_tree():
    """Random packed words at the reference scale (19.1 MB)."""
    return _random_tree(K3_K, K3_L, seed=21)


def _popc(x):
    """Set bits per 32-bit word of an int32 tensor."""
    b = orb.POPCOUNT8[x.contiguous().view(torch.uint8).to(torch.int64)]
    return b.reshape(x.shape + (4,)).sum(-1)


def _k3_emulated(q_bits, valid, tree, k, n_levels):
    """vocab_descend.cu's descend_packed: a warp per query, lanes 2 j
    and 2 j + 1 read the two 16-byte halves of sibling row j (16 siblings a
    pass); the halves add, and the warp's min of (ham << 22 | j) is the
    first min."""
    vec = tree.words.reshape(-1, 4)  # the tree as uint4
    lane = torch.arange(32)
    half, jl = lane % 2, lane // 2
    qh = q_bits.reshape(-1, 4)[2 * torch.arange(q_bits.shape[0])[:, None] + half]  # (N, 32, 4)
    node = torch.zeros(q_bits.shape[0], dtype=torch.int64)
    for l in range(n_levels):
        first = node * k
        assert bool((first + k <= tree.offsets[l + 1] - tree.offsets[l]).all())
        group = 2 * (tree.offsets[l] + first)[:, None] + half  # uint4 index of each lane's half
        best = torch.full_like(node, 2**31 - 1)
        for j0 in range(0, k, K3_SIBLINGS_PER_PASS):
            j = j0 + jl
            live = j < k
            at = torch.where(live, group + 2 * j, group)  # dead lanes load nothing
            ham = torch.where(live, _popc(qh ^ vec[at]).sum(-1), 0)
            ham = ham.reshape(-1, 16, 2).sum(-1, keepdim=True).expand(-1, 16, 2).reshape(-1, 32)
            key = torch.where(live, (ham << K3_IDX_BITS) | j, torch.full_like(ham, 2**31 - 1))
            best = torch.minimum(best, key.min(1).values)
        node = torch.where(valid, first + (best & ((1 << K3_IDX_BITS) - 1)), first)
    return node


@pytest.mark.parametrize("target", ["first", "middle", "last"])
@pytest.mark.parametrize("k,levels", [(K3_K, K3_L), (20, 3)])
def test_k3_packed_tree_addressing(k3_tree, k, levels, target):
    """The reference-scale tree, and k = 20 (two passes of 16 siblings)."""
    tree = k3_tree if (k, levels) == (K3_K, K3_L) else _random_tree(k, levels, seed=22)
    word = {"first": 0, "middle": k ** levels // 2 + 7, "last": k ** levels - 1}[target]
    rng = np.random.default_rng(word)
    q = torch.from_numpy(rng.integers(-2**31, 2**31, size=(97, 8), dtype=np.int64)
                         .astype(np.int32))
    valid = torch.ones(97, dtype=torch.bool)
    valid[1::7] = False
    words = tree.words.clone()
    for l in range(levels):  # plant query 0 on the path to `word`: distance 0 at every level
        words[tree.offsets[l] + word // k ** (levels - 1 - l)] = q[0]
    tree = vocab.PackedTree(words=words, offsets=tree.offsets)
    got = _k3_emulated(q, valid, tree, k, levels)
    want = vocab._descend_packed_plain(q, valid, tree, k, levels)
    assert torch.equal(got, want)
    assert got[0].item() == word
    assert not got[1::7].any()  # invalid rows: child 0 at every level
    if target == "last":
        assert tree.offsets[levels] - 1 == tree.offsets[levels - 1] + word  # the level's last row
