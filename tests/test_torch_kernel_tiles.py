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

Exact comparisons: the emulation and its reference evaluate the same f32
expression on the same pixels.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ros_stereo_slam_tpu_torch.data.synthetic import _smooth_noise_2d
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
