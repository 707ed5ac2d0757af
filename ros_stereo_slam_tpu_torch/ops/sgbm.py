"""Dense stereo disparity (semi-global block matching) and its point cloud.

Port of ``ros_stereo_slam_tpu/ops/sgbm.py``, the reference's dense-disparity
node (``cv::StereoSGBM`` in ``StereoProcess::stereoMatch``,
``reference/src/StereoCV.cpp:21-62``: 96 disparities, block 7; the
reprojection ``reprojectDisparity``, ``:221-250``):

- the (H, W, D) SAD cost volume from D shifted-image absolute differences
  and a separable box filter, each a sum of 2r+1 shifted slices added in
  the reference's order, so the volume agrees with it to rounding;
- semi-global aggregation along scanlines in four directions.  The
  reference's ``lax.scan`` is a loop over the scan axis here, in plain
  PyTorch, one in-place row write per step (the JAX package has no
  Pallas kernel for it);
- winner-take-all (``argmin`` takes the first index among ties, as
  ``jnp.argmin`` does), parabolic sub-pixel refinement, a uniqueness test
  and a left-right check against the right-referenced volume.

:func:`depth_cloud` is the node's whole flow (``tools/stereo_depth.py``):
disparity -> cloud -> a 4,096-point subsample -> statistical outlier
removal.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.ops import sor
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


class DisparityResult(NamedTuple):
    disparity: torch.Tensor  # (H, W) float32, sub-pixel; -1 where invalid
    valid: torch.Tensor  # (H, W) bool


def _box_filter(x: torch.Tensor, r: int, axis: int) -> torch.Tensor:
    """Box filter of width 2r+1 along `axis` (edge-padded): the 2r+1
    shifted slices summed in order."""
    n = x.shape[axis]
    idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    xp = x.index_select(axis, idx)
    out = xp.narrow(axis, 0, n)
    for i in range(1, 2 * r + 1):
        out = out + xp.narrow(axis, i, n)
    return out


def cost_volume(left: torch.Tensor, right: torch.Tensor, max_disp: int,
                block: int = 7) -> torch.Tensor:
    """(H, W, D) SAD matching cost: cost[y, x, d] = block-SAD of
    left(y, x) against right(y, x - d).  Out-of-frame shifts cost 1e3."""
    r = block // 2
    xs = torch.arange(left.shape[1], device=left.device)
    big = torch.tensor(1e3, dtype=left.dtype, device=left.device)
    costs = []
    for d in range(max_disp):
        ad = torch.abs(left - torch.roll(right, d, dims=1))
        costs.append(torch.where(xs >= d, ad, big))
    vol = torch.stack(costs, dim=-1)
    return _box_filter(_box_filter(vol, r, 0), r, 1) / (block * block)


def _aggregate_dir(vol: torch.Tensor, p1: float, p2: float, axis: int,
                   reverse: bool) -> torch.Tensor:
    """SGM path aggregation along `axis`, in scan order (backwards with
    `reverse`):

      L(p, d) = C(p, d) + min(L(p-1, d), L(p-1, d+-1) + P1, min_d' L + P2)
                - min_d' L(p-1, d')
    """
    v = vol.movedim(axis, 0)
    agg = torch.empty_like(v)
    n = v.shape[0]
    order = range(n - 1, -1, -1) if reverse else range(n)
    first = order[0]
    agg[first] = v[first]
    prev = agg[first]
    for s in order[1:]:
        prev_min = prev.min(dim=-1, keepdim=True).values
        shift_p = torch.cat([prev[..., :1], prev[..., :-1]], dim=-1)
        shift_n = torch.cat([prev[..., 1:], prev[..., -1:]], dim=-1)
        best = torch.minimum(torch.minimum(prev, torch.minimum(shift_p, shift_n) + p1),
                             prev_min + p2)
        out = agg[s]
        torch.add(v[s], best, out=out)
        out.sub_(prev_min)
        prev = out
    return agg.movedim(0, axis)


def aggregate(vol: torch.Tensor, p1: float, p2: float, directions: int = 4) -> torch.Tensor:
    """Sum of the path costs along the first `directions` of left-to-right,
    right-to-left, top-down and bottom-up, added in that order."""
    agg = torch.zeros_like(vol)
    for axis, reverse in ((1, False), (1, True), (0, False), (0, True))[:directions]:
        agg = agg + _aggregate_dir(vol, p1, p2, axis, reverse)
    return agg


def sgbm(
    left: torch.Tensor,
    right: torch.Tensor,
    max_disp: int = 96,
    block: int = 7,
    p1: float = 0.03,
    p2: float = 0.12,
    uniqueness: float = 0.95,
    lr_thresh: float = 1.5,
    directions: int = 4,
) -> DisparityResult:
    """Semi-global block matching on (H, W) [0, 1] grayscale images.

    The parameters mirror the reference node's 96-disparity, block-7
    setup; the penalties are in [0, 1] intensity units.
    """
    vol = cost_volume(left, right, max_disp, block)
    return select_disparity(aggregate(vol, p1, p2, directions), max_disp, uniqueness, lr_thresh)


def select_disparity(agg: torch.Tensor, max_disp: int, uniqueness: float = 0.95,
                     lr_thresh: float = 1.5) -> DisparityResult:
    """Winner-take-all on an aggregated (H, W, D) volume, with parabolic
    sub-pixel refinement, the uniqueness test and the left-right check."""
    d_best = torch.argmin(agg, dim=-1)  # (H, W)
    c_best = torch.gather(agg, -1, d_best[..., None])[..., 0]
    d_lo = torch.clamp(d_best - 1, 0, max_disp - 1)
    d_hi = torch.clamp(d_best + 1, 0, max_disp - 1)
    c_lo = torch.gather(agg, -1, d_lo[..., None])[..., 0]
    c_hi = torch.gather(agg, -1, d_hi[..., None])[..., 0]
    denom = torch.clamp(c_lo + c_hi - 2.0 * c_best, min=1e-6)
    offset = torch.clamp(0.5 * (c_lo - c_hi) / denom, -0.5, 0.5)
    disp = d_best.to(torch.float32) + offset

    # Uniqueness: the best cost must beat the runner-up outside d_best +- 1.
    dd = torch.arange(max_disp, device=agg.device)
    near = torch.abs(dd - d_best[..., None]) <= 1
    second = torch.where(near, torch.full_like(agg, torch.inf), agg).min(dim=-1).values
    unique = c_best <= uniqueness * second

    # Left-right consistency against the right view's own WTA disparity.
    d_right = torch.argmin(_right_volume_from_left(agg, max_disp), dim=-1)
    xs = torch.arange(disp.shape[1], device=agg.device)
    xr = torch.clamp(xs - d_best, 0, disp.shape[1] - 1)
    d_r_at = torch.gather(d_right, 1, xr)
    lr_ok = torch.abs(d_r_at - d_best) <= lr_thresh

    valid = unique & lr_ok & (d_best > 0) & (d_best < max_disp - 1)
    return DisparityResult(disparity=torch.where(valid, disp, torch.full_like(disp, -1.0)),
                           valid=valid)


def _right_volume_from_left(vol: torch.Tensor, max_disp: int) -> torch.Tensor:
    """Re-index the left-referenced volume to right-referenced:
    C_r(y, x, d) = C_l(y, x + d, d); 1e9 past the right edge."""
    W = vol.shape[1]
    xs = torch.arange(W, device=vol.device)
    big = torch.tensor(1e9, dtype=vol.dtype, device=vol.device)
    cols = [torch.where(xs < W - d, torch.roll(vol[..., d], -d, dims=1), big)
            for d in range(max_disp)]
    return torch.stack(cols, dim=-1)


def disparity_to_cloud(
    cam: Pinhole,
    baseline: float,
    disp: torch.Tensor,
    valid: torch.Tensor,
    min_depth: float = 0.5,
    max_depth: float = 60.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Reproject a disparity map to a 3D point cloud (the reference's
    ``reprojectDisparity`` via the Q matrix).

    Returns ((H*W, 3) points, (H*W,) mask).
    """
    H, W = disp.shape
    ys = torch.arange(H, dtype=torch.float32, device=disp.device)[:, None].expand(H, W)
    xs = torch.arange(W, dtype=torch.float32, device=disp.device)[None, :].expand(H, W)
    z = cam.fx * baseline / torch.clamp(disp, min=1e-3)
    x = (xs - cam.cx) / cam.fx * z
    y = (ys - cam.cy) / cam.fy * z
    pts = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    ok = (valid & (z > min_depth) & (z < max_depth)).reshape(-1)
    return pts, ok


def depth_cloud(
    left: torch.Tensor,
    right: torch.Tensor,
    cam: Pinhole,
    baseline: float,
    max_disp: int = 96,
    block: int = 7,
    n_sample: int = 4096,
    mean_k: int = 20,
    std_mul: float = 0.8,
) -> tuple[DisparityResult, torch.Tensor]:
    """The dense-disparity node on one rectified pair: SGBM -> cloud -> an
    evenly spaced subsample of `n_sample` valid points -> SOR (the
    reference's meanK 20, 0.8, ``StereoCV.cpp:288``).

    Returns the disparity and the (n, 3) points SOR keeps.  Counting the
    valid points is one host read.
    """
    res = sgbm(left, right, max_disp=max_disp, block=block)
    pts, ok = disparity_to_cloud(cam, baseline, res.disparity, res.valid)
    pts = pts[ok]
    if pts.shape[0] > n_sample:
        sel = np.linspace(0, pts.shape[0] - 1, n_sample).astype(np.int64)
        pts = pts[torch.from_numpy(sel).to(pts.device)]
    keep = sor.sor_filter(pts, torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device),
                          mean_k=mean_k, std_mul=std_mul)
    return res, pts[keep]
