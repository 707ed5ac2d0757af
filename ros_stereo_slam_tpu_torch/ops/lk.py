"""Batched pyramidal Lucas-Kanade optical flow.

Port of ``ros_stereo_slam_tpu/ops/lk.py``: forward-additive LK with
template-side gradients, a masked epsilon stop and a contrast-normalized
photometric residual, all N points advancing together.

:func:`_track_level` is the plain PyTorch version of one pyramid level.
It runs the CPU path and is the oracle of the CUDA kernel in
``ops/lk_cuda.py``; :func:`_dispatch_level` hands every level to
``lk_cuda.track_level``, where the tensors' device picks the route.

Lane form: :func:`track` also takes pyramids of (B, h, w) levels with
(B, N, 2) points (the batched-lane drivers); each level then goes through
``lk_cuda.track_level_batch``, one kernel launch for all lanes.

Freeze-polish (``walk_iters < iters``): after ``walk_iters`` full
resampling steps, the remaining steps sample a frozen tile anchored at the
post-walk guess, clamped to a ~±1 px cell around the anchor (the
reference's jnp route and Pallas kernel use the same clamp formula).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ros_stereo_slam_tpu_torch.ops import interp, pyramid


class LKParams(NamedTuple):
    window: int = 21
    levels: int = 4
    iters: int = 10
    # Full-resampling GN iterations per level; the remaining iters - walk
    # "polish" iterations sample a frozen (window+2)^2 tile anchored after
    # the walk (sampling clamped to a ~±1 px cell around the anchor).
    walk_iters: int = 10
    eps: float = 0.01
    # Per-pixel min eigenvalue of the spatial gradient matrix, for images
    # in [0, 1].
    min_eig: float = 1e-7
    # Photometric gate: mean |cur - tmpl| relative to the template's std.
    max_residual: float = 0.8


class LKResult(NamedTuple):
    points: torch.Tensor  # (N, 2) tracked positions in the current image
    valid: torch.Tensor  # (N,) bool
    residual: torch.Tensor  # (N,) contrast-normalized photometric error


def check_params(params: LKParams) -> None:
    if params.iters < 0 or params.walk_iters < 0:
        raise ValueError(f"LK iteration counts must be >= 0, got iters={params.iters}, "
                         f"walk_iters={params.walk_iters}")


def _track_level(
    ref_img: torch.Tensor,
    cur_img: torch.Tensor,
    ref_pts: torch.Tensor,
    guesses: torch.Tensor,
    params: LKParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pyramid level of LK: refine `guesses` (N, 2).

    Returns (new_guesses, residual, ok); points whose structure tensor is
    too weak (not ok) keep their input guess.
    """
    check_params(params)
    w = params.window
    ix_full, iy_full = pyramid.scharr_gradients(ref_img)
    tmpl = interp.extract_patches(ref_img, ref_pts, w)
    gx = interp.extract_patches(ix_full, ref_pts, w)
    gy = interp.extract_patches(iy_full, ref_pts, w)
    a = (gx * gx).sum((1, 2))
    b = (gx * gy).sum((1, 2))
    c = (gy * gy).sum((1, 2))
    det = a * c - b * b
    trace = a + c
    # min eigenvalue of G, normalized per pixel — OpenCV's minEigThreshold
    min_eig = (trace - torch.sqrt(torch.clamp(trace * trace - 4 * det, min=0.0))) * 0.5
    min_eig = min_eig / (w * w)
    ok = min_eig > params.min_eig
    inv_det = torch.where(det > 1e-12, 1.0 / torch.clamp(det, min=1e-12),
                          torch.zeros_like(det))

    def gn_update(g, pos):
        """One Gauss-Newton step of `g`, sampling the current image at `pos`."""
        it = interp.extract_patches(cur_img, pos, w) - tmpl
        bx = (gx * it).sum((1, 2))
        by = (gy * it).sum((1, 2))
        delta = torch.stack([(c * bx - b * by) * inv_det,
                             (a * by - b * bx) * inv_det], dim=-1)
        # masked convergence: once |delta| < eps, steps become no-ops
        moving = ~(torch.linalg.vector_norm(delta, dim=-1) < params.eps)
        return g - moving[:, None] * delta

    walk = min(params.iters, params.walk_iters)
    g = guesses
    for _ in range(walk):
        g = gn_update(g, g)
    g_res = g
    if params.iters > walk:
        # Freeze-polish: every further sample comes from the ~±1 px cell
        # around the post-walk anchor; the residual is taken at the clamped
        # position, the returned point is the unclamped guess.
        h_i, w_i = cur_img.shape
        half = (w - 1) * 0.5
        hi = torch.tensor([w_i - w - 3.0, h_i - w - 3.0], dtype=g.dtype, device=g.device)
        base = torch.minimum(torch.clamp(torch.floor(g - half) - 1.0, min=0.0), hi)

        def clamp_pos(gp):
            return base + torch.clamp(gp - half - base, 0.0, 2.0 - 1e-4) + half

        for _ in range(params.iters - walk):
            g = gn_update(g, clamp_pos(g))
        g_res = clamp_pos(g)
    cur = interp.extract_patches(cur_img, g_res, w)
    contrast = torch.std(tmpl, dim=(1, 2), correction=0) + 1e-3
    resid = (cur - tmpl).abs().mean((1, 2)) / contrast
    return torch.where(ok[:, None], g, guesses), resid, ok


def _dispatch_level(ref_img, cur_img, ref_pts, guesses, params: LKParams):
    """One level through ``lk_cuda.track_level`` ((H, W) images, or a stack
    of one lane) or ``lk_cuda.track_level_batch`` ((B, H, W) lanes, B > 1):
    the CUDA kernel for CUDA tensors, the plain version for CPU tensors.
    Both launch the kernel's one lane-form entry point, so a lane's result
    does not depend on the route."""
    from ros_stereo_slam_tpu_torch.ops import lk_cuda

    if ref_img.dim() == 2:
        return lk_cuda.track_level(ref_img, cur_img, ref_pts, guesses, params)
    if ref_img.shape[0] > 1:
        return lk_cuda.track_level_batch(ref_img, cur_img, ref_pts, guesses, params)
    out = lk_cuda.track_level(ref_img[0], cur_img[0], ref_pts[0], guesses[0], params)
    return tuple(t[None] for t in out)


def track(
    ref_pyr: tuple,
    cur_pyr: tuple,
    ref_pts: torch.Tensor,
    init_flow: torch.Tensor | None = None,
    params: LKParams = LKParams(),
) -> LKResult:
    """Track (N, 2) `ref_pts` from the ref pyramid into the cur pyramid.

    `ref_pyr` / `cur_pyr`: sequences from :func:`pyramid.build_pyramid`
    (finest first); their length sets the number of levels.
    `init_flow`: optional (N, 2) prior displacement (e.g. stereo prior).
    Lane form: (B, h, w) levels, (B, N, 2) points and flow, (B, N) outputs.
    """
    levels = len(ref_pyr)
    lead = ref_pts.shape[:-1]
    flow = torch.zeros_like(ref_pts) if init_flow is None else init_flow

    scale = float(2 ** (levels - 1))
    guesses = (ref_pts + flow) / scale
    ok_fine = torch.ones(lead, dtype=torch.bool, device=ref_pts.device)
    resid = torch.zeros(lead, dtype=torch.float32, device=ref_pts.device)
    # A point out of range AT A GIVEN LEVEL keeps its prior guess there
    # instead of absorbing an update computed from clamped reads.
    margin = params.window // 2 + 1
    for lvl in range(levels - 1, -1, -1):
        ref_lvl = ref_pts / float(2**lvl)
        h_l, w_l = ref_pyr[lvl].shape[-2:]
        tracked, resid, ok = _dispatch_level(
            ref_pyr[lvl], cur_pyr[lvl], ref_lvl, guesses, params
        )
        usable = ok & interp.in_bounds(ref_lvl, h_l, w_l, margin) & interp.in_bounds(
            tracked, h_l, w_l, margin
        )
        guesses = torch.where(usable[..., None], tracked, guesses)
        if lvl == 0:
            ok_fine = usable
        else:
            guesses = guesses * 2.0

    h, w = cur_pyr[0].shape[-2:]
    valid = (
        ok_fine
        & interp.in_bounds(ref_pts, h, w, margin)
        & (resid < params.max_residual)
    )
    return LKResult(points=guesses, valid=valid, residual=resid)


def max_levels_for(shape: tuple[int, int], params: LKParams) -> int:
    """Clamp pyramid depth so the coarsest level still fits an LK window."""
    min_size = params.window + 3
    levels = 1
    h, w = shape
    while levels < params.levels and min(h, w) // 2 >= min_size:
        h, w = h // 2, w // 2
        levels += 1
    return levels


def track_images(
    ref_img: torch.Tensor,
    cur_img: torch.Tensor,
    ref_pts: torch.Tensor,
    init_flow: torch.Tensor | None = None,
    params: LKParams = LKParams(),
) -> LKResult:
    """Convenience wrapper building pyramids internally."""
    params = params._replace(levels=max_levels_for(tuple(ref_img.shape), params))
    ref_pyr = tuple(pyramid.build_pyramid(ref_img, params.levels))
    cur_pyr = tuple(pyramid.build_pyramid(cur_img, params.levels))
    return track(ref_pyr, cur_pyr, ref_pts, init_flow, params)
