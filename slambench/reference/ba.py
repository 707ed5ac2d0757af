"""Windowed bundle adjustment in plain PyTorch, from the full dense normal
equations: the work of the program's BA solve on one window (config 4,
the reference system's g2o 3D-2D BA, ``bundleAdjust.cpp:551-613``).

The window: W cam-from-world poses, N world landmarks and their pixel
observations (W, N, 2) with a mask.  An observation counts where it is
observed and its camera point lies in front of the camera (z > 1e-3).
The cost is the sum over the observations that count of the squared
reprojection error, each weighted by the Huber IRLS weight
min(1, huber_px / |r|) of its residual r at the step's start.  The poses
marked `fixed` and the landmarks that no view observes are held.

Each of the `iters` Gauss-Newton steps assembles the Jacobian of every
residual with respect to every unknown, (2 W N) x (6 W + 3 N), densely by
index, forms H = J^T diag(w) J and b = J^T diag(w) r, damps
H_ii <- H_ii (1 + damping) + 1e-6, turns the held unknowns' rows and
columns into identity with a zero right side, and solves H delta = -b by
one dense LU factorisation.  A pose moves on the left, T <- exp(dp) T
with dp = (rho, phi); a landmark moves by its dx.  After the last step
the window is kept as it came in unless the final RMS is no higher than
the input's and every output is finite.

Departures from g2o:

- the damping is fixed (Marquardt's diagonal-relative lambda plus an
  absolute 1e-6) and the result is accepted or kept once, at the end;
  g2o's Levenberg adapts lambda and accepts or rejects every iteration;
- the Huber kernel enters as an IRLS weight on the pixel residual's norm,
  recomputed at each step's start;
- a step that is not finite, or whose factorisation fails, is no step;
- the right camera of the window's keyframe is one more (fixed) pose.

It shares no code with the program: there is no Schur elimination and no
equilibration.  Schur elimination and the dense solve give the same step,
so agreement tests the program's elimination.  The dense Jacobian of a
full window (9 poses, 768 landmarks) is 13,824 x 2,358, 0.26 GB in
float64.
"""

from __future__ import annotations

import torch

Z_MIN = 1e-3  # an observation counts in front of this depth


class Result:
    """A solve's outputs, in the dtype it computed in."""

    def __init__(self, T_cw, landmarks, rms_before, rms_after, accepted: bool):
        self.T_cw = T_cw  # (W, 4, 4) refined, or the input where kept
        self.landmarks = landmarks  # (N, 3)
        self.rms_before = rms_before  # () px
        self.rms_after = rms_after  # () the lesser of the two
        self.accepted = accepted  # the refinement was taken


def hat(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew matrices: hat(a) b = a x b."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twists (rho, phi) -> (..., 4, 4) transforms
    [[R, V rho], [0, 1]], with Taylor series below 1e-4 rad."""
    rho, phi = xi[..., :3], xi[..., 3:]
    th = phi.norm(dim=-1)[..., None, None]
    small = th < 1e-4
    t = torch.where(small, torch.ones_like(th), th)
    a = torch.where(small, 1 - th**2 / 6, torch.sin(t) / t)
    b = torch.where(small, 0.5 - th**2 / 24, (1 - torch.cos(t)) / t**2)
    c = torch.where(small, 1 / 6 - th**2 / 120, (t - torch.sin(t)) / t**3)
    K = hat(phi)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = eye + a * K + b * (K @ K)
    T[..., :3, 3] = ((eye + b * K + c * (K @ K)) @ rho[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def residuals(cam, T_cw, X, uv, mask):
    """Camera points p (W, N, 3), the observations that count (W, N) and
    the residuals projection - observation (W, N, 2)."""
    p = torch.einsum("wij,nj->wni", T_cw[:, :3, :3], X) + T_cw[:, None, :3, 3]
    z = p[..., 2]
    counts = mask & (z > Z_MIN)
    z = torch.where(counts, z, torch.ones_like(z))
    f = torch.tensor([cam[0], cam[1]], dtype=X.dtype, device=X.device)
    c = torch.tensor([cam[2], cam[3]], dtype=X.dtype, device=X.device)
    return p, counts, f * p[..., :2] / z[..., None] + c - uv


def rms(counts, r) -> torch.Tensor:
    sq = torch.where(counts, (r * r).sum(-1), torch.zeros((), dtype=r.dtype, device=r.device))
    return (sq.sum() / counts.sum().clamp(min=1)).sqrt()


def jacobian(cam, T_cw, p, counts):
    """d(residual)/d(unknowns) of every observation, (W, N, 2, 6W + 3N):
    6 twist columns per pose, then 3 per landmark."""
    W, N = counts.shape
    x, y = p[..., 0], p[..., 1]
    z = torch.where(counts, p[..., 2], torch.ones_like(p[..., 2]))
    zero = torch.zeros_like(z)
    proj = torch.stack([torch.stack([cam[0] / z, zero, -cam[0] * x / z**2], -1),
                        torch.stack([zero, cam[1] / z, -cam[1] * y / z**2], -1)], -2)
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(W, N, 3, 3)
    d_pose = proj @ torch.cat([eye, -hat(p)], -1)  # (W, N, 2, 6)
    d_point = proj @ T_cw[:, None, :3, :3]  # (W, N, 2, 3)
    J = torch.zeros((W, N, 2, 6 * W + 3 * N), dtype=p.dtype, device=p.device)
    w = torch.arange(W, device=p.device)[:, None, None, None]
    n = torch.arange(N, device=p.device)[None, :, None, None]
    k = torch.arange(2, device=p.device)[None, None, :, None]
    J[w, n, k, 6 * w + torch.arange(6, device=p.device)] = d_pose
    J[w, n, k, 6 * W + 3 * n + torch.arange(3, device=p.device)] = d_point
    return J


def step(cam, T_cw, X, uv, mask, held, damping: float, huber_px: float):
    """One damped Gauss-Newton step from the dense normal equations:
    (dp (W, 6), dx (N, 3))."""
    W, N = mask.shape
    p, counts, r = residuals(cam, T_cw, X, uv, mask)
    J = jacobian(cam, T_cw, p, counts).reshape(2 * W * N, -1)
    norm = r.norm(dim=-1).clamp(min=1e-9)
    w = torch.where(counts, (huber_px / norm).clamp(max=1.0), torch.zeros_like(norm))
    Jw = J * w.reshape(-1).repeat_interleave(2)[:, None]
    H = Jw.T @ J
    b = Jw.T @ r.reshape(-1)
    H = H + torch.diag(damping * H.diagonal() + 1e-6)
    H = torch.where(held[:, None] | held[None, :], torch.zeros_like(H), H) + torch.diag(
        held.to(H.dtype))
    b = torch.where(held, torch.zeros_like(b), b)
    delta, info = torch.linalg.solve_ex(H, -b)
    if int(info) != 0 or not bool(torch.isfinite(delta).all()):
        delta = torch.zeros_like(delta)
    return delta[:6 * W].reshape(W, 6), delta[6 * W:].reshape(N, 3)


def solve(cam, T_cw, landmarks, obs, obs_mask, fixed, iters: int = 10, damping: float = 1e-4,
          huber_px: float = 2.0, dtype=torch.float64) -> Result:
    """`iters` steps on the window, computing in `dtype`; `cam` is
    (fx, fy, cx, cy).  Outputs in `dtype`.  Float32 products run in full
    float32 on the card (TF32, which rounds them to 10 bits, is off
    meanwhile)."""
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        T0, X0 = T_cw.to(dtype), landmarks.to(dtype)
        uv, mask = obs.to(dtype), obs_mask.bool()
        W, N = mask.shape
        held = torch.cat([fixed.bool()[:, None].expand(W, 6).reshape(-1),
                          (~mask.any(0))[:, None].expand(N, 3).reshape(-1)])
        T, X = T0, X0
        for _ in range(iters):
            dp, dx = step(cam, T, X, uv, mask, held, damping, huber_px)
            T, X = exp(dp) @ T, X + dx
        rms0 = rms(*residuals(cam, T0, X0, uv, mask)[1:])
        rms1 = rms(*residuals(cam, T, X, uv, mask)[1:])
        accepted = bool(rms1 <= rms0) and bool(torch.isfinite(T).all()) and bool(
            torch.isfinite(X).all())
        if not accepted:
            T, X = T0, X0
        return Result(T, X, rms0, torch.minimum(rms0, rms1), accepted)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
