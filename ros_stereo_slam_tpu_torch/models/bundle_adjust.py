"""Windowed Schur-complement bundle adjustment (config 4).

Port of ``ros_stereo_slam_tpu/models/bundle_adjust.py``: the reference's
3D-2D BA (g2o, poses plus marginalized landmarks, Levenberg, 10
iterations, ``reference/src/bundleAdjust.cpp:551-613``) in its windowed
form, as the JAX package implements it:

- residuals and Jacobians of every (pose, landmark) observation at once,
  Huber-weighted and masked;
- the per-landmark 3x3 blocks eliminated by one batched adjugate inverse
  (the Schur elimination);
- the reduced camera system (6W x 6W) solved and the landmarks
  back-substituted in one batch;
- Marquardt damping with its absolute ``1e-6``, the gauge fixed by
  freezing the `fixed` poses, a non-finite step zeroed, and the input kept
  when the refinement does not lower the reprojection RMS.

Left-multiplicative perturbation of cam-from-world poses, twists (rho,
phi), as :mod:`.ops.pnp`.

Two choices differ from the JAX module, both about the device:

- Layout: N-first, one ``(W, N, 2, 10)`` block per observation holding
  its Jacobian (6 pose, 3 landmark columns) and its residual.  The JAX
  module keeps N last because the TPU pads the two trailing dims to
  (8, 128); the GPU pads nothing, and N-first makes the normal equations
  of every observation one batched matmul.
- Solve: the JAX module runs block-Jacobi CG in float32 (48 steps plus a
  refinement round, twice per iteration) because a LAPACK-style call costs
  milliseconds on the TPU.  Eagerly on the GPU every CG step would be ~16
  launches, ~1,500 per solve.  Here the whole problem runs in float64 and
  the equilibrated reduced system is factorised directly
  (``torch.linalg.cholesky_ex``, which does not synchronise, then two
  triangular solves): a few launches, and the exact Gauss-Newton step.

Every sum over landmarks or poses is a plain reduction (no atomics), so
runs on one device are bitwise equal.  With a `mesh` (the JAX module's
``axis_name``) the landmarks and their observation columns are this rank's
shard: the sums over landmarks (U and bp, the ``W V^-1 W^T`` and
``W V^-1 bl`` terms of the reduced system, the RMS sums, the finite check
of the landmarks) are all-reduced, so the step and the accept decision
are the same on every rank, while the landmark blocks, their inverses and
the back-substitution stay local
(:mod:`ros_stereo_slam_tpu_torch.parallel.dist_ba`).

Every solve goes through BA's graph family
(:data:`..utils.cuda_graph.BA`): on the card without a mesh it replays a
CUDA graph of the eager solve (:func:`_solve`), captured once per window
signature (shapes and dtypes, the device, the camera, `iters`, `damping`,
`huber_px`): the same kernels on the same shapes, one launch for some
1,150.  The solve reads nothing back to the
host, so the whole of it captures.  The CPU and a mesh (collectives
inside) solve eagerly.

Spans (:mod:`ros_stereo_slam_tpu_torch.utils.profiling`; they record only
under a capture and never synchronise): ``ba.linearize`` (residuals,
Jacobians and weights), ``ba.reduce`` (the blocks, the landmark inverses,
the reduced camera system) and ``ba.factor`` (the factorisation, the
triangular solves, back-substitution and the update), each once an
iteration, then ``ba.accept`` (the final RMS and the keep-or-refine
select).  They are host spans of the eager solve: a replay records none,
so on the card they appear only in the call that captures a signature
(its warm-up calls and the capture), and the caller's ``step.ba`` span
holds the replays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ros_stereo_slam_tpu_torch.ops import linalg
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh, psum, psum_many
from ros_stereo_slam_tpu_torch.utils import cuda_graph, profiling
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

_F64 = torch.float64
# Host counters: solves begun and Gauss-Newton iterations asked for
# (:func:`ba_solve` adds 1 and `iters` a call, replayed or eager; nothing is
# read from the device).  ``tools/torch_span_report.py`` prints them per
# traced session, beside the graph family's.
SOLVES = 0
ITERATIONS = 0


class BAResult(NamedTuple):
    T_cw: torch.Tensor  # (W, 4, 4) refined cam-from-world poses
    landmarks: torch.Tensor  # (N, 3) refined world points
    rms_before: torch.Tensor  # () masked reprojection RMS (px)
    rms_after: torch.Tensor  # ()


# Constants per (device, intrinsics), made once: a tensor built from host
# values is a host-to-device copy, which synchronises the stream.
_CONSTS: dict = {}


class _Consts(NamedTuple):
    f: torch.Tensor  # (2,) fx, fy
    c: torch.Tensor  # (2,) cx, cy
    f_base: torch.Tensor  # (2, 3) [[fx, 0, 0], [0, fy, 0]]
    e_z: torch.Tensor  # (3,)
    E: torch.Tensor  # (3, 9): phi @ E is hat(phi) flattened row-major
    series0: torch.Tensor  # (3,) Taylor terms of exp_se3's a, b, c
    series1: torch.Tensor  # (3,)
    eye3: torch.Tensor  # (3, 3)
    zero: torch.Tensor  # (): a select against a tensor is one launch, against
    # a Python number two (the number is filled into a tensor first)


def _consts(cam: Pinhole, device) -> _Consts:
    key = (torch.device(device), tuple(cam))
    if key not in _CONSTS:
        E = np.zeros((3, 3, 3))
        for i, j, k in ((0, 1, 2), (1, 2, 0), (2, 0, 1)):
            E[k, i, j], E[k, j, i] = -1.0, 1.0
        host = _Consts(
            f=np.array([cam.fx, cam.fy]), c=np.array([cam.cx, cam.cy]),
            f_base=np.array([[cam.fx, 0.0, 0.0], [0.0, cam.fy, 0.0]]),
            e_z=np.array([0.0, 0.0, 1.0]), E=E.reshape(3, 9),
            series0=np.array([1.0, 0.5, 1.0 / 6.0]),
            series1=np.array([-1.0 / 6.0, -1.0 / 24.0, -1.0 / 120.0]), eye3=np.eye(3),
            zero=np.zeros(()),
        )
        _CONSTS[key] = _Consts(*(torch.from_numpy(a).to(device) for a in host))
    return _CONSTS[key]


def _exp_se3(xi: torch.Tensor, k: _Consts) -> tuple[torch.Tensor, torch.Tensor]:
    """(W, 6) twists -> rotations (W, 3, 3) and translations (W, 3) of
    ``exp_se3``: R = I + a K + b K^2, t = (I + b K + c K^2) rho with the
    reference's Taylor branch below theta^2 = 1e-8, in few launches."""
    rho, phi = xi[:, :3], xi[:, 3:]
    theta2 = torch.linalg.vecdot(phi, phi)[:, None]
    small = theta2 < 1e-8
    t2 = theta2.clamp(min=1e-8)  # the exact branch, finite where unused
    th = t2.sqrt()
    s = th.sin()
    exact = torch.cat([s / th, (1.0 - th.cos()) / t2, (th - s) / (th * t2)], dim=1)
    abc = torch.where(small, torch.addcmul(k.series0, theta2, k.series1), exact)
    K = (phi @ k.E).view(-1, 3, 3)
    coef = torch.stack([abc[:, :2], abc[:, 1:]], dim=1)  # rows: R's (a, b), V's (b, c)
    RV = torch.einsum("wjk,wkab->wjab", coef, torch.stack([K, K @ K], dim=1)) + k.eye3
    return RV[:, 0], (RV[:, 1] @ rho[:, :, None])[:, :, 0]


class _Problem(NamedTuple):
    """The inputs of one solve that stay fixed over its iterations (float64)."""

    k: _Consts
    c_minus_obs: torch.Tensor  # (W, N, 2) principal point minus observations
    mask: torch.Tensor  # (W, N) bool
    lm_valid: torch.Tensor  # (N,) float: landmark seen in the window
    free: torch.Tensor  # (W,) float: 1 for poses that move
    eye_w: torch.Tensor  # (W, 1, W, 1) identity, to build block diagonals
    gauge_eye: torch.Tensor  # (6W, 6W) identity on the fixed poses' rows
    free6: torch.Tensor  # (6W,) free per unknown


def _finite(x: torch.Tensor) -> torch.Tensor:
    """Elementwise ``isfinite`` in two launches (inf - inf and nan are nan)."""
    return (x - x) == 0


def _residuals(pb: _Problem, R: torch.Tensor, t: torch.Tensor, X: torch.Tensor):
    """Camera points p (W, N, 3) of the poses (R, t), 1/z, the observations
    that count (observed and z > 1e-3), f * p_xy / z and the residuals
    r = projection - observation (W, N, 2)."""
    p = torch.einsum("wij,nj->wni", R, X) + t[:, None, :]
    z = p[..., 2]
    # 1/z is used only where z > 1e-3 (elsewhere the weight is 0); the
    # clamp keeps it finite there, as the reference's 1/where(pos, z, 1).
    inv_z = z.clamp(min=1e-3).reciprocal()
    qf = p[..., :2] * (inv_z[..., None] * pb.k.f)
    return p, inv_z, pb.mask & (z > 1e-3), qf, qf + pb.c_minus_obs


def _rms(m: torch.Tensor, r: torch.Tensor, mesh: Mesh | None = None) -> torch.Tensor:
    """Reprojection RMS over the observations `m` that count (over every
    rank's observations with a `mesh`)."""
    sq = torch.where(m, torch.linalg.vecdot(r, r), 0.0).sum()
    if mesh is not None:
        sq, n = psum(torch.stack([sq, m.sum().to(sq.dtype)]), mesh)
        return (sq / n.clamp(min=1)).sqrt()
    return (sq / m.sum().clamp(min=1)).sqrt()


def _linearize(pb: _Problem, R: torch.Tensor, res, huber_px: float):
    """Jacobians and Huber weights of the observations at their `res`iduals:
    (W, N, 2, 10) blocks (6 pose, 3 landmark columns, the residual last)
    and (W, N) IRLS weights, 0 where an observation does not count."""
    p, inv_z, m, qf, r = res
    # Row k of d(u, v)/dp is (f_k e_k - qf_k e_z) / z; the pose columns are
    # that times [I | -hat(p)] (row x -hat(p) = p x row), the landmark
    # columns that times R.
    Fs = torch.addcmul(pb.k.f_base, qf[..., None], pb.k.e_z, value=-1.0) * inv_z[..., None, None]
    Ja = torch.cat([Fs, torch.linalg.cross(p[..., None, :], Fs, dim=-1),
                    torch.einsum("wnkc,wcb->wnkb", Fs, R), r[..., None]],
                   dim=-1)  # (W, N, 2, 10)
    # Huber IRLS weight: min(1, huber / |r|), 0 where unobserved.
    wh = (huber_px / torch.linalg.vector_norm(r, dim=-1).clamp(min=1e-9)).clamp(max=1.0)
    return Ja, torch.where(m, wh, pb.k.zero)


class _Reduced(NamedTuple):
    """The reduced camera system of one step and what back-substitution needs."""

    S: torch.Tensor  # (6W, 6W) U - W V^-1 W^T, damped
    rhs: torch.Tensor  # (6W,) W V^-1 bl - bp
    Bm: torch.Tensor  # (6W, 3N) the pose-landmark blocks W
    bl: torch.Tensor  # (N, 3)
    V_inv: torch.Tensor  # (N, 3, 3) damped landmark blocks inverted, 0 where unseen


def _reduce(pb: _Problem, Ja: torch.Tensor, wgt: torch.Tensor, damping: float,
            mesh: Mesh | None = None) -> _Reduced:
    """The normal equations' blocks, the landmark blocks eliminated (Schur).
    With a `mesh` the sums over landmarks are taken over every rank's."""
    W, N = wgt.shape
    HG = (Ja * wgt[..., None, None]).transpose(-1, -2) @ Ja  # (W, N, 10, 10)
    Ub = HG[:, :, :6].sum(1)  # (W, 6, 10): U = [..., :6], bp = [..., 9]
    Vb = HG[:, :, 6:9].sum(0)  # (N, 3, 10): V = [..., 6:9], bl = [..., 9]
    Wc = HG[:, :, :6, 6:9]  # (W, N, 6, 3)
    V, bl = Vb[..., 6:9], Vb[..., 9]
    # Marquardt (diagonal-relative) damping; the absolute 1e-6 keeps the
    # blocks of unobserved landmarks invertible.
    V.diagonal(dim1=-2, dim2=-1).mul_(1.0 + damping).add_(1e-6)
    V_inv = linalg.inv3x3(V) * pb.lm_valid[:, None, None]

    # Reduced camera system S dp = rhs, S = U - W V^-1 W^T, rhs = W V^-1 bl - bp
    # (rows: 6 per pose; columns of W V^-1 and W: 3 per landmark).
    Bm = Wc.permute(0, 2, 1, 3).reshape(6 * W, N, 3)
    A = (Bm[:, :, None, :] @ V_inv).view(6 * W, 3 * N)
    Bm = Bm.view(6 * W, 3 * N)
    AB, Abl = A @ Bm.T, A @ bl.reshape(-1)
    if mesh is not None:  # the landmark sums, over every rank's landmarks
        Ub, AB, Abl = psum_many(mesh, Ub, AB, Abl)
    U, bp = Ub[..., :6], Ub[..., 9]
    U.diagonal(dim1=-2, dim2=-1).mul_(1.0 + damping).add_(1e-6)
    S = (U[:, :, None, :] * pb.eye_w).reshape(6 * W, 6 * W) - AB
    return _Reduced(S, Abl - bp.reshape(-1), Bm, bl, V_inv)


def _factor(pb: _Problem, R, t, X, red: _Reduced):
    """Solve the reduced system, back-substitute the landmarks and apply
    the step to the poses (R, t) and landmarks X; returns the new (R, t, X)."""
    W, N = R.shape[0], X.shape[0]
    # Gauge (the fixed poses' rows and columns become identity, rhs 0) and
    # symmetric diagonal equilibration in one product, then the direct
    # factorisation.  A fixed row's e multiplies a zero.
    e = red.S.diagonal().clamp(min=1e-12).rsqrt()
    fe = e * pb.free6
    S = torch.addcmul(pb.gauge_eye, red.S, fe[:, None] * fe[None, :])
    L, info = torch.linalg.cholesky_ex(S)
    y = torch.linalg.solve_triangular(L, (red.rhs * fe)[:, None], upper=False)
    y = torch.linalg.solve_triangular(L.T, y, upper=True)
    dp = (y[:, 0] * e).view(W, 6)
    # A degenerate window (or a failed factorisation) gives no step: a nan
    # pose would mask every observation and fool the final rms guard.
    dp = torch.where(_finite(dp).all() & (info == 0), dp, pb.k.zero) * pb.free[:, None]

    # Back-substitution dx = V^-1 (-bl - W^T dp); unseen landmarks stay.
    tmp = -(red.bl + (red.Bm.T @ dp.reshape(-1)).view(N, 3))
    dx = (red.V_inv @ tmp[..., None])[..., 0]
    dx = torch.where(_finite(dx), dx, pb.k.zero)

    R_d, t_d = _exp_se3(dp, pb.k)
    return R_d @ R, torch.baddbmm(t_d[..., None], R_d, t[..., None])[..., 0], X + dx


def _solve(cam: Pinhole, T_cw, landmarks, obs, obs_mask, fixed, iters: int, damping: float,
           huber_px: float, mesh: Mesh | None = None) -> BAResult:
    """The solve of :func:`ba_solve`, eagerly."""
    k = _consts(cam, T_cw.device)
    W = T_cw.shape[0]
    free = (~fixed).to(_F64)
    free6 = free[:, None].expand(W, 6).reshape(-1)
    pb = _Problem(
        k=k, c_minus_obs=k.c - obs.to(_F64), mask=obs_mask,
        lm_valid=obs_mask.any(0).to(_F64), free=free,
        eye_w=torch.eye(W, dtype=_F64, device=T_cw.device)[:, None, :, None],
        gauge_eye=torch.diag(1.0 - free6),
        free6=free6,
    )
    R, t, X = T_cw[:, :3, :3].to(_F64), T_cw[:, :3, 3].to(_F64), landmarks.to(_F64)
    rms0 = None
    for _ in range(iters):
        with profiling.span("ba.linearize"):
            res = _residuals(pb, R, t, X)
            if rms0 is None:
                rms0 = _rms(res[2], res[4], mesh)
            Ja, wgt = _linearize(pb, R, res, huber_px)
        with profiling.span("ba.reduce"):
            red = _reduce(pb, Ja, wgt, damping, mesh)
        with profiling.span("ba.factor"):
            R, t, X = _factor(pb, R, t, X, red)
    with profiling.span("ba.accept"):
        _, _, m, _, r = _residuals(pb, R, t, X)
        rms1 = _rms(m, r, mesh)
        if rms0 is None:  # no iteration: the input is the result
            rms0 = rms1
        T_fin = torch.cat([torch.cat([R, t[:, :, None]], dim=2).to(T_cw.dtype), T_cw[:, 3:]],
                          dim=1)
        X_fin = X.to(landmarks.dtype)
        X_ok = (_finite(X_fin).all() if mesh is None
                else psum((~_finite(X_fin)).sum(), mesh) == 0)
        # Keep the input if the refinement diverged (rare, ill-conditioned
        # windows).
        better = (rms1 <= rms0) & _finite(T_fin).all() & X_ok
        return BAResult(
            T_cw=torch.where(better, T_fin, T_cw),
            landmarks=torch.where(better, X_fin, landmarks),
            rms_before=rms0.to(torch.float32),
            rms_after=torch.minimum(rms1, rms0).to(torch.float32),
        )


def ba_solve(
    cam: Pinhole,
    T_cw: torch.Tensor,  # (W, 4, 4)
    landmarks: torch.Tensor,  # (N, 3)
    obs: torch.Tensor,  # (W, N, 2)
    obs_mask: torch.Tensor,  # (W, N) bool
    fixed: torch.Tensor,  # (W,) bool: poses excluded from optimization
    iters: int = 10,
    damping: float = 1e-4,
    huber_px: float = 2.0,
    mesh: Mesh | None = None,
) -> BAResult:
    """`iters` damped Gauss-Newton steps on the window; float32 in and out,
    float64 inside.  Returns the input unchanged when the final RMS is
    above the initial one or anything is non-finite (selected on the
    device: no host read).  With a `mesh`, `landmarks`, `obs` and
    `obs_mask` are this rank's shard of the landmark axis and the sums over
    landmarks run over every rank's (each rank must call this).

    Replayed through BA's graph family on the card without a mesh, else
    eager."""
    global SOLVES, ITERATIONS
    SOLVES += 1
    ITERATIONS += iters
    return cuda_graph.BA(_solve, mesh=mesh, cam=cam, T_cw=T_cw, landmarks=landmarks, obs=obs,
                         obs_mask=obs_mask, fixed=fixed, iters=iters, damping=damping,
                         huber_px=huber_px)


def dense_solve_reference(cam: Pinhole, T_cw, landmarks, obs, obs_mask, fixed,
                          damping: float = 1e-4, huber_px: float = 2.0):
    """One Gauss-Newton step from the FULL dense normal equations (no Schur
    complement), in float64 numpy: the test oracle of :func:`ba_solve`
    with ``iters=1`` (the reference's "Schur solve == direct solve").

    Inputs are arrays or tensors (float32 values, read as float64).
    Returns (dp (W, 6), dx (N, 3)) float64.
    """
    T = np.asarray(T_cw, np.float64)
    X = np.asarray(landmarks, np.float64)
    uv = np.asarray(obs, np.float64)
    mask = np.asarray(obs_mask, bool)
    fixed = np.asarray(fixed, bool)
    W, N = T.shape[0], X.shape[0]
    f = np.array([cam.fx, cam.fy])
    p = np.einsum("wij,nj->wni", T[:, :3, :3], X) + T[:, None, :3, 3]
    z = p[..., 2]
    pos = z > 1e-3
    inv_z = 1.0 / np.where(pos, z, 1.0)
    r = p[..., :2] * inv_z[..., None] * f + [cam.cx, cam.cy] - uv
    Jproj = np.zeros((W, N, 2, 3))
    Jproj[..., 0, 0] = f[0] * inv_z
    Jproj[..., 1, 1] = f[1] * inv_z
    Jproj[..., :, 2] = -f * p[..., :2] * (inv_z * inv_z)[..., None]
    hat = np.zeros((W, N, 3, 3))
    hat[..., 0, 1], hat[..., 0, 2], hat[..., 1, 2] = -p[..., 2], p[..., 1], -p[..., 0]
    hat -= np.swapaxes(hat, -1, -2)
    dpdxi = np.concatenate([np.broadcast_to(np.eye(3), hat.shape), -hat], axis=-1)
    Jp = Jproj @ dpdxi
    Jl = Jproj @ T[:, None, :3, :3]
    rn = np.linalg.norm(r, axis=-1)
    wh = np.where(rn <= huber_px, 1.0, huber_px / np.maximum(rn, 1e-9))
    wgt = wh * (mask & pos)
    n_vars = 6 * W + 3 * N
    J = np.zeros((W, N, 2, n_vars))
    for w in range(W):
        J[w, :, :, 6 * w:6 * w + 6] = Jp[w]
    for n in range(N):
        J[:, n, :, 6 * W + 3 * n:6 * W + 3 * n + 3] = Jl[:, n]
    Jf = (J * wgt[..., None, None]).reshape(-1, n_vars)
    H = Jf.T @ J.reshape(-1, n_vars)
    H = H + np.diag(damping * np.diagonal(H) + 1e-6)
    b = Jf.T @ r.reshape(-1)
    fix = [i for w in range(W) if fixed[w] for i in range(6 * w, 6 * w + 6)]
    fix += [i for n in range(N) if not mask[:, n].any()
            for i in range(6 * W + 3 * n, 6 * W + 3 * n + 3)]
    if fix:
        ix = np.asarray(fix)
        H[ix, :] = 0.0
        H[:, ix] = 0.0
        H[ix, ix] = 1.0
        b[ix] = 0.0
    delta = np.linalg.solve(H, -b)
    return delta[:6 * W].reshape(W, 6), delta[6 * W:].reshape(N, 3)
