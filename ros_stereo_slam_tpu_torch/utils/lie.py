"""SO(3) / SE(3) manifold operations on tensors.

Port of ``ros_stereo_slam_tpu/utils/lie.py``.  The JAX functions take one
element and are batched with ``vmap``; these take any leading batch
dimensions (``(..., 3)`` vectors, ``(..., 4, 4)`` transforms) and
broadcast, which is how the PnP hypothesis batches use them.

Conventions (as in the reference module)
----------------------------------------
- Rotations as 3x3 matrices ``R`` (world-from-body unless stated otherwise).
- SE(3) as 4x4 homogeneous matrices ``T = [[R, t], [0, 1]]``.
- Twists are 6-vectors ``xi = (rho, phi)``, translation part first.
- float32 throughout; the series branches keep small angles accurate.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def hat_so3(phi: torch.Tensor) -> torch.Tensor:
    """(..., 3) vector -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee_so3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat_so3` (assumes M skew-symmetric)."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _sinc(theta2: torch.Tensor) -> torch.Tensor:
    """sin(t)/t with a Taylor branch, as a function of t^2."""
    theta = torch.sqrt(theta2)
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta2 / 6.0, torch.sin(safe) / safe)


def _cosc(theta2: torch.Tensor) -> torch.Tensor:
    """(1 - cos(t)) / t^2 with a Taylor branch."""
    small = theta2 < _EPS
    safe = torch.where(small, torch.ones_like(theta2), theta2)
    return torch.where(
        small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(torch.sqrt(safe))) / safe
    )


def _sinc3(theta2: torch.Tensor) -> torch.Tensor:
    """(t - sin(t)) / t^3 with a Taylor branch."""
    small = theta2 < _EPS
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return torch.where(
        small,
        1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta * theta2),
    )


def exp_so3(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula: (..., 3) axis-angle -> (..., 3, 3) rotation."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    K = hat_so3(phi)
    return _eye(3, phi) + _sinc(theta2) * K + _cosc(theta2) * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle, stable near 0 and pi."""
    trace = torch.clamp(R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2], -1.0, 3.0)
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)[..., None]
    w = vee_so3(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_theta = torch.sin(theta)
    generic = torch.where(
        theta < 1e-5,
        (0.5 + theta * theta / 12.0) * w,
        theta / torch.clamp(2.0 * sin_theta, min=1e-20) * w,
    )
    # Near pi: aa^T = (R + I) / 2; take the column with the largest diagonal.
    B = (R + _eye(3, R)) * 0.5
    diag = torch.clamp(torch.diagonal(B, dim1=-2, dim2=-1), min=1e-12)
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(B, -1, k[..., None, None].expand(B.shape[:-1] + (1,)))[..., 0]
    axis_col = col / torch.sqrt(torch.gather(diag, -1, k[..., None]))
    sign = torch.where((axis_col * w).sum(-1, keepdim=True) < 0.0, -1.0, 1.0)
    near_pi = sign * axis_col * theta
    return torch.where(math.pi - theta < 1e-3, near_pi, generic)


def left_jacobian_so3(phi: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(phi)."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    K = hat_so3(phi)
    return _eye(3, phi) + _cosc(theta2) * K + _sinc3(theta2) * (K @ K)


def left_jacobian_inv_so3(phi: torch.Tensor) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian (closed form)."""
    theta2 = (phi * phi).sum(-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=0.0))
    K = hat_so3(phi)
    small = theta2 < _EPS
    half = torch.where(small, torch.ones_like(theta), theta * 0.5)
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.clamp(torch.sin(half), min=1e-20))
        / torch.where(small, torch.ones_like(theta2), theta2),
    )
    return _eye(3, phi) - 0.5 * K + cot_term * (K @ K)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


# The last row of every transform, one tensor per (device, dtype): a
# broadcast view of it completes a batch of transforms with no fill launched.
_LAST_ROW: dict = {}


def make_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Assemble (..., 4, 4) transforms from R (..., 3, 3) and t (..., 3)."""
    key = (R.device, R.dtype)
    if key not in _LAST_ROW:
        _LAST_ROW[key] = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=R.dtype, device=R.device)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, _LAST_ROW[key].expand(R.shape[:-2] + (1, 4))], dim=-2)


def rot(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, :3]


def trans(T: torch.Tensor) -> torch.Tensor:
    return T[..., :3, 3]


def inv_se3(T: torch.Tensor) -> torch.Tensor:
    """Inverse of a rigid transform: [R,t]^-1 = [R^T, -R^T t]."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make_se3(Rt, -(Rt @ T[..., :3, 3:4])[..., 0])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist (rho, phi) -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = exp_so3(phi)
    V = left_jacobian_so3(phi)
    return make_se3(R, (V @ rho[..., None])[..., 0])


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) transform -> (..., 6) twist (rho, phi)."""
    phi = log_so3(T[..., :3, :3])
    Vinv = left_jacobian_inv_so3(phi)
    rho = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def adjoint_se3(T: torch.Tensor) -> torch.Tensor:
    """Adjoint of T: Ad_T = [[R, t^ R], [0, R]] (acts on (rho, phi) twists)."""
    R = T[..., :3, :3]
    top = torch.cat([R, hat_so3(T[..., :3, 3]) @ R], dim=-1)
    bot = torch.cat([torch.zeros_like(R), R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def compose(Ta: torch.Tensor, Tb: torch.Tensor) -> torch.Tensor:
    """T_a @ T_b (kept as a named op for readability at call sites)."""
    return Ta @ Tb


def transform_points(T: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a (4, 4) transform to (N, 3) points: R @ p + t."""
    return pts @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit quaternion (w, x, y, z).

    The branch-free Shepperd-style construction: four candidates, the
    numerically best one picked per element.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def root(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 0.5

    qw0 = root(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = root(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = root(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = root(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    scores = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4 candidates, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))
    q = q[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) unit quaternion (w, x, y, z) -> (..., 3, 3) rotation."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                         2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                         2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                         1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )
