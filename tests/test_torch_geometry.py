"""Port parity: Lie groups, the pinhole camera and the small linalg kernels.

The same seeded numpy inputs go through the JAX function (vmapped where it
takes one element) and its port.  Tolerances are float32 round-off of
closed-form expressions: 1e-5 absolute on O(1) values unless stated.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.ops import linalg as jla
from ros_stereo_slam_tpu.utils import camera as jcam
from ros_stereo_slam_tpu.utils import lie as jlie
from ros_stereo_slam_tpu_torch.ops import linalg as tla
from ros_stereo_slam_tpu_torch.utils import camera as tcam
from ros_stereo_slam_tpu_torch.utils import lie as tlie

ATOL = 1e-5


def _rng(seed=0):
    return np.random.default_rng(seed)


def _close(t, j, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def _twists(n=64, seed=0):
    """Mixed magnitudes: tiny (Taylor branches), moderate and near pi."""
    rng = _rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    xi[: n // 4, 3:] *= 1e-5
    axis = xi[-4:, 3:] / np.linalg.norm(xi[-4:, 3:], axis=1, keepdims=True)
    xi[-4:, 3:] = axis * (np.pi - 1e-2)
    return xi


@pytest.mark.parametrize("name", ["hat_so3", "exp_so3", "left_jacobian_so3",
                                  "left_jacobian_inv_so3"])
def test_so3_maps(name):
    phi = _twists()[:, 3:]
    _close(getattr(tlie, name)(torch.from_numpy(phi)),
           jax.vmap(getattr(jlie, name))(jnp.asarray(phi)))


def test_se3_exp_log_inv_transform():
    xi = _twists(seed=1)
    T_t = tlie.exp_se3(torch.from_numpy(xi))
    T_j = jax.vmap(jlie.exp_se3)(jnp.asarray(xi))
    _close(T_t, T_j, atol=2e-5)
    _close(tlie.inv_se3(T_t), jax.vmap(jlie.inv_se3)(T_j), atol=5e-5)
    _close(tlie.log_se3(T_t), jax.vmap(jlie.log_se3)(T_j), atol=2e-3)
    _close(tlie.log_so3(T_t[:, :3, :3]), jax.vmap(jlie.log_so3)(T_j[:, :3, :3]),
           atol=2e-3)
    _close(tlie.adjoint_se3(T_t), jax.vmap(jlie.adjoint_se3)(T_j), atol=5e-5)
    R = T_t[:, :3, :3]
    t = T_t[:, :3, 3]
    _close(tlie.make_se3(R, t), jax.vmap(jlie.make_se3)(jnp.asarray(R), jnp.asarray(t)))
    pts = _rng(2).normal(scale=10.0, size=(50, 3)).astype(np.float32)
    _close(tlie.transform_points(T_t[3], torch.from_numpy(pts)),
           jlie.transform_points(T_j[3], jnp.asarray(pts)), atol=1e-4)


def test_quaternion_round_trip():
    R = tlie.exp_so3(torch.from_numpy(_twists(seed=3)[:, 3:]))
    q_t = tlie.quat_from_rot(R)
    q_j = jax.vmap(jlie.quat_from_rot)(jnp.asarray(R))
    _close(q_t, q_j, atol=2e-5)
    _close(tlie.rot_from_quat(q_t), jax.vmap(jlie.rot_from_quat)(q_j), atol=2e-5)


def test_camera_project_backproject():
    rng = _rng(4)
    c = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)
    cam_t = tcam.Pinhole(**c)
    cam_j = jcam.Pinhole(**{k: jnp.float32(v) for k, v in c.items()})
    pts = rng.normal(scale=5.0, size=(100, 3)).astype(np.float32)
    pts[:, 2] = np.abs(pts[:, 2]) + 0.5
    pts[:5, 2] = -1.0  # behind the camera: flagged invalid
    uv_t, ok_t = tcam.project(cam_t, torch.from_numpy(pts))
    uv_j, ok_j = jcam.project(cam_j, jnp.asarray(pts))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    _close(uv_t, uv_j, atol=1e-3)  # pixels up to ~1e4: f32 relative 1e-7
    depth = pts[:, 2]
    _close(tcam.backproject(cam_t, uv_t, torch.from_numpy(depth)),
           jcam.backproject(cam_j, uv_j, jnp.asarray(depth)), atol=1e-4)
    np.testing.assert_allclose(cam_t.K().numpy(), np.asarray(cam_j.K), rtol=1e-7)


def _spd(n, batch, seed):
    A = _rng(seed).normal(size=(batch, n, n)).astype(np.float32)
    return A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)


@pytest.mark.parametrize("n", [3, 6, 12])
def test_cholesky_and_solves(n):
    B = _spd(n, 32, seed=n)
    b = _rng(n + 1).normal(size=(32, n)).astype(np.float32)
    L_t = tla.cholesky_small(torch.from_numpy(B))
    L_j = jla.cholesky_small(jnp.asarray(B))
    _close(L_t, L_j, atol=1e-4, rtol=1e-5)
    _close(tla.chol_solve_small(L_t, torch.from_numpy(b)),
           jla.chol_solve_small(L_j, jnp.asarray(b)), atol=1e-4, rtol=1e-4)
    _close(tla.spd_solve(torch.from_numpy(B), torch.from_numpy(b)),
           jla.spd_solve(jnp.asarray(B), jnp.asarray(b)), atol=1e-4, rtol=1e-4)


def test_null_vector_matches_up_to_sign():
    rng = _rng(7)
    # Near-singular 12x12 systems, as the P6P DLT builds them (sigma_min
    # ~1e-2: well above f32 round-off of A^T A, as for real samples).
    x = rng.normal(size=(16, 12)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    A = rng.normal(size=(16, 12, 12)).astype(np.float32)
    A -= (A @ x[:, :, None]) * x[:, None, :]
    A += rng.normal(scale=1e-2, size=A.shape).astype(np.float32)
    v_t = tla.null_vector(torch.from_numpy(A)).numpy()
    v_j = np.asarray(jla.null_vector(jnp.asarray(A)))
    sign = np.sign(np.sum(v_t * v_j, axis=1, keepdims=True))
    np.testing.assert_allclose(v_t * sign, v_j, atol=1e-3)
    assert np.all(np.abs(np.sum(v_t * x, axis=1)) > 0.99)


def test_det_and_eigh3x3():
    rng = _rng(8)
    M = rng.normal(size=(64, 3, 3)).astype(np.float32)
    _close(tla.det3x3(torch.from_numpy(M)), jla.det3x3(jnp.asarray(M)), atol=1e-5)
    S = M @ M.transpose(0, 2, 1)
    lam_t, V_t = tla.eigh3x3(torch.from_numpy(S))
    lam_j, V_j = jla.eigh3x3(jnp.asarray(S))
    _close(lam_t, lam_j, atol=1e-4, rtol=1e-4)
    # Eigenvectors up to sign, per column.
    V_t, V_j = V_t.numpy(), np.asarray(V_j)
    sign = np.sign(np.sum(V_t * V_j, axis=1, keepdims=True))
    np.testing.assert_allclose(V_t * sign, V_j, atol=2e-3)
