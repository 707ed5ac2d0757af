"""Essential matrix and monocular pose recovery (``ops/essential.py``): the
port against ground truth and against the JAX package.

Mirrors the six tests of tests/test_essential.py, with their bounds, on
the same correspondences (the JAX package's LK tracks of frame 0 -> 1) and
with the minimal sets drawn by JAX (its random streams are not torch's)
fed to ``_essential_from_sets``.  Against JAX's own result from those
sets: inlier counts within 1 % of the valid points (the analytic 3x3
eigendecomposition and the MSAC sums round differently; 1 of 384
measured), E parallel to JAX's (1 - |cos| < 1e-4), R within 1e-3 and the
unit t within 5e-3 (2.4e-5 and 1.5e-3 measured), the projected manifold
matrices within 1e-4, and the midpoint depths within 1e-4 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.ops import essential as jess
from ros_stereo_slam_tpu.ops import grid, lk
from ros_stereo_slam_tpu.ops import ransac as jransac
from ros_stereo_slam_tpu.utils.camera import Pinhole as JPinhole
from ros_stereo_slam_tpu_torch.ops import essential
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    world = small_world(n_frames=3, seed=7)
    c = world.camera
    jcam = JPinhole(fx=jnp.float32(c.fx), fy=jnp.float32(c.fy), cx=jnp.float32(c.cx),
                    cy=jnp.float32(c.cy))
    cam = Pinhole(fx=float(c.fx), fy=float(c.fy), cx=float(c.cx), cy=float(c.cy))
    L0, R0, D0 = world.render(0)
    L1, _, _ = world.render(1)
    pts, mask = grid.grid_points(c.height, c.width, 15, 512)
    tr = lk.track_images(jnp.asarray(L0), jnp.asarray(L1), jnp.asarray(pts))
    m = np.asarray(tr.valid) & np.asarray(mask)
    T21 = np.linalg.inv(world.poses[1]) @ world.poses[0]
    return world, cam, jcam, np.array(pts), np.array(tr.points), m, T21, (L0, R0, D0)


def _port(seed, cam, pts1, pts2, m, iters=256):
    """The port's monocular flow on JAX's minimal sets for PRNGKey(seed)."""
    idx = np.array(jransac._sample_minimal_sets(jax.random.PRNGKey(seed), jnp.asarray(m),
                                                iters, 8))
    t = [torch.from_numpy(np.ascontiguousarray(x)) for x in (pts1, pts2, m)]
    er = essential._essential_from_sets(torch.from_numpy(idx), cam, *t, 1.0)
    return er, essential.recover_pose(er.E, cam, *t[:2], er.inliers)


def _rot_err_deg(Ra, Rb):
    return np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1)))


def _against_jax(er, rp, jer, jrp, n_valid):
    assert abs(int(er.n_inliers) - int(jer.n_inliers)) <= 0.01 * n_valid
    E, jE = er.E.numpy(), np.asarray(jer.E)
    assert 1 - abs((E * jE).sum()) / (np.linalg.norm(E) * np.linalg.norm(jE)) < 1e-4
    np.testing.assert_allclose(rp.R.numpy(), np.asarray(jrp.R), atol=1e-3)
    np.testing.assert_allclose(rp.t.numpy(), np.asarray(jrp.t), atol=5e-3)


def test_essential_ransac_inliers_and_epipolar(setup):
    _, cam, jcam, pts, cur, m, T21, _ = setup
    er, rp = _port(0, cam, pts, cur, m)
    n_valid = int(m.sum())
    assert int(er.n_inliers) > 0.7 * n_valid
    R, t = T21[:3, :3], T21[:3, 3]
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E_gt = tx @ R
    E = er.E.numpy()
    assert abs(np.sum(E * E_gt)) / (np.linalg.norm(E) * np.linalg.norm(E_gt)) > 0.995
    jer, jrp = jess.monocular_triangulate(jax.random.PRNGKey(0), jcam, jnp.asarray(pts),
                                          jnp.asarray(cur), jnp.asarray(m), 1.0, 256)
    _against_jax(er, rp, jer, jrp, n_valid)


def test_project_essential_singular_values():
    rng = np.random.default_rng(0)
    M = rng.standard_normal((4, 3, 3)).astype(np.float32)
    E = essential.project_essential(torch.from_numpy(M)).numpy()
    s = np.linalg.svd(E, compute_uv=False)
    np.testing.assert_allclose(s[:, 0], s[:, 1], rtol=1e-3)
    assert np.all(s[:, 2] < 1e-3 * s[:, 0])
    np.testing.assert_allclose(E, np.asarray(jax.vmap(jess.project_essential)(jnp.asarray(M))),
                               atol=1e-4)


def test_recover_pose_matches_gt(setup):
    _, cam, jcam, pts, cur, m, T21, _ = setup
    er, rp = _port(1, cam, pts, cur, m)
    R_gt, t_gt = T21[:3, :3], T21[:3, 3]
    assert _rot_err_deg(R_gt, rp.R.numpy()) < 0.2
    assert abs(np.dot(rp.t.numpy(), t_gt / np.linalg.norm(t_gt))) > 0.99
    assert int(rp.n_good) > 0.8 * int(er.n_inliers)
    jer, jrp = jess.monocular_triangulate(jax.random.PRNGKey(1), jcam, jnp.asarray(pts),
                                          jnp.asarray(cur), jnp.asarray(m), 1.0, 256)
    _against_jax(er, rp, jer, jrp, int(m.sum()))


def test_exact_correspondences_tight(setup):
    world, cam, _, pts, _, _, T21, (_, _, D0) = setup
    c = world.camera
    z = D0[np.clip(pts[:, 1].astype(int), 0, c.height - 1),
           np.clip(pts[:, 0].astype(int), 0, c.width - 1)]
    x = (pts[:, 0] - c.cx) / c.fx * z
    y = (pts[:, 1] - c.cy) / c.fy * z
    P2 = np.stack([x, y, z], 1) @ T21[:3, :3].T + T21[:3, 3]
    uv2 = np.stack([P2[:, 0] / P2[:, 2] * c.fx + c.cx, P2[:, 1] / P2[:, 2] * c.fy + c.cy], 1)
    m = ((P2[:, 2] > 0.1) & (uv2[:, 0] >= 0) & (uv2[:, 0] < c.width)
         & (uv2[:, 1] >= 0) & (uv2[:, 1] < c.height) & np.isfinite(z))
    er, rp = _port(1, cam, pts.astype(np.float32), uv2.astype(np.float32), m)
    assert int(er.n_inliers) > 0.95 * int(m.sum())
    assert _rot_err_deg(T21[:3, :3], rp.R.numpy()) < 0.1
    assert abs(np.dot(rp.t.numpy(), T21[:3, 3] / np.linalg.norm(T21[:3, 3]))) > 0.9999


def test_midpoint_depth_matches_stereo_oracle(setup):
    world, cam, jcam, pts, _, _, _, (L0, R0, D0) = setup
    c = world.camera
    tr = lk.track_images(jnp.asarray(L0), jnp.asarray(R0), jnp.asarray(pts))
    m = np.asarray(tr.valid)
    right = np.array(tr.points)
    x1 = essential.normalized_coords(cam, torch.from_numpy(pts))
    x2 = essential.normalized_coords(cam, torch.from_numpy(right))
    t = torch.tensor([-c.baseline, 0.0, 0.0], dtype=torch.float32)
    _, z1, _ = essential.midpoint_triangulate(torch.eye(3), t, x1, x2)
    z1 = z1.numpy()
    gt = D0[np.clip(pts[:, 1].astype(int), 0, c.height - 1),
            np.clip(pts[:, 0].astype(int), 0, c.width - 1)]
    sel = m & (gt < 60) & (z1 > 0)
    assert np.median(np.abs(z1[sel] - gt[sel])) < 0.5
    _, jz1, _ = jess.midpoint_triangulate(
        jnp.eye(3), jnp.asarray(t.numpy()), jess.normalized_coords(jcam, jnp.asarray(pts)),
        jess.normalized_coords(jcam, jnp.asarray(right)))
    np.testing.assert_allclose(z1[sel], np.asarray(jz1)[sel], rtol=1e-4)


def test_degenerate_all_masked(setup):
    _, cam, _, pts, cur, _, _, _ = setup
    m0 = np.zeros((pts.shape[0],), bool)
    er, rp = _port(2, cam, pts, cur, m0, iters=64)
    assert int(er.n_inliers) == 0
    assert np.all(np.isfinite(rp.R.numpy())) and np.all(np.isfinite(rp.t.numpy()))
    # the sampling entry point too
    gen = torch.Generator().manual_seed(2)
    er2, rp2 = essential.monocular_triangulate(gen, cam, torch.from_numpy(pts),
                                               torch.from_numpy(cur), torch.from_numpy(m0),
                                               1.0, 64)
    assert int(er2.n_inliers) == 0 and bool(torch.isfinite(rp2.R).all())
