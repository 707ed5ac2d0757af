"""Fault F5 pinned: the 8-point F's null vector does not converge.

Both packages solve each 8-point set with four steps of shifted inverse
iteration in float32 (``linalg.null_vector``), not an SVD.  On the
temporal LK track of ``small_world`` frames 0 -> 1 (seeds 3 and 7, grid
step 12, JAX's LK), with the 128 minimal sets JAX draws from key 5 and the
1 px gate, each set's inlier count is held against a float64 witness: the
SVD null vector of the same normalized design, the same rank-2 projection
(by SVD) and Sampson gate.  What the test records:

- per set, each package's count strays from the witness's by tens of
  inliers on some set (> 40; 67-224 measured) while most sets agree;
- each package's best set keeps no more inliers than the witness's best.

It changes no behaviour.  When the solve is made exact, the first
assertion fails: turn this test into a parity test then.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import frontend as jfrontend
from ros_stereo_slam_tpu.ops import grid as jgrid
from ros_stereo_slam_tpu.ops import lk as jlk
from ros_stereo_slam_tpu.ops import pyramid as jpyr
from ros_stereo_slam_tpu.ops import ransac as jransac
from ros_stereo_slam_tpu_torch.ops import ransac

N_SETS = 128


def _normalizer(p: np.ndarray, mask: np.ndarray) -> np.ndarray:
    mean = p[mask].astype(np.float64).mean(0)
    s = np.sqrt(2.0) / np.sqrt(((p[mask] - mean) ** 2).sum(1)).mean()
    return np.array([[s, 0.0, -s * mean[0]], [0.0, s, -s * mean[1]], [0.0, 0.0, 1.0]])


def _witness_counts(idx, p1, p2, mask, thresh):
    """Per-set inlier counts of the float64 SVD solve."""
    T1, T2 = _normalizer(p1, mask), _normalizer(p2, mask)
    h1 = np.c_[p1.astype(np.float64), np.ones(len(p1))]
    h2 = np.c_[p2.astype(np.float64), np.ones(len(p2))]
    n1, n2 = h1 @ T1.T, h2 @ T2.T
    counts = []
    for s in idx:
        a, b = n1[s], n2[s]
        A = np.stack([b[:, 0] * a[:, 0], b[:, 0] * a[:, 1], b[:, 0], b[:, 1] * a[:, 0],
                      b[:, 1] * a[:, 1], b[:, 1], a[:, 0], a[:, 1], np.ones(8)], 1)
        U, S, Vt = np.linalg.svd(np.linalg.svd(A)[2][-1].reshape(3, 3))
        F = T2.T @ (U @ np.diag([S[0], S[1], 0.0]) @ Vt) @ T1
        Fx1, Ftx2 = h1 @ F.T, h2 @ F
        e = np.sum(h2 * Fx1, 1) ** 2 / np.maximum(
            Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2, 1e-12)
        counts.append(int(((e < thresh**2) & mask).sum()))
    return np.array(counts)


def _port_counts(idx, p1, p2, mask, thresh):
    """Per-set inlier counts of the port's solve (``_fmat_from_sets`` before
    its refit)."""
    P1, P2, M = map(torch.from_numpy, (p1, p2, mask))
    T1 = ransac._build_T(*ransac._normalization_stats(P1, M))
    T2 = ransac._build_T(*ransac._normalization_stats(P2, M))
    p1n, p2n = P1 * T1[0, 0] + T1[:2, 2], P2 * T2[0, 0] + T2[:2, 2]
    sel = torch.from_numpy(idx).long()
    F = torch.einsum("ji,kjl,lm->kim", T2, ransac._eight_point(p1n[sel], p2n[sel]), T1)
    ones = torch.ones((len(p1), 1))
    err = ransac.sampson_distance(F, torch.cat([P1, ones], 1), torch.cat([P2, ones], 1))
    return ((err < thresh**2) & M[None]).sum(1).numpy()


@jax.jit
def _jax_counts(idx, p1, p2, mask, thresh):
    """Per-set inlier counts of the JAX package's solve (``fmat_ransac``
    before its refit)."""
    T1 = jransac._build_T(*jransac._normalization_stats(p1, mask))
    T2 = jransac._build_T(*jransac._normalization_stats(p2, mask))
    p1n, p2n = p1 * T1[0, 0] + T1[:2, 2], p2 * T2[0, 0] + T2[:2, 2]
    F = jnp.einsum("ji,kjl,lm->kim", T2, jax.vmap(jransac._eight_point)(p1n[idx], p2n[idx]), T1)
    ones = jnp.ones((p1.shape[0], 1))
    err = jransac.sampson_distance(F, jnp.concatenate([p1, ones], 1),
                                   jnp.concatenate([p2, ones], 1))
    return jnp.sum((err < thresh**2) & mask[None], 1)


@pytest.mark.parametrize("seed", [3, 7])
def test_f5_eight_point_counts_stray_from_float64_witness(seed):
    w = small_world(n_frames=2, seed=seed)
    fe = JFrontend(grid_step=12, max_points=1024)
    pts, valid = jgrid.grid_points(w.camera.height, w.camera.width, fe.grid_step, fe.max_points)
    tr = jlk.track(tuple(jpyr.build_pyramid(jnp.asarray(w.render(0)[0]), fe.lk_levels)),
                   tuple(jpyr.build_pyramid(jnp.asarray(w.render(1)[0]), fe.lk_levels)),
                   jnp.asarray(pts), None, jfrontend._lk_params(fe))
    mask = np.asarray(tr.valid) & np.asarray(valid)
    p1, p2 = np.array(pts, np.float32), np.array(tr.points, np.float32)
    thresh = fe.fmat_thresh_px
    idx = np.asarray(jransac._sample_minimal_sets(jax.random.PRNGKey(5), jnp.asarray(mask),
                                                  N_SETS, 8))
    wit = _witness_counts(idx, p1, p2, mask, thresh)
    port = _port_counts(idx, p1, p2, mask, thresh)
    jaxc = np.asarray(_jax_counts(*(jnp.asarray(a) for a in (idx, p1, p2, mask)), thresh))
    assert mask.sum() > 500 and wit.max() > 0.8 * mask.sum()
    for name, c in (("port", port), ("jax", jaxc)):
        stray = np.abs(c - wit)
        assert stray.max() > 40, (name, stray.max())  # F5: some sets' F is far off
        assert np.median(stray) <= 2, (name, np.median(stray))  # most sets agree
        assert c.max() <= wit.max(), (name, c.max(), wit.max())
