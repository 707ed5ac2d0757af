"""Port parity: PnP-RANSAC, triangulation, SOR and the keyframe ring.

The PnP solve is compared on the SAME minimal sets: JAX draws them with its
own ``_sample_minimal_sets`` (exactly as its ``pnp_ransac`` does from the
key), and the port's ``_pnp_from_sets`` takes them as given.  Tolerances:
pose entries 1e-4 (rotation) and 1e-3 m (translation) after 2 x 4 float32
Gauss-Newton rounds; inlier sets and counts must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.models.state import KeyframeStore as JKeyframeStore
from ros_stereo_slam_tpu.models.state import TrackState as JTrackState
from ros_stereo_slam_tpu.ops import pnp as jpnp
from ros_stereo_slam_tpu.ops import ransac as jransac
from ros_stereo_slam_tpu.ops import sor as jsor
from ros_stereo_slam_tpu.ops import triangulate as jtri
from ros_stereo_slam_tpu.utils import camera as jcam
from ros_stereo_slam_tpu.utils import lie as jlie
from ros_stereo_slam_tpu_torch.models import step as tstep
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore, TrackState
from ros_stereo_slam_tpu_torch.ops import pnp as tpnp
from ros_stereo_slam_tpu_torch.ops import ransac as transac
from ros_stereo_slam_tpu_torch.ops import sor as tsor
from ros_stereo_slam_tpu_torch.ops import triangulate as ttri
from ros_stereo_slam_tpu_torch.utils import camera as tcam

CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)
CAM_T = tcam.Pinhole(**CAM)
CAM_J = jcam.Pinhole(**{k: jnp.float32(v) for k, v in CAM.items()})


def _scene(seed=0, n=400, noise_px=0.3, outlier_frac=0.2):
    """World points in front of a camera, a GT cam-from-world pose, noisy
    observations with gross outliers, and a validity mask."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 60, n)], 1).astype(np.float32)
    xi = np.concatenate([rng.normal(scale=0.3, size=3),
                         rng.normal(scale=0.02, size=3)]).astype(np.float32)
    T = np.array(jlie.exp_se3(jnp.asarray(xi)))
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM["fx"] * pc[:, 0] / pc[:, 2] + CAM["cx"],
                   CAM["fy"] * pc[:, 1] / pc[:, 2] + CAM["cy"]], 1)
    uv += rng.normal(scale=noise_px, size=uv.shape)
    bad = rng.random(n) < outlier_frac
    uv[bad] += rng.uniform(15, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    mask = rng.random(n) > 0.1
    prior = np.array(jlie.exp_se3(jnp.asarray(xi + 0.01)))  # a nearby prior
    return X, uv.astype(np.float32), mask, T, prior


@pytest.mark.parametrize("case", ["dlt_only", "with_prior", "starved_retry"])
def test_pnp_from_jax_sets_matches_jax(case):
    X, uv, mask, T_gt, prior = _scene(seed={"dlt_only": 1, "with_prior": 2,
                                          "starved_retry": 3}[case])
    kw = dict(thresh_px=1.0, refine_iters=4, retry_thresh_px=8.0, min_inliers=10,
              huber_px=0.5)
    T_init = None
    if case != "dlt_only":
        T_init = prior
    if case == "starved_retry":
        kw.update(thresh_px=0.02, min_inliers=300)
    iters = 128
    key = jax.random.PRNGKey(7)
    jres = jpnp.pnp_ransac(
        key, CAM_J, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask), iters=iters,
        T_init=None if T_init is None else jnp.asarray(T_init), **kw)
    k_dlt, k_gn = jax.random.split(key)
    idx = jransac._sample_minimal_sets(k_dlt, jnp.asarray(mask), iters, 6)
    idx2 = (jransac._sample_minimal_sets(k_gn, jnp.asarray(mask), max(iters // 4, 16), 8)
            if T_init is not None else None)
    tres = tpnp._pnp_from_sets(
        torch.from_numpy(np.array(idx)).long(),
        None if idx2 is None else torch.from_numpy(np.array(idx2)).long(),
        CAM_T, torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(mask),
        T_init=None if T_init is None else torch.from_numpy(T_init), **kw)
    assert bool(tres.used_retry) == bool(jres.used_retry) == (case == "starved_retry")
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers)
    Tt, Tj = tres.T_cw.numpy(), np.asarray(jres.T_cw)
    np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-3)
    np.testing.assert_allclose(Tt[:3, 3], T_gt[:3, 3], atol=0.05)  # and it is right


def test_pnp_ransac_generator_recovers_pose_deterministically():
    X, uv, mask, T_gt, prior = _scene(seed=4)
    args = (CAM_T, torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(mask))
    kw = dict(thresh_px=1.0, iters=128, refine_iters=4, T_init=torch.from_numpy(prior),
              retry_thresh_px=8.0, min_inliers=10)
    a = tpnp.pnp_ransac(torch.Generator().manual_seed(3), *args, **kw)
    b = tpnp.pnp_ransac(torch.Generator().manual_seed(3), *args, **kw)
    assert torch.equal(a.T_cw, b.T_cw) and torch.equal(a.inliers, b.inliers)
    np.testing.assert_allclose(a.T_cw.numpy()[:3, 3], T_gt[:3, 3], atol=0.05)
    np.testing.assert_allclose(a.T_cw.numpy()[:3, :3], T_gt[:3, :3], atol=2e-3)
    assert int(a.n_inliers) > 0.6 * mask.sum()


def test_sample_minimal_sets_rows_are_distinct_valid_points():
    mask = torch.from_numpy(np.random.default_rng(5).random(300) > 0.5)
    idx = transac._sample_minimal_sets(torch.Generator().manual_seed(0), mask, 64, 8)
    assert idx.shape == (64, 8)
    assert bool(mask[idx].all())
    assert all(len(set(row.tolist())) == 8 for row in idx)


def test_triangulate_rectified_matches_jax():
    rng = np.random.default_rng(6)
    uvl = np.stack([rng.uniform(0, 1241, 300), rng.uniform(0, 376, 300)], 1)
    d = rng.uniform(-1, 60, 300)
    uvr = uvl - np.stack([d, rng.normal(scale=1.5, size=300)], 1)
    mask = rng.random(300) > 0.2
    args = [a.astype(np.float32) for a in (uvl, uvr)]
    t = ttri.triangulate_rectified(CAM_T, 0.54, *map(torch.from_numpy, args),
                                   torch.from_numpy(mask))
    j = jtri.triangulate_rectified(CAM_J, jnp.float32(0.54), *map(jnp.asarray, args),
                                   jnp.asarray(mask))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    v = t.valid.numpy()
    np.testing.assert_allclose(t.points.numpy()[v], np.asarray(j.points)[v], rtol=1e-5)


def test_sor_filter_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=2.0, size=(768, 3)) + np.array([0.0, 0.0, 20.0])
    pts[:40] += rng.uniform(20, 60, (40, 3))  # isolated outliers
    pts[40:45, 2] = -3.0  # behind the camera
    pts[45:50, 2] = 900.0  # past max depth
    mask = rng.random(768) > 0.1
    pts = pts.astype(np.float32)
    t = tsor.sor_filter(torch.from_numpy(pts), torch.from_numpy(mask), mean_k=32)
    j = jsor.sor_filter(jnp.asarray(pts), jnp.asarray(mask), mean_k=32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert not t.numpy()[:50].any() and t.numpy().sum() > 600


def test_keyframe_ring_matches_jax():
    cap, n = 4, 16
    tkf = KeyframeStore.empty(cap, n, "cpu")
    jkf = JKeyframeStore.empty(cap, n)
    rng = np.random.default_rng(8)
    for frame in range(6):  # wraps the ring
        p3 = rng.normal(size=(n, 3)).astype(np.float32)
        col = rng.random((n, 3)).astype(np.float32)
        m = rng.random(n) > 0.3
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = frame
        tkf = tstep._insert_keyframe(
            tkf, TrackState(torch.zeros(n, 2), torch.from_numpy(p3),
                            torch.from_numpy(col), torch.from_numpy(m)),
            torch.from_numpy(T), 10 * frame)
        jkf = jstep._insert_keyframe(
            jkf, JTrackState(jnp.zeros((n, 2)), jnp.asarray(p3), jnp.asarray(col),
                             jnp.asarray(m)),
            jnp.asarray(T), jnp.int32(10 * frame))
    for name in KeyframeStore._fields:
        np.testing.assert_array_equal(getattr(tkf, name).numpy(),
                                      np.asarray(getattr(jkf, name)), err_msg=name)
