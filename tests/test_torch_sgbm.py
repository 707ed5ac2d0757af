"""Dense disparity (``ops/sgbm.py``): the port against the synthetic depth
oracle and against the JAX package.

Mirrors tests/test_sgbm.py (its bounds on the port: > 20 % of pixels
valid, median error < 1 px, < 15 % bad pixels over 3 px; the reprojected
depth within 1e-4 relative of the oracle).  Against JAX on the same
pair: the cost volume and each direction's aggregation within 1e-6 (the
shifted adds run in the reference's order; equal on this host), the same
valid pixels, disparities within 1e-5 px, and the node's whole flow
(``depth_cloud``: cloud -> 4,096-point subsample -> SOR) keeping the
points that the JAX package's ``tools/stereo_depth.py`` flow keeps,
within 1e-4 m.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.ops import sgbm as jsgbm
from ros_stereo_slam_tpu.ops import sor as jsor
from ros_stereo_slam_tpu.utils.camera import Pinhole as JPinhole
from ros_stereo_slam_tpu_torch.ops import sgbm
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    world = small_world(n_frames=1, seed=31)
    L, R, D = world.render(0)
    return world.camera, L, R, D


def _cams(c):
    return (Pinhole(fx=float(c.fx), fy=float(c.fy), cx=float(c.cx), cy=float(c.cy)),
            JPinhole(fx=jnp.float32(c.fx), fy=jnp.float32(c.fy), cx=jnp.float32(c.cx),
                     cy=jnp.float32(c.cy)))


def test_sgbm_recovers_synthetic_disparity(pair):
    camc, L, R, D = pair
    gt_disp = camc.fx * camc.baseline / D
    res = sgbm.sgbm(torch.from_numpy(L), torch.from_numpy(R), max_disp=64, block=7)
    disp, valid = res.disparity.numpy(), res.valid.numpy()
    H, W = L.shape
    m = valid.copy()
    m[:10] = m[-10:] = False
    m[:, :70] = m[:, -10:] = False
    m &= (gt_disp > 2.0) & (gt_disp < 60.0)
    assert m.sum() > 0.2 * H * W, f"too few valid disparities: {m.sum()}"
    err = np.abs(disp[m] - gt_disp[m])
    assert np.median(err) < 1.0, f"median disparity error {np.median(err):.2f}"
    assert (err > 3.0).mean() < 0.15, f"bad-pixel rate {(err > 3).mean():.3f}"

    jres = jsgbm.sgbm(jnp.asarray(L), jnp.asarray(R), max_disp=64, block=7)
    np.testing.assert_array_equal(valid, np.asarray(jres.valid))
    np.testing.assert_allclose(disp, np.asarray(jres.disparity), rtol=0, atol=1e-5)


def test_disparity_to_cloud():
    world = small_world(n_frames=1, seed=32)
    _, _, D = world.render(0)
    camc = world.camera
    cam, _ = _cams(camc)
    gt_disp = torch.from_numpy((camc.fx * camc.baseline / D).astype(np.float32))
    pts, ok = sgbm.disparity_to_cloud(cam, camc.baseline, gt_disp,
                                      torch.ones_like(gt_disp, dtype=torch.bool), max_depth=100.0)
    z = pts[:, 2].numpy().reshape(D.shape)
    keep = ok.numpy().reshape(D.shape)
    assert keep.mean() > 0.5
    np.testing.assert_allclose(z[keep], D[keep], rtol=1e-4)


def test_cost_volume_and_aggregation_equal_jax(pair):
    _, L, R, _ = pair
    L, R = L[40:104, 100:260], R[40:104, 100:260]
    vol = sgbm.cost_volume(torch.from_numpy(L), torch.from_numpy(R), 24, 7)
    jvol = np.array(jsgbm.cost_volume(jnp.asarray(L), jnp.asarray(R), 24, 7))
    assert vol.shape == (64, 160, 24)
    np.testing.assert_allclose(vol.numpy(), jvol, rtol=0, atol=1e-6)
    for axis, reverse in ((1, False), (1, True), (0, False), (0, True)):
        agg = sgbm._aggregate_dir(torch.from_numpy(jvol), 0.03, 0.12, axis, reverse)
        jagg = jsgbm._aggregate_dir(jnp.asarray(jvol), 0.03, 0.12, axis, reverse)
        np.testing.assert_allclose(agg.numpy(), np.asarray(jagg), rtol=0, atol=1e-6,
                                   err_msg=f"axis {axis} reverse {reverse}")
    rv = sgbm._right_volume_from_left(torch.from_numpy(jvol), 24)
    np.testing.assert_array_equal(rv.numpy(),
                                  np.asarray(jsgbm._right_volume_from_left(jnp.asarray(jvol), 24)))


def test_depth_cloud_equals_the_node_flow(pair):
    camc, L, R, _ = pair
    cam, jcam = _cams(camc)
    res, pts = sgbm.depth_cloud(torch.from_numpy(L), torch.from_numpy(R), cam, camc.baseline,
                                max_disp=64)
    # tools/stereo_depth.py's flow on the JAX package's disparity
    jres = jsgbm.sgbm(jnp.asarray(L), jnp.asarray(R), max_disp=64)
    jpts, jok = jsgbm.disparity_to_cloud(jcam, camc.baseline, jres.disparity, jres.valid)
    jp = np.asarray(jpts)[np.asarray(jok)]
    assert len(jp) > 4096
    jp = jp[np.linspace(0, len(jp) - 1, 4096).astype(int)]
    keep = np.asarray(jsor.sor_filter(jnp.asarray(jp), jnp.ones(len(jp), bool), mean_k=20,
                                      std_mul=0.8))
    assert 0.5 * 4096 < pts.shape[0] == keep.sum()
    np.testing.assert_allclose(pts.numpy(), jp[keep], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(res.valid.numpy(), np.asarray(jres.valid))
