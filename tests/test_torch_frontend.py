"""The frontend choices of the frame step: the port against the JAX package.

``sampler="anms"`` (FAST + ANMS keypoints), ``fmat_gate="ransac"`` (the
temporal F-matrix gate before PnP) and ``stereo_gate="fmat"`` (the
F-matrix gate on the stereo matches); ORB stereo is in
tests/test_torch_match.py.  Bounds:

- the ANMS keypoints of a bootstrap equal, point for point, JAX's
  ``anms`` fed by ``fast.top_corners(exact=True)`` (the corners are
  integer pixels, so the radii are exact);
- each F-gate with index sets drawn by JAX (its random streams are not
  torch's) gives JAX's inlier mask exactly, on the gate's own inputs and
  settings (temporal: the LK track of frame 0 -> 1, 1 px; stereo: the
  L->R LK match of frame 0, 3 px);
- ``_happy_levels`` as tests/test_seeding.py asserts it of JAX: the
  seeded depth for the grid with LK stereo, the full pyramid for the ANMS
  sampler and ORB stereo, and the carried reference pyramid as deep;
- ``run_offline`` of each choice on the 6-frame world of
  tests/test_match.py: every frame tracked, the same keyframes as JAX's
  run, and each position within 4 cm of JAX's (the RANSAC draws differ;
  the JAX run's own error against ground truth reaches 5 cm there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import preset_odometry as j_preset
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import frontend as jfrontend
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.ops import anms as janms
from ros_stereo_slam_tpu.ops import fast as jfast
from ros_stereo_slam_tpu.ops import grid as jgrid
from ros_stereo_slam_tpu.ops import lk as jlk
from ros_stereo_slam_tpu.ops import pyramid as jpyr
from ros_stereo_slam_tpu.ops import ransac as jransac
from ros_stereo_slam_tpu_torch.config import FrontendConfig, preset_odometry
from ros_stereo_slam_tpu_torch.models import pipeline, step
from ros_stereo_slam_tpu_torch.ops import ransac

POS_TOL_M = 0.04
CHOICES = {"anms": dict(sampler="anms"), "fmat_gate": dict(fmat_gate="ransac"),
           "stereo_gate": dict(stereo_gate="fmat")}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = small_world(n_frames=6, seed=3)
    frames = [w.render(i) for i in range(6)]
    return w, np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _cfgs(camera, **choice):
    t, j = preset_odometry(), j_preset()
    return (t.replace(camera=camera, frontend=dataclasses.replace(t.frontend, **choice)),
            dataclasses.replace(j, camera=camera,
                                frontend=dataclasses.replace(j.frontend, **choice)))


def test_anms_keypoints_equal_jax(world):
    _, L, _ = world
    fe = FrontendConfig(sampler="anms")
    pts, mask = step._sample_keypoints(torch.from_numpy(L[[0, 3]]), None, None, fe)
    assert pts.shape == (2, fe.max_points, 2)
    for lane, i in enumerate((0, 3)):
        score = jfast.fast_score(jnp.asarray(L[i]), fe.fast_thresh / 255.0)
        cand = jfast.top_corners(score, 4 * fe.max_points, exact=True)
        jpts, jmask = janms.anms(*cand, fe.max_points, fe.anms_robust_coeff)
        np.testing.assert_array_equal(pts[lane].numpy(), np.asarray(jpts))
        np.testing.assert_array_equal(mask[lane].numpy(), np.asarray(jmask))
        assert mask[lane].sum() > 500


@pytest.mark.parametrize("gate", ["temporal", "stereo"])
def test_fgate_inliers_equal_jax(world, gate):
    w, L, R = world
    fe = JFrontend()
    pts, valid = jgrid.grid_points(w.camera.height, w.camera.width, fe.grid_step, fe.max_points)
    other = L[1] if gate == "temporal" else R[0]
    params = jfrontend._lk_params(fe) if gate == "temporal" else jfrontend._lk_stereo_params(fe)
    res = jlk.track(tuple(jpyr.build_pyramid(jnp.asarray(L[0]), fe.lk_levels)),
                    tuple(jpyr.build_pyramid(jnp.asarray(other), fe.lk_levels)),
                    jnp.asarray(pts), None, params)
    mask = np.asarray(res.valid) & np.asarray(valid)
    thresh = fe.fmat_thresh_px if gate == "temporal" else fe.fmat_stereo_thresh_px
    key = jax.random.PRNGKey(7)
    jres = jransac.fmat_ransac(key, jnp.asarray(pts), res.points, jnp.asarray(mask),
                               thresh_px=thresh, iters=fe.fmat_iters)
    idx = np.asarray(jransac._sample_minimal_sets(key, jnp.asarray(mask), fe.fmat_iters, 8))
    tres = ransac._fmat_from_sets(torch.from_numpy(idx), torch.from_numpy(np.array(pts)),
                                  torch.from_numpy(np.array(res.points)),
                                  torch.from_numpy(mask), thresh)
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert 0.5 * mask.sum() < int(tres.n_inliers) <= mask.sum()


@pytest.mark.parametrize("choice", ["grid", "anms", "orb"])
def test_happy_levels(world, choice):
    w, L, R = world
    kw = {"grid": {}, "anms": dict(sampler="anms"), "orb": dict(stereo_matcher="orb")}[choice]
    fe = FrontendConfig(grid_step=12, max_points=1024, **kw)
    want = (max(fe.lk_seeded_levels, fe.lk_stereo_seeded_levels) if choice == "grid"
            else fe.lk_levels)
    assert step._happy_levels(fe) == want
    assert jstep._happy_levels(JFrontend(grid_step=12, max_points=1024, **kw)) == want
    cfg = preset_odometry().replace(camera=w.camera, frontend=fe)
    gp, gm = pipeline._grid_for(cfg, "cpu")
    carry = step.init_carry(torch.from_numpy(L[0]), torch.from_numpy(R[0]), gp, gm, 0, cfg)
    assert len(carry.ref_pyr) == want
    carry, _ = step.slam_frame_step(carry, torch.from_numpy(L[1]), torch.from_numpy(R[1]),
                                    gp, gm, cfg)
    assert len(carry.ref_pyr) == want


@pytest.mark.parametrize("choice", sorted(CHOICES))
def test_run_offline_equals_jax(world, choice):
    w, L, R = world
    tcfg, jcfg = _cfgs(w.camera, **CHOICES[choice])
    jres = jpipe.run_offline(jcfg, L, R)
    res = pipeline.run_offline(tcfg, L, R, device="cpu")
    assert res.tracking_ok.all() and jres.tracking_ok.all(), (res.n_inliers, jres.n_inliers)
    np.testing.assert_array_equal(res.is_keyframe, jres.is_keyframe)
    diff = np.linalg.norm(res.trajectory[:, :3, 3] - jres.trajectory[:, :3, 3], axis=1)
    assert diff.max() < POS_TOL_M, diff
