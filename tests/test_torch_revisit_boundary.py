"""The revisit world's lap boundary: the JAX package and the port on the
same frames, as a second witness for the seed pairs that lose tracking.

Frame 256 of ``chip_smoke.py``'s 257-frame revisit worlds starts a third
lap with a fresh pose jitter and brightness, a jump that some (plan,
world) seed pairs do not survive.  Here frames 240..256 of four pairs
(chip_smoke's worlds A = (17, 11) and B = (53, 59), and two pairs that
lost frame 256: (23, 29) in the port's full-size batched run and (23, 13))
are rendered at half resolution (620x188; the full-size worlds' poses,
textures and per-lap brightness, the sensor noise drawn at this size) and
run from frame 240 through both packages' ``run_offline`` at the
odometry configuration of tests/test_torch_slice.py (grid step 12: the
point density of grid step 24 at full size).

Bounds: the tracking flags are equal on every frame; at frame 256 the
inlier counts agree within 10 (the RANSAC draws differ; 0-2 apart when
written); and the JAX package itself loses frame 256 of (23, 13), so that
loss belongs to the world, not to the port.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import KeyframeConfig as JKeyframe
from ros_stereo_slam_tpu.config import preset_odometry as j_preset
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu_torch.config import (
    CameraConfig, FrontendConfig, KeyframeConfig, preset_odometry,
)
from ros_stereo_slam_tpu_torch.models import pipeline

FIRST = 240
PAIRS = [(17, 11), (53, 59), (23, 29), (23, 13)]
LOST_AT_256 = {(23, 13)}
INLIER_TOL = 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cfgs():
    jcam = small_world().camera
    kf = dict(max_keyframes=16, min_pnp_inliers=150, map_block_points=1024)
    t = preset_odometry().replace(camera=CameraConfig(**vars(jcam)),
                                  frontend=FrontendConfig(grid_step=12, max_points=1024),
                                  keyframes=KeyframeConfig(**kf))
    j = j_preset().replace(camera=jcam, frontend=JFrontend(grid_step=12, max_points=1024),
                           keyframes=JKeyframe(**kf))
    return t, j


@pytest.mark.parametrize("seeds", PAIRS, ids=[f"{p}-{w}" for p, w in PAIRS])
def test_lap_boundary_matches_jax(cfgs, seeds):
    tcfg, jcfg = cfgs
    left, right = chip_smoke.revisit_frames(
        seeds, list(range(FIRST, chip_smoke.SLAM_FRAMES + 1)), camera=tcfg.camera,
        noise_seed=seeds[0] * 1000 + seeds[1])
    jres = jpipe.run_offline(jcfg, left, right)
    tres = pipeline.run_offline(tcfg, left, right, device="cpu")
    j_ok, j_inl = np.asarray(jres.tracking_ok), np.asarray(jres.n_inliers)
    np.testing.assert_array_equal(tres.tracking_ok, j_ok)
    assert abs(int(tres.n_inliers[-1]) - int(j_inl[-1])) <= INLIER_TOL, \
        (tres.n_inliers[-1], j_inl[-1])
    assert j_ok[:-1].all()
    assert bool(j_ok[-1]) == (seeds not in LOST_AT_256), j_inl[-1]
