"""The frozen renderer gives the port's frames and chip_smoke.py's plan."""

import numpy as np
import pytest
import torch

from slambench import world
from slambench.tests.conftest import SMALL_CAMERA


def _cam():
    from ros_stereo_slam_tpu_torch.config import CameraConfig

    return CameraConfig(**{k: v for k, v in SMALL_CAMERA.items() if k != "rate_hz"})


def _u8(x):
    return np.floor(np.clip(x, 0, 1) * 255.0 + 0.5).astype(np.uint8)


@pytest.mark.parametrize("frame", [0, 7, 12])
def test_corridor_frames_are_the_ports(frame):
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    w = {"recipe": "corridor", "frames": 13, "speed_m": 0.8, "yaw_rate": 0.004,
         "half_w": 18.0, "end_z": 260.0}
    ours = world.corridor_frames(w, 11, SMALL_CAMERA, "cpu")
    theirs = SyntheticWorld(camera=_cam(), n_frames=13, seed=11, half_w=18.0)
    left, right, _ = theirs.render(frame)
    np.testing.assert_allclose(ours.gt, theirs.poses)
    for got, want in ((ours.left[frame], left), (ours.right[frame], right)):
        d = np.abs(got.numpy().astype(int) - _u8(want).astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_revisit_plan_is_chip_smokes():
    import chip_smoke

    w = {"recipe": "revisit", "frames": 256, "lap": 128, "step_m": 0.8, "jitter_trans_m": 0.1,
         "jitter_rot_deg": 1.0, "brightness": [0.85, 1.15], "noise_sigma": 0.02}
    laps = world.revisit_plan(w, 17)
    jobs, post, gt = chip_smoke._revisit_plan(257, (8, 8), 17, 11)
    poses = np.concatenate([p for p, _ in laps])
    np.testing.assert_array_equal(poses, gt[:256])
    ours = [pp for _, pps in laps for pp in pps]
    for a, b in zip(ours, post[:256]):
        assert (a is None) == (b is None)
        if a is not None:
            assert a == (b[0], 0.02)
    r = 128 * 0.8 / (2 * np.pi)
    assert jobs[0][0]["half_w"] == max(3.0 * r, 18.0) and jobs[0][0]["end_z"] == max(6.0 * r, 260.0)


def test_revisit_lap_renders_as_the_ports_world():
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    base = world.lap_poses(128, 0.8)
    r = 128 * 0.8 / (2 * np.pi)
    scene = world.Scene(11, max(3.0 * r, 18.0), max(6.0 * r, 260.0), "cpu")
    theirs = SyntheticWorld(camera=_cam(), n_frames=128, seed=11, custom_poses=base,
                            half_w=max(3.0 * r, 18.0), end_z=max(6.0 * r, 260.0))
    got = scene.views(base[[3, 90]], SMALL_CAMERA).numpy()
    for j, f in enumerate((3, 90)):
        want = theirs.render(f)[0]
        assert np.abs(got[j] - want).max() < 1e-5


def test_the_seed_draws_the_scene_the_plan_and_the_noise():
    w = {"recipe": "revisit", "frames": 6, "lap": 4, "step_m": 0.8, "jitter_trans_m": 0.1,
         "jitter_rot_deg": 1.0, "brightness": [0.85, 1.15], "noise_sigma": 0.02}
    seeds = world.draw(2**40 + 5)
    assert set(seeds) == set(world.SEEDS) and len(set(seeds.values())) == len(seeds)
    assert seeds == world.draw(2**40 + 5) and seeds != world.draw(2**40 + 6)
    a = world.make_frames(w, SMALL_CAMERA, "cpu", seeds)
    b = world.make_frames(w, SMALL_CAMERA, "cpu", dict(seeds))
    assert torch.equal(a.left, b.left) and torch.equal(a.right, b.right)
    assert a.left.dtype == torch.uint8 and a.left.shape == (6, 160, 416)
    noise = world.make_frames(w, SMALL_CAMERA, "cpu", dict(seeds, noise=seeds["noise"] + 1))
    assert torch.equal(a.left[:4], noise.left[:4])  # lap 1: no noise, the same scene
    assert not torch.equal(a.left[4:], noise.left[4:])  # lap 2: another noise field
    plan = world.make_frames(w, SMALL_CAMERA, "cpu", dict(seeds, plan=seeds["plan"] + 1))
    np.testing.assert_array_equal(a.gt[:4], plan.gt[:4])  # lap 1 is the plain lap
    assert not np.array_equal(a.gt[4:], plan.gt[4:])  # lap 2's jitter
    scene = world.make_frames(w, SMALL_CAMERA, "cpu", dict(seeds, scene=seeds["scene"] + 1))
    np.testing.assert_array_equal(a.gt, scene.gt)
    assert not torch.equal(a.left[:4], scene.left[:4])  # other textures
