"""Every frontend choice through every driver of the port.

``sampler="anms"``, ``stereo_matcher="orb"``, ``fmat_gate="ransac"`` and
``stereo_gate="fmat"``, each on the 12-frame world of
tests/test_torch_slice.py (small_world(12, seed=5)), with a keyframe
trigger that fires in both lanes.  The port against itself (the JAX
package's counterparts are held in tests/test_torch_frontend.py and
tests/test_torch_match.py); every comparison is bitwise:

- 2 lanes (frames 0-6 and 5-11) through ``run_sequence_batched``: each
  lane equals its single-lane run with the lane's key (poses, stats and
  the keyframe store), and with the ANMS sampler the lanes keep keypoints
  of their own;
- ``StereoOdometry`` and ``StereoSLAM`` frame by frame equal
  ``run_offline``; ``run_offline_slam`` gives run_offline's odometry and
  ``run_offline_slam_batched``'s lanes equal their single-lane runs;
- ``run_online_slam`` (speculative) equals a ``process_chunk`` loop;
- ``slam.corrected_carry`` re-bootstraps with the choice's branch, the
  same twice, at the corrected pose.
"""

import dataclasses

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.config import LoopClosureConfig, PGOConfig, preset_odometry
from ros_stereo_slam_tpu_torch.data.synthetic import small_world
from ros_stereo_slam_tpu_torch.models import (pipeline, slam, slam_chunked, slam_scan, step,
                                              step_batched)
from ros_stereo_slam_tpu_torch.models.vocab import train_batched
from ros_stereo_slam_tpu_torch.ops import orb

# (frontend overrides, keyframe trigger: PnP inliers below it)
CHOICES = {
    "anms": (dict(sampler="anms"), 320),
    "orb": (dict(stereo_matcher="orb", lk_seeded_iters=10, max_points=1152), 150),
    "fmat_gate": (dict(fmat_gate="ransac", grid_step=12, max_points=1024), 150),
    "stereo_gate": (dict(stereo_gate="fmat", grid_step=12, max_points=1024), 150),
}
LOOP = dict(orb_features=128, min_separation=30, db_capacity=32)
CHUNK = 3
N = 7  # frames per lane


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world():
    w = small_world(n_frames=12, seed=5)
    frames = [w.render(i) for i in range(12)]
    L = torch.from_numpy(np.stack([f[0] for f in frames]))
    R = torch.from_numpy(np.stack([f[1] for f in frames]))
    descs = [orb.detect_and_compute(L[i], 128) for i in range(0, 12, 3)]
    voc = train_batched(torch.cat([f.desc_sign[f.valid] for f in descs]), k=4, levels=2,
                        device="cpu")
    return w, L, R, voc


def _cfg(w, choice):
    fe_kw, trigger = CHOICES[choice]
    cfg = preset_odometry()
    return cfg.replace(camera=w.camera, frontend=dataclasses.replace(cfg.frontend, **fe_kw),
                       keyframes=dataclasses.replace(cfg.keyframes, min_pnp_inliers=trigger),
                       loop=LoopClosureConfig(**LOOP),
                       pgo=PGOConfig(max_poses=32, max_loop_edges=4))


def _equal_trees(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("choice", sorted(CHOICES))
def test_lanes_equal_single_lane_runs(world, choice):
    w, L, R, _ = world
    cfg = _cfg(w, choice)
    gp, gm = pipeline._grid_for(cfg, "cpu")
    keys = step_batched.lane_keys(cfg.seed, 2)
    Ls, Rs = torch.stack([L[:N], L[5:5 + N]]), torch.stack([R[:N], R[5:5 + N]])
    c0 = step.init_carry_batched(Ls[:, 0], Rs[:, 0], gp, gm, keys, cfg)
    cb, st = step_batched.run_sequence_batched(Ls[:, 1:], Rs[:, 1:], c0, gp, gm, cfg)
    assert st.tracking_ok.all() and st.is_keyframe.any(0).all(), st.is_keyframe
    if choice == "anms":
        assert not torch.equal(cb.track.pts2d[0], cb.track.pts2d[1])
    for b in range(2):
        c = step.init_carry(Ls[b, 0], Rs[b, 0], gp, gm, keys[b], cfg)
        c, ss = step.run_sequence(Ls[b, 1:], Rs[b, 1:], c, gp, gm, cfg)
        for name, x, y in zip(ss._fields, st, ss):
            assert torch.equal(x[:, b], y), name
        _equal_trees(type(c.track)(*(x[b] for x in cb.track)), c.track)
        _equal_trees(type(c.keyframes)(*(x[b] for x in cb.keyframes)), c.keyframes)


@pytest.mark.parametrize("choice", sorted(CHOICES))
def test_streaming_and_scan_drivers(world, choice):
    w, L, R, voc = world
    cfg = _cfg(w, choice)
    off = pipeline.run_offline(cfg, L[:N], R[:N], device="cpu")
    assert off.tracking_ok.all() and off.is_keyframe.any()
    odo = pipeline.StereoOdometry(cfg, device="cpu")
    sl = slam.StereoSLAM(cfg, voc, device="cpu")
    odo.initialize(L[0], R[0])
    sl.initialize(L[0], R[0])
    for i in range(1, N):
        odo.process_frame(L[i], R[i])
        sl.process_frame(L[i], R[i])
    np.testing.assert_array_equal(odo.trajectory_array(), off.trajectory)
    np.testing.assert_array_equal(sl.trajectory_array(), off.trajectory)
    scan = slam_scan.run_offline_slam(cfg, voc, L[:N], R[:N], device="cpu")
    np.testing.assert_array_equal(scan.trajectory_odo, off.trajectory)
    lanes = slam_scan.run_offline_slam_batched(cfg, voc, torch.stack([L[:N], L[5:5 + N]]),
                                               torch.stack([R[:N], R[5:5 + N]]), device="cpu")
    for b, (start, key) in enumerate(zip((0, 5), step_batched.lane_keys(cfg.seed, 2))):
        one = slam_scan.run_offline_slam(cfg.replace(seed=key), voc, L[start:start + N],
                                         R[start:start + N], device="cpu")
        np.testing.assert_array_equal(lanes[b].trajectory, one.trajectory)
        np.testing.assert_array_equal(lanes[b].is_keyframe, one.is_keyframe)


@pytest.mark.parametrize("choice", sorted(CHOICES))
def test_chunked_speculative_equals_sequential(world, choice):
    w, L, R, voc = world
    cfg = _cfg(w, choice)
    online = slam_chunked.run_online_slam(cfg, voc, L, R, chunk=CHUNK, device="cpu")
    assert online.tracking_ok.all()
    seq = slam_chunked.ChunkedSLAM(cfg, voc, device="cpu")
    seq.initialize(L[0], R[0])
    n_chunks = 0
    for pos in range(1, L.shape[0], CHUNK):
        seq.process_chunk(L[pos:pos + CHUNK], R[pos:pos + CHUNK],
                          query_frames=lambda fid: (L[fid], R[fid]))
        n_chunks += 1
    res = seq.result(n_chunks=n_chunks)
    assert res.n_chunks == online.n_chunks
    np.testing.assert_array_equal(res.trajectory, online.trajectory)
    np.testing.assert_array_equal(res.is_keyframe, online.is_keyframe)
    _equal_trees(res.keyframes, online.keyframes)


@pytest.mark.parametrize("choice", sorted(CHOICES))
def test_corrected_carry_rebootstraps(world, choice):
    w, L, R, _ = world
    cfg = _cfg(w, choice)
    gp, gm = pipeline._grid_for(cfg, "cpu")
    carry = step.init_carry(L[0], R[0], gp, gm, cfg.seed, cfg)
    carry, _ = step.run_sequence(L[1:4], R[1:4], carry, gp, gm, cfg)
    old = torch.eye(4).repeat(8, 1, 1)
    new = old.clone()
    new[:, 0, 3] = 0.25  # every pose moved 25 cm along x
    outs = []
    for _ in range(2):
        kf = type(carry.keyframes)(*(x.clone() for x in carry.keyframes))
        outs.append(slam.corrected_carry(carry._replace(keyframes=kf), new, old, R[3], gp, gm,
                                         cfg))
    a, b = outs
    _equal_trees(a.track, b.track)
    assert torch.equal(a.T_wc, new[3])
    assert int(a.keyframes.count) == int(carry.keyframes.count) + 1
    assert int(a.track.mask.sum()) > 50
    if choice == "anms":
        pts, _ = step._sample_keypoints(L[3][None], None, None, cfg.frontend)
        assert torch.equal(a.track.pts2d, pts[0])
    elif choice == "orb":
        f = orb.detect_and_compute(L[3], cfg.frontend.max_points,
                                   cfg.frontend.fast_thresh / 255.0)
        assert torch.equal(a.track.pts2d, f.pts)
    else:
        assert torch.equal(a.track.pts2d, gp)
