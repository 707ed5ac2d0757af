"""The streaming driver (``StereoSLAM``) against the port's scan posture.

The JAX package's ``StereoSLAM`` runs its fused step, which compiles for
minutes on a CPU (its own tests are marked slow), so the port's streaming
driver is held against the port's scan posture, whose accept set
``test_torch_slam_slice.py`` holds against the JAX gater.  World,
configuration and vocabulary of ``test_torch_slam_slice.py`` (80 frames,
``max_poses=128``).  Bounds:

- every frame tracked, the revisit closed (query >= 68, match <= 12);
- the accepted closures, with their inlier counts, equal
  ``run_offline_slam``'s (both verify with the pair's generator on the
  same database rows);
- trajectory within 0.30 m of the scan posture's and the clouds of the
  keyframes both keep within 0.30 m (median per keyframe), the bounds of
  the JAX package's ``test_scan_map_matches_streaming_map``;
- a checkpoint after frame 40, resumed in a fresh object, gives the
  uninterrupted run's trajectory, events, keyframe store and database
  bitwise;
- ``save_graph``/``save_map`` write files that ``PoseGraph.load`` and
  ``ply.load_ply`` read back with the run's counts;
- uint8 frames are cast, not scaled (ROADMAP F2).
"""

import numpy as np
import pytest
import torch
from test_torch_slam_slice import N_FRAMES, _one_torch_thread, world_and_vocab  # noqa: F401

from ros_stereo_slam_tpu_torch.models import convert, slam, slam_scan
from ros_stereo_slam_tpu_torch.models.pose_graph import PoseGraph
from ros_stereo_slam_tpu_torch.utils import ply

CKPT_FRAME = 40


@pytest.fixture(scope="module")
def runs(world_and_vocab, tmp_path_factory):
    """The scan posture, and the streaming driver with a checkpoint saved
    after frame CKPT_FRAME."""
    _, L, R, voc, _, tcfg = world_and_vocab
    tvoc = convert.vocab_from_numpy(voc, "cpu")
    scan = slam_scan.run_offline_slam(tcfg, tvoc, L, R, device="cpu")
    ckpt = str(tmp_path_factory.mktemp("ckpt") / "slam.npz")
    stream = slam.StereoSLAM(tcfg, tvoc, device="cpu")
    stream.initialize(L[0], R[0])
    for i in range(1, N_FRAMES):
        stream.process_frame(L[i], R[i])
        if i == CKPT_FRAME:
            stream.save_checkpoint(ckpt)
    return tvoc, scan, stream, ckpt


def test_streaming_tracks_and_closes(runs, world_and_vocab):
    tcfg = world_and_vocab[-1]
    _, _, stream, _ = runs
    assert stream.frame_count == N_FRAMES and not stream.tracking_failed
    assert stream.loop_events, "the revisit must close a loop"
    e = stream.loop_events[0]
    assert e.query >= N_FRAMES - 12 and e.match <= 12
    assert e.n_inliers >= tcfg.loop.geom_min_points
    assert set(e.query for e in stream.loop_events) <= set(stream.keyframe_frames)


def test_streaming_accepts_the_scan_set(runs):
    _, scan, stream, _ = runs
    assert [(e.query, e.match, e.n_inliers) for e in stream.loop_events] == [
        tuple(int(x) for x in ev) for ev in scan.loop_events]


def test_streaming_trajectory_and_map_match_scan(runs):
    _, scan, stream, _ = runs
    traj = stream.trajectory_array()
    assert traj.shape == scan.trajectory.shape == (N_FRAMES, 4, 4)
    dt = np.linalg.norm(traj[:, :3, 3] - scan.trajectory[:, :3, 3], axis=-1)
    assert float(dt.max()) < 0.30, dt.max()
    kf_a, kf_b = scan.keyframes, stream.keyframes
    fa = {int(f): k for k, f in enumerate(kf_a.frame_idx.tolist()) if kf_a.valid[k]}
    fb = {int(f): k for k, f in enumerate(kf_b.frame_idx.tolist()) if kf_b.valid[k]}
    common = sorted(set(fa) & set(fb))
    assert len(common) >= 3
    worst = 0.0
    for f in common:
        m = kf_a.point_mask[fa[f]] & kf_b.point_mask[fb[f]]
        if m.any():
            d = torch.linalg.vector_norm(kf_a.points[fa[f]][m] - kf_b.points[fb[f]][m], dim=-1)
            worst = max(worst, float(d.median()))
    assert worst < 0.30, worst
    # the live map follows the corrected trajectory
    valid = kf_b.valid.numpy()
    np.testing.assert_allclose(kf_b.poses.numpy()[valid],
                               traj[kf_b.frame_idx.numpy()[valid]], atol=1e-5)


def test_resume_from_checkpoint_equals_uninterrupted(runs, world_and_vocab):
    _, L, R, _, _, tcfg = world_and_vocab
    tvoc, _, stream, ckpt = runs
    resumed = slam.StereoSLAM(tcfg, tvoc, device="cpu")
    resumed.initialize(L[0], R[0])
    resumed.load_checkpoint(ckpt)
    assert resumed.frame_count == CKPT_FRAME + 1
    for i in range(CKPT_FRAME + 1, N_FRAMES):
        resumed.process_frame(L[i], R[i])
    np.testing.assert_array_equal(resumed.trajectory_array(), stream.trajectory_array())
    assert resumed.loop_events == stream.loop_events
    assert resumed.keyframe_frames == stream.keyframe_frames
    for name, a, b in zip(resumed.keyframes._fields, resumed.keyframes, stream.keyframes):
        assert torch.equal(a, b), name
    for name, a, b in zip(slam_scan.LCScanState._fields, resumed.detector.lc, stream.detector.lc):
        assert torch.equal(a, b), name
    assert (resumed.graph.count, resumed.graph.n_loops) == (stream.graph.count,
                                                            stream.graph.n_loops)


def test_graph_and_map_files_read_back(runs, world_and_vocab, tmp_path):
    tcfg = world_and_vocab[-1]
    _, _, stream, _ = runs
    stream.save_graph(str(tmp_path / "pose_graph.g2o"))
    g, poses = PoseGraph.load(str(tmp_path / "pose_graph.g2o"), tcfg.pgo, device="cpu")
    assert (g.count, g.n_loops) == (N_FRAMES, len(stream.loop_events))
    np.testing.assert_allclose(poses[:N_FRAMES], stream.trajectory_array(), atol=1e-5)
    n = stream.save_map(str(tmp_path / "map.ply"))
    pts, cols = ply.load_ply(str(tmp_path / "map.ply"))
    want, _ = stream.map_points()
    assert n == len(pts) == len(want) > 0 and cols is not None
    np.testing.assert_array_equal(pts, want)


def test_uint8_frames_are_cast_not_scaled(world_and_vocab):
    """F2: the driver casts frames to float32 as the JAX package's does, so
    uint8 input reaches the step as 0..255, as float32 0..255 does."""
    _, L, R, _, _, tcfg = world_and_vocab
    L8 = np.clip(L[:3] * 255.0, 0, 255).astype(np.uint8)
    R8 = np.clip(R[:3] * 255.0, 0, 255).astype(np.uint8)
    trajs = []
    for cast in (lambda x: x, lambda x: x.astype(np.float32)):
        s = slam.StereoSLAM(tcfg, device="cpu")
        s.initialize(cast(L8[0]), cast(R8[0]))
        for i in (1, 2):
            s.process_frame(cast(L8[i]), cast(R8[i]))
        assert float(s._carry.ref_pyr[0].max()) > 1.0  # not scaled to [0, 1]
        trajs.append(s.trajectory_array())
    np.testing.assert_array_equal(trajs[0], trajs[1])
