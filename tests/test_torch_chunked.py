"""The chunked online driver (``run_online_slam``, ``ChunkedSLAM``) against
the port's scan posture.

As for the streaming driver, the JAX package's chunked driver runs its
fused scan, which compiles for minutes on a CPU, so the port's is held
against the port's scan posture (whose accept set
``test_torch_slam_slice.py`` holds against the JAX gater).  World,
configuration and vocabulary of ``test_torch_slam_slice.py`` (80 frames,
``max_poses=128``).  Bounds, as the JAX package's
``test_chunked_online_driver`` sets them:

- ``run_online_slam(chunk=16)``: ceil(79 / 16) chunks, at least one
  correction, the scan posture's accepted closures;
- ATE below the odometry-only ATE and below 0.25 m; keyframe poses within
  1e-4 of the live trajectory;
- the speculative run equals a ``process_chunk`` loop bitwise: the
  trajectory and every field of the keyframe store and of the database
  (at chunk=8, where the closure's chunk has a successor, so the run
  rolls back and dispatches that successor again); a speculative
  dispatch leaves the post-state of the chunk before it as it was;
- ``run_sequence_slam(fid_start=k)`` over frames k.. continues a run:
  the same stats, bitwise, as the tail of one run from frame 1.
"""

import math

import numpy as np
import pytest
import torch
from test_torch_slam_slice import N_FRAMES, _one_torch_thread, world_and_vocab  # noqa: F401

from ros_stereo_slam_tpu.utils import metrics
from ros_stereo_slam_tpu_torch.models import convert, slam_chunked, slam_scan, step
from ros_stereo_slam_tpu_torch.models.pipeline import _grid_for

CHUNK = 16
CHUNK_ROLLBACK = 8


@pytest.fixture(scope="module")
def runs(world_and_vocab):
    """The scan posture and run_online_slam."""
    _, L, R, voc, _, tcfg = world_and_vocab
    tvoc = convert.vocab_from_numpy(voc, "cpu")
    scan = slam_scan.run_offline_slam(tcfg, tvoc, L, R, device="cpu")
    online = slam_chunked.run_online_slam(tcfg, tvoc, L, R, chunk=CHUNK, device="cpu")
    return tvoc, scan, online


def _online_with_its_driver(tcfg, tvoc, L, R, chunk):
    """run_online_slam, and the ChunkedSLAM it made."""
    made = []

    class Recorded(slam_chunked.ChunkedSLAM):
        def __post_init__(self):
            super().__post_init__()
            made.append(self)

    mp = pytest.MonkeyPatch()
    mp.setattr(slam_chunked, "ChunkedSLAM", Recorded)
    try:
        online = slam_chunked.run_online_slam(tcfg, tvoc, L, R, chunk=chunk, device="cpu")
    finally:
        mp.undo()
    return online, made[0]


def test_online_closes_the_scan_set(runs):
    _, scan, online = runs
    assert online.n_chunks == math.ceil((N_FRAMES - 1) / CHUNK)
    assert online.n_corrections >= 1
    assert online.tracking_ok.all() and online.trajectory.shape == (N_FRAMES, 4, 4)
    assert [(q, m) for q, m, _ in online.loop_events] == [(q, m) for q, m, _ in scan.loop_events]


def test_online_accuracy_and_live_map(runs, world_and_vocab):
    world = world_and_vocab[0]
    _, scan, online = runs
    gt = world.poses[:N_FRAMES]
    ate = metrics.ate_rmse(online.trajectory, gt)
    ate_odo = metrics.ate_rmse(scan.trajectory_odo, gt)
    assert ate < ate_odo and ate < 0.25, (ate, ate_odo)
    kf = online.keyframes
    valid = kf.valid.numpy()
    np.testing.assert_allclose(kf.poses.numpy()[valid],
                               online.trajectory[kf.frame_idx.numpy()[valid]], atol=1e-4)


def test_speculative_equals_sequential(runs, world_and_vocab):
    _, L, R, _, _, tcfg = world_and_vocab
    tvoc = runs[0]
    chunk = CHUNK_ROLLBACK
    online, spec = _online_with_its_driver(tcfg, tvoc, L, R, chunk)
    assert online.n_corrections >= 1
    assert any((q - 1) // chunk < online.n_chunks - 1 for q, _, _ in online.loop_events)
    seq = slam_chunked.ChunkedSLAM(tcfg, tvoc, device="cpu")
    seq.initialize(L[0], R[0])
    n_chunks = 0
    for pos in range(1, N_FRAMES, chunk):
        seq.process_chunk(L[pos:pos + chunk], R[pos:pos + chunk],
                          query_frames=lambda fid: (torch.from_numpy(L[fid]),
                                                    torch.from_numpy(R[fid])))
        n_chunks += 1
    res = seq.result(n_chunks=n_chunks)
    assert res.loop_events == online.loop_events
    assert res.n_corrections == online.n_corrections
    np.testing.assert_array_equal(res.trajectory, online.trajectory)
    for name, a, b in zip(res.keyframes._fields, res.keyframes, online.keyframes):
        assert torch.equal(a, b), name
    for name, a, b in zip(slam_scan.LCScanState._fields, seq._lc, spec._lc):
        assert torch.equal(a, b), name


def test_speculative_dispatch_leaves_the_pending_state(world_and_vocab):
    """Chunk 2 begun before chunk 1 is gated writes its keyframes and
    database rows into copies: chunk 1's post-state, which a correction
    would roll back to, keeps every value."""
    _, L, R, voc, _, tcfg = world_and_vocab
    c = slam_chunked.ChunkedSLAM(tcfg, convert.vocab_from_numpy(voc, "cpu"), device="cpu")
    c.initialize(L[0], R[0])
    first = c.begin_chunk(L[1:9], R[1:9])
    kept = [t.clone() for t in first.carry_after.keyframes + first.lc_after]
    second = c.begin_chunk(L[9:17], R[9:17])
    assert not torch.equal(second.lc_after.db_valid, first.lc_after.db_valid)
    for a, b in zip(first.carry_after.keyframes + first.lc_after, kept):
        assert torch.equal(a, b)


def test_fid_start_continues_a_run(world_and_vocab):
    _, L, R, voc, _, tcfg = world_and_vocab
    tvoc = convert.vocab_from_numpy(voc, "cpu")
    tree, idf = tvoc.packed(), tvoc.idf
    gp, gm = _grid_for(tcfg, "cpu")
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    end, k = 25, 13  # k odd: the tail starts on a frame that does not detect

    def start():
        carry = step.init_carry(Lt[0], Rt[0], gp, gm, tcfg.seed, tcfg)
        lc, _ = slam_scan._lc_scan_step(slam_scan.init_lc_state(tcfg, device="cpu"), Lt[0], 0, tree,
                                        idf, tcfg, tvoc.k)
        return carry, lc

    def run(carry, lc, lo, hi):
        return slam_scan.run_sequence_slam(Lt[lo:hi], Rt[lo:hi], carry, lc, gp, gm, tree, idf,
                                           tcfg, tvoc.k, fid_start=lo)

    (_, lc_one), (fs_one, ls_one) = run(*start(), 1, end)
    state, _ = run(*start(), 1, k)
    (_, lc_two), (fs_two, ls_two) = run(*state, k, end)
    for one, two in ((fs_one, fs_two), (ls_one, ls_two)):
        for name, a, b in zip(one._fields, one, two):
            assert torch.equal(a[k - 1:], b), name
    assert (ls_two.ns >= 0).sum() == (end - k) // 2  # the cadence kept its phase
    for name, a, b in zip(slam_scan.LCScanState._fields, lc_one, lc_two):
        assert torch.equal(a, b), name
