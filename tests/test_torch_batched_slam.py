"""Batched full SLAM (B sequences of odometry + loop detection): the port
against the JAX package, and its lanes against its own single-lane runs.

World and configuration of tests/test_torch_slam_slice.py (80-frame
circular revisit, 128 ORB features at 4 levels, detection every 2nd
frame, a 128-frame database, a k = 4, L = 3 vocabulary trained by the JAX
package); lane 1 is the same trajectory in a second world (seed 14).
The JAX package's fused batched scan is not run (its CPU compile takes
minutes); its per-frame detection step is, vmapped over the lanes as its
batched scan runs it.  Bounds:

- the lane form of ``_lc_scan_step`` against ``jax.vmap`` of the JAX
  step over 10 detection frames: equal top-K ids, scores and ``ns``
  within 1e-5 (L1 norms summed in another order); final databases as in
  tests/test_torch_slam_slice.py (ids and validity equal, weights within
  1e-6, >= 99.9 % of packed descriptor words equal: ORB near-tie bits,
  H8);
- the interleaved cadence's per-lane step (``_lc_scan_step_lane``, lane
  fid % 2 on frame fid) against the JAX package's, jitted with the lane
  static, over frames 0-15: the same bounds as the lane form;
- ``run_offline_slam_batched`` against the single-lane run of each lane
  with the lane's key: equal accepted (query, match) sets, trajectories
  within 1e-4; each lane closes its revisit (query >= 68, match <= 12)
  with post-PGO ATE below the odometry-only ATE and below 0.25 m;
- ``run_offline_slam_batched(interleave=True)``: lane 0 (phase 0) keeps the
  lockstep run's accepted set, trajectories within 1e-4; lane 1 detects on
  odd frames only and closes its revisit at an odd query frame.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import KeyframeConfig as JKeyframe
from ros_stereo_slam_tpu.config import LoopClosureConfig as JLoop
from ros_stereo_slam_tpu.config import PGOConfig as JPGO
from ros_stereo_slam_tpu.config import preset_loop_closure as j_preset
from ros_stereo_slam_tpu.data.synthetic import loop_trajectory, small_world
from ros_stereo_slam_tpu.models import slam_scan as jscan
from ros_stereo_slam_tpu.models import vocab as jvocab
from ros_stereo_slam_tpu.ops import orb as jorb
from ros_stereo_slam_tpu.utils import metrics
from ros_stereo_slam_tpu_torch.config import (
    CameraConfig, FrontendConfig, KeyframeConfig, LoopClosureConfig, PGOConfig,
    preset_loop_closure,
)
from ros_stereo_slam_tpu_torch.models import convert, pipeline, slam_scan, step, step_batched

N_FRAMES = 80
B = 2
LOOP = dict(orb_features=128, dislocal=8, min_separation=30, cooldown=10, max_db_results=12,
            k_consistency=1, geom_min_points=12, db_capacity=128, alpha=0.3, min_nss=0.001)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds_and_vocab():
    poses = loop_trajectory(N_FRAMES, radius=2.5, overlap=8)
    worlds, Ls, Rs = [], [], []
    for seed in (13, 14):
        world = small_world(custom_poses=poses, seed=seed)
        world.half_w = 10.0
        frames = [world.render(i)[:2] for i in range(N_FRAMES)]
        worlds.append(world)
        Ls.append(np.stack([f[0] for f in frames]).astype(np.float32))
        Rs.append(np.stack([f[1] for f in frames]).astype(np.float32))
    L, R = np.stack(Ls), np.stack(Rs)  # (B, F, H, W)
    descs, docs = [], []
    for i in range(0, N_FRAMES, 4):
        f = jorb.detect_and_compute(jnp.asarray(L[0, i]), 128)
        v = np.asarray(f.valid)
        descs.append(np.asarray(f.desc_sign)[v])
        docs.append(np.full(v.sum(), i))
    voc = jvocab.train(np.concatenate(descs), k=4, levels=3, doc_ids=np.concatenate(docs))
    jcfg = j_preset().replace(
        camera=worlds[0].camera, frontend=JFrontend(grid_step=12, max_points=1024),
        keyframes=JKeyframe(max_keyframes=64, min_pnp_inliers=150, map_block_points=1024),
        loop=JLoop(**LOOP), pgo=JPGO(max_poses=128, max_loop_edges=8, iters=10, cg_iters=64))
    tcfg = preset_loop_closure().replace(
        camera=CameraConfig(**vars(worlds[0].camera)),
        frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=64, min_pnp_inliers=150, map_block_points=1024),
        loop=LoopClosureConfig(**LOOP),
        pgo=PGOConfig(max_poses=128, max_loop_edges=8, iters=10, cg_iters=64))
    return worlds, L, R, voc, convert.vocab_from_numpy(voc, "cpu"), jcfg, tcfg


def test_batched_detection_matches_jax_vmap(worlds_and_vocab):
    _, L, _, voc, tvoc, jcfg, tcfg = worlds_and_vocab
    centers, idf = tuple(voc.centers), jnp.asarray(voc.idf)
    step_j = jax.jit(jax.vmap(
        lambda lc1, img, fid: jscan._lc_scan_step(lc1, img, fid, centers, idf, jcfg, voc.k),
        in_axes=(0, 0, None)))
    lcj = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape),
                       jscan.init_lc_state(jcfg, voc.n_words))
    lct = slam_scan.init_lc_state(tcfg, device="cpu", lanes=B)
    n_candidates = 0
    for fid in range(0, 20, tcfg.loop.detect_every):
        lcj, sj = step_j(lcj, jnp.asarray(L[:, fid]), jnp.int32(fid))
        lct, st = slam_scan._lc_scan_step(lct, torch.from_numpy(L[:, fid]), fid, tvoc.packed(),
                                          tvoc.idf, tcfg, tvoc.k)
        sj = jax.device_get(sj)
        assert st.top_ids.shape == (B, slam_scan._top_k_count(tcfg.loop))
        np.testing.assert_array_equal(st.top_ids.numpy(), sj.top_ids, err_msg=f"frame {fid}")
        np.testing.assert_allclose(st.top_scores.numpy(), sj.top_scores, atol=1e-5)
        np.testing.assert_allclose(st.ns.numpy(), sj.ns, atol=1e-5)
        n_candidates += int((st.top_ids >= 0).sum())
    assert n_candidates > 10
    _assert_databases_match(lct, lcj)
    # the lane-stacked JAX database carries across as it is
    j = jax.device_get(lcj)
    back = convert.lc_state_to_numpy(convert.lc_state_from_numpy(j, "cpu"))
    np.testing.assert_array_equal(back.db_bits, np.asarray(j.db_bits))
    assert back.db_ids.shape == (B, tcfg.loop.db_capacity)


def _assert_databases_match(lct, lcj):
    """Final databases: ids and validity equal, weights within 1e-6, >= 99.9 %
    of packed descriptor words equal (ORB near-tie bits, H8)."""
    j = jax.device_get(lcj)
    t = convert.lc_state_to_numpy(lct)
    for name in ("db_words", "db_pt_valid", "db_valid", "db_ids", "last_words", "have_last"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)), name)
    np.testing.assert_allclose(t.db_wvals, np.asarray(j.db_wvals), atol=1e-6)
    assert (t.db_bits == np.asarray(j.db_bits)).mean() >= 0.999


def test_lane_detection_step_matches_jax(worlds_and_vocab):
    """The interleaved cadence's per-lane step: lane fid % 2 detects on
    frame fid (both lanes on frame 0), against the JAX package's
    ``_lc_scan_step_lane`` on the same frames."""
    _, L, _, voc, tvoc, jcfg, tcfg = worlds_and_vocab
    centers, idf = tuple(voc.centers), jnp.asarray(voc.idf)
    step_j = jax.jit(jscan._lc_scan_step_lane, static_argnames=("lane", "cfg", "vocab_k"))
    lcj = jax.tree.map(lambda x: jnp.broadcast_to(x[None], (B,) + x.shape),
                       jscan.init_lc_state(jcfg, voc.n_words))
    lct = slam_scan.init_lc_state(tcfg, voc.n_words, "cpu", lanes=B)
    every = tcfg.loop.detect_every
    n_candidates = 0
    for fid in range(16):
        for b in range(B) if fid == 0 else [fid % every]:  # lane b's phase is b % every
            assert slam_scan.lane_phase(b, every) == jscan.lane_phase(b, every)
            lcj, sj = step_j(lcj, b, jnp.asarray(L[b, fid]), jnp.int32(fid), centers, idf, jcfg,
                             voc.k)
            lct, st = slam_scan._lc_scan_step_lane(lct, b, torch.from_numpy(L[b, fid]), fid,
                                                   tvoc.packed(), tvoc.idf, tcfg, tvoc.k)
            sj = jax.device_get(sj)
            np.testing.assert_array_equal(st.top_ids.numpy(), sj.top_ids, err_msg=f"{fid} {b}")
            np.testing.assert_allclose(st.top_scores.numpy(), sj.top_scores, atol=1e-5)
            np.testing.assert_allclose(st.ns.numpy(), sj.ns, atol=1e-5)
            n_candidates += int((st.top_ids >= 0).sum())
    assert n_candidates > 10
    _assert_databases_match(lct, lcj)
    # each lane's ring holds frame 0 and the frames of its phase
    ids = lct.db_ids.numpy()
    assert set(ids[0][ids[0] >= 0]) == set(range(0, 16, 2))
    assert set(ids[1][ids[1] >= 0]) == {0} | set(range(1, 16, 2))


def _single_lane_slam(cfg, voc, L, R, key):
    """run_offline_slam's steps for one lane, started from `key`."""
    gp, gm = pipeline._grid_for(cfg, "cpu")
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    carry = step.init_carry(Lt[0], Rt[0], gp, gm, key, cfg)
    lc, _ = slam_scan._lc_scan_step(slam_scan.init_lc_state(cfg, voc.n_words, "cpu"), Lt[0], 0,
                                    voc.packed(), voc.idf, cfg, voc.k)
    (carry, lc), (fs, ls) = slam_scan.run_sequence_slam(
        Lt[1:], Rt[1:], carry, lc, gp, gm, voc.packed(), voc.idf, cfg, voc.k)
    return slam_scan._epilogue_one(cfg, lc, *(x.numpy() for x in ls),
                                   step.FrameStats(*(f.numpy() for f in fs)), carry.keyframes,
                                   lambda fid: (Lt[fid], Rt[fid]))


@pytest.fixture(scope="module")
def lockstep_run(worlds_and_vocab):
    """The lockstep batched run and the host reads it made."""
    _, L, R, _, tvoc, _, tcfg = worlds_and_vocab
    reads = step.HOST_READS
    res = slam_scan.run_offline_slam_batched(tcfg, tvoc, L, R, device="cpu")
    return res, step.HOST_READS - reads


def test_batched_slam_lanes_match_single_lane(worlds_and_vocab, lockstep_run):
    worlds, L, R, _, tvoc, _, tcfg = worlds_and_vocab
    res, n_reads = lockstep_run
    assert n_reads == 2 * (N_FRAMES - 1)
    assert len(res) == B
    keys = step_batched.lane_keys(tcfg.seed, B)
    for b, r in enumerate(res):
        single = _single_lane_slam(tcfg, tvoc, L[b], R[b], keys[b])
        assert [(q, m) for q, m, _ in r.loop_events] == \
            [(q, m) for q, m, _ in single.loop_events], b
        np.testing.assert_allclose(r.trajectory_odo, single.trajectory_odo, atol=1e-4)
        np.testing.assert_allclose(r.trajectory, single.trajectory, atol=1e-4)
        np.testing.assert_array_equal(r.is_keyframe, single.is_keyframe)
        assert r.tracking_ok.all()
        assert r.loop_events, f"lane {b} must close its revisit"
        q, m, n_inl = r.loop_events[0]
        assert q >= N_FRAMES - 8 - 4 and m <= 12 and n_inl >= tcfg.loop.geom_min_points
        gt = worlds[b].poses[:N_FRAMES]
        ate = metrics.ate_rmse(r.trajectory, gt)
        ate_odo = metrics.ate_rmse(r.trajectory_odo, gt)
        assert ate < ate_odo and ate < 0.25, (b, ate, ate_odo)


def test_interleaved_lanes(worlds_and_vocab, lockstep_run):
    """``interleave=True``: lane 0 detects on even frames as in lockstep and
    keeps its accepted set; lane 1 detects on odd frames and closes its
    revisit at an odd query frame.  The odometry is the lockstep run's."""
    worlds, L, R, _, tvoc, _, tcfg = worlds_and_vocab
    reads = step.HOST_READS
    res = slam_scan.run_offline_slam_batched(tcfg, tvoc, L, R, device="cpu", interleave=True)
    assert step.HOST_READS - reads == 2 * (N_FRAMES - 1)
    lock = lockstep_run[0]
    assert [(q, m) for q, m, _ in res[0].loop_events] == \
        [(q, m) for q, m, _ in lock[0].loop_events]
    np.testing.assert_allclose(res[0].trajectory, lock[0].trajectory, atol=1e-4)
    for b in range(B):
        np.testing.assert_array_equal(res[b].trajectory_odo, lock[b].trajectory_odo)
        np.testing.assert_array_equal(res[b].is_keyframe, lock[b].is_keyframe)
    assert res[1].loop_events, "lane 1 must close its revisit"
    for q, m, n_inl in res[1].loop_events:
        assert q % 2 == 1 and n_inl >= tcfg.loop.geom_min_points, (q, m)
    q, m, _ = res[1].loop_events[0]
    assert q >= N_FRAMES - 8 - 4 and m <= 12, (q, m)
    gt = worlds[1].poses[:N_FRAMES]
    assert metrics.ate_rmse(res[1].trajectory, gt) < metrics.ate_rmse(res[1].trajectory_odo, gt)


def test_batched_slam_rgb_seqs_colour_lanes(worlds_and_vocab):
    """``rgb_seqs`` (uint8) colours each lane's keyframes from its own RGB
    frames and changes nothing else: keyframe 0 of lane b holds the JAX
    package's bilinear samples of lane b's frame 0 (scaled to [0, 1]) at
    its points, within 1e-6."""
    from ros_stereo_slam_tpu.ops import interp as jinterp

    worlds, L, R, _, tvoc, _, tcfg = worlds_and_vocab
    n = 6
    rgb = np.stack([np.stack([(w.render_rgb(i) * 255 + 0.5).astype(np.uint8) for i in range(n)])
                    for w in worlds])
    gray = slam_scan.run_offline_slam_batched(tcfg, tvoc, L[:, :n], R[:, :n], device="cpu")
    col = slam_scan.run_offline_slam_batched(tcfg, tvoc, L[:, :n], R[:, :n], device="cpu",
                                             rgb_seqs=rgb)
    for b, (g, c) in enumerate(zip(gray, col)):
        np.testing.assert_array_equal(g.trajectory, c.trajectory)
        for name in ("points", "point_mask", "poses", "valid"):
            assert torch.equal(getattr(g.keyframes, name), getattr(c.keyframes, name)), name
        kf = c.keyframes
        m0 = kf.point_mask[0]
        pts = jnp.asarray(pipeline._grid_for(tcfg, "cpu")[0].numpy())
        unit = rgb[b, 0].astype(np.float32) * np.float32(1.0 / 255.0)
        want = np.stack([np.asarray(jinterp.bilinear_at(jnp.asarray(unit[..., c]), pts))
                         for c in range(3)], axis=-1)
        np.testing.assert_allclose(kf.colors[0][m0].numpy(), want[m0.numpy()], rtol=0, atol=1e-6)
        cols = kf.colors[kf.point_mask & kf.valid[:, None]]
        assert (cols[:, 0] - cols[:, 2]).abs().mean() > 0.02, b
