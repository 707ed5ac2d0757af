"""Full SLAM with loop closure end to end: the port against the JAX package.

World and configuration of tests/test_slam_scan.py (80-frame circular
revisit, 128 ORB features at 4 levels, detection every 2nd frame, a
128-frame database, a k = 4, L = 3 vocabulary trained by the JAX package
and carried across with ``convert.vocab_from_numpy``).  The JAX package's
fused whole-sequence scan is not run here (its CPU compile takes minutes,
so its own test is marked slow); its per-frame detection step and its
epilogue gater are.

Bounds:

- per-frame detection (``_lc_scan_step``) on every detection frame: the
  same top-K database ids, scores within 1e-5 and the same ns within
  1e-5 (the L1 norms are summed in another order); the final databases:
  word ids, validity and frame ids equal, weights within 1e-6, points
  within 1e-4 px, >= 99.9 % of packed descriptor words equal (ORB bits
  may flip at near-ties at the coarse levels, ROADMAP H8);
- the accepted (query, match) set from the port's stats and gater equals
  the one the JAX gater accepts from the JAX stats (each with its own
  pair-keyed RANSAC draws);
- ``run_offline_slam`` of the port: every frame tracked, the revisit
  closed (query >= 68, match <= 12, as the JAX test requires), post-PGO
  ATE below the odometry-only ATE and below 0.25 m, and the keyframe map
  following the optimized trajectory.
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
from ros_stereo_slam_tpu_torch.models import convert, slam_scan

N_FRAMES = 80
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
def world_and_vocab():
    poses = loop_trajectory(N_FRAMES, radius=2.5, overlap=8)
    world = small_world(custom_poses=poses, seed=13)
    world.half_w = 10.0
    frames = [world.render(i)[:2] for i in range(N_FRAMES)]
    L = np.stack([f[0] for f in frames]).astype(np.float32)
    R = np.stack([f[1] for f in frames]).astype(np.float32)
    descs, docs = [], []
    for i in range(0, N_FRAMES, 4):
        f = jorb.detect_and_compute(jnp.asarray(L[i]), 128)
        v = np.asarray(f.valid)
        descs.append(np.asarray(f.desc_sign)[v])
        docs.append(np.full(v.sum(), i))
    voc = jvocab.train(np.concatenate(descs), k=4, levels=3, doc_ids=np.concatenate(docs))
    jcfg = j_preset().replace(
        camera=world.camera, frontend=JFrontend(grid_step=12, max_points=1024),
        keyframes=JKeyframe(max_keyframes=64, min_pnp_inliers=150, map_block_points=1024),
        loop=JLoop(**LOOP), pgo=JPGO(max_poses=128, max_loop_edges=8, iters=10, cg_iters=64))
    tcfg = preset_loop_closure().replace(
        camera=CameraConfig(**vars(world.camera)),
        frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=64, min_pnp_inliers=150, map_block_points=1024),
        loop=LoopClosureConfig(**LOOP),
        pgo=PGOConfig(max_poses=128, max_loop_edges=8, iters=10, cg_iters=64))
    return world, L, R, voc, jcfg, tcfg


@pytest.fixture(scope="module")
def detection(world_and_vocab):
    """Both packages' detection over every detection frame, in lockstep."""
    world, L, R, voc, jcfg, tcfg = world_and_vocab
    tvoc = convert.vocab_from_numpy(voc, "cpu")
    lcj = jscan.init_lc_state(jcfg, voc.n_words)
    lct = slam_scan.init_lc_state(tcfg, device="cpu")
    centers, idf = tuple(voc.centers), jnp.asarray(voc.idf)
    K = slam_scan._top_k_count(tcfg.loop)
    rows = {name: (np.full((N_FRAMES - 1, K), -1, np.int32),
                   np.full((N_FRAMES - 1, K), -1e9, np.float32),
                   np.full((N_FRAMES - 1,), -1.0, np.float32)) for name in ("jax", "port")}
    per_frame = []
    mid_state = None
    for fid in range(0, N_FRAMES, tcfg.loop.detect_every):
        lcj, sj = jscan._lc_scan_step_jit(lcj, jnp.asarray(L[fid]), jnp.int32(fid), centers,
                                          idf, jcfg, voc.k)
        lct, st = slam_scan._lc_scan_step(lct, torch.from_numpy(L[fid]), fid, tvoc.packed(),
                                          tvoc.idf, tcfg, tvoc.k)
        sj = jax.device_get(sj)
        st = tuple(x.numpy() for x in st)
        per_frame.append((fid, sj, st))
        if fid >= 1:
            for name, s in (("jax", (sj.top_ids, sj.top_scores, sj.ns)), ("port", st)):
                for arr, val in zip(rows[name], s):
                    arr[fid - 1] = val
        if fid == 40:
            mid_state = jax.device_get(lcj)
    return tvoc, lcj, lct, per_frame, rows, mid_state


def test_detection_frame_by_frame(detection):
    *_, per_frame, _, _ = detection
    assert len(per_frame) == N_FRAMES // 2
    n_candidates = 0
    for fid, sj, (ids, scores, ns) in per_frame:
        np.testing.assert_array_equal(ids, sj.top_ids, err_msg=f"frame {fid}")
        np.testing.assert_allclose(scores, sj.top_scores, atol=1e-5, err_msg=f"frame {fid}")
        assert abs(float(ns) - float(sj.ns)) < 1e-5, (fid, ns, sj.ns)
        n_candidates += int((ids >= 0).sum())
    assert n_candidates > 100


def test_database_state_matches(detection):
    _, lcj, lct, *_ = detection
    j = jax.device_get(lcj)
    t = convert.lc_state_to_numpy(lct)
    for name in ("db_words", "db_pt_valid", "db_valid", "db_ids", "last_words", "have_last"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)), name)
    np.testing.assert_allclose(t.db_wvals, np.asarray(j.db_wvals), atol=1e-6)
    np.testing.assert_allclose(t.last_wvals, np.asarray(j.last_wvals), atol=1e-6)
    np.testing.assert_allclose(t.db_bins, np.asarray(j.db_bins).astype(np.float32), atol=1e-6)
    np.testing.assert_allclose(t.db_pts, np.asarray(j.db_pts), atol=1e-4)
    assert (t.db_bits == np.asarray(j.db_bits)).mean() >= 0.999


def test_state_carried_across_continues_identically(detection, world_and_vocab):
    """JAX's database after frame 40, converted into the port: both
    packages then answer frame 42 the same way, and the conversion
    round-trips."""
    _, L, _, voc, jcfg, tcfg = world_and_vocab
    tvoc, *_, mid = detection
    lct = convert.lc_state_from_numpy(mid, "cpu")
    back = convert.lc_state_to_numpy(lct)
    for name in slam_scan.LCScanState._fields:
        np.testing.assert_array_equal(getattr(back, name),
                                      np.asarray(getattr(mid, name)).astype(
                                          getattr(back, name).dtype), name)
    _, sj = jscan._lc_scan_step_jit(jax.device_put(mid), jnp.asarray(L[42]), jnp.int32(42),
                                    tuple(voc.centers), jnp.asarray(voc.idf), jcfg, voc.k)
    _, st = slam_scan._lc_scan_step(lct, torch.from_numpy(L[42]), 42, tvoc.packed(), tvoc.idf,
                                    tcfg, tvoc.k)
    np.testing.assert_array_equal(st.top_ids.numpy(), np.asarray(sj.top_ids))
    np.testing.assert_allclose(st.top_scores.numpy(), np.asarray(sj.top_scores), atol=1e-5)


def test_accepted_set_matches_jax_gater(detection, world_and_vocab):
    _, _, _, _, jcfg, tcfg = world_and_vocab
    _, lcj, lct, _, rows, _ = detection
    acc_j = jscan.EpilogueGater(jcfg).process(lcj, *rows["jax"], fid_start=1)
    acc_t = slam_scan.EpilogueGater(tcfg).process(lct, *rows["port"], fid_start=1)
    assert [(a[0], a[1]) for a in acc_t] == [(a[0], a[1]) for a in acc_j]
    assert acc_t, "the revisit must be accepted"
    for a_t, a_j in zip(acc_t, acc_j):
        assert abs(a_t[4] - a_j[4]) <= 0.1 * a_j[4], (a_t[4], a_j[4])


def test_run_offline_slam_end_to_end(world_and_vocab, detection):
    world, L, R, _, _, tcfg = world_and_vocab
    tvoc = detection[0]
    res = slam_scan.run_offline_slam(tcfg, tvoc, L, R, device="cpu")
    assert res.trajectory.shape == res.trajectory_odo.shape == (N_FRAMES, 4, 4)
    assert res.tracking_ok.all()
    assert res.loop_events, "the revisit must close a loop"
    q, m, n_inl = res.loop_events[0]
    assert q >= N_FRAMES - 8 - 4 and m <= 12 and n_inl >= tcfg.loop.geom_min_points
    gt = world.poses[:N_FRAMES]
    ate = metrics.ate_rmse(res.trajectory, gt)
    ate_odo = metrics.ate_rmse(res.trajectory_odo, gt)
    assert ate < ate_odo and ate < 0.25, (ate, ate_odo)
    kf = res.keyframes
    valid = kf.valid.numpy()
    fidx = kf.frame_idx.numpy()[valid]
    np.testing.assert_allclose(kf.poses.numpy()[valid], res.trajectory[fidx], atol=1e-5)
    assert kf.retrack.numpy()[valid].all()
