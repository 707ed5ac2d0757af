"""Loop-closure verification, the gates and the pose graph of the port
against the JAX package.

Same seeded numpy inputs through both packages on the CPU.  Bounds:

- ``fmat_ransac`` and ``_geom_match`` with index sets drawn by JAX (its
  pair key ``geom_key``; torch cannot reproduce JAX's random streams,
  ROADMAP H1): the ratio matches, the inlier sets and the measurement
  masks are equal; Sampson errors within 1e-3 px^2 + 1e-3 relative, F
  (unit Frobenius norm, sign fixed) within 1e-3.
- ``CandidateGater`` and ``EpilogueGater`` on the same per-frame stats
  (geometry stubbed the same way in both): equal decisions and accepted
  sets.
- ``pose_graph.optimize`` on the same drifted loop graph: positions within
  2 mm and rotations within 1e-3 of JAX's (CG in f32, sums in another
  order); ``chain_measurements`` within 1e-5, ``rewrite_points`` within
  1e-4 (clouds of ~5 m);
  ``spd_inverse_small`` within 1e-4 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import LoopClosureConfig as JLoop
from ros_stereo_slam_tpu.config import PipelineConfig as JPipeline
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import loop_closure as jlc
from ros_stereo_slam_tpu.models import pose_graph as jpg
from ros_stereo_slam_tpu.models import slam_scan as jscan
from ros_stereo_slam_tpu.ops import linalg as jlinalg
from ros_stereo_slam_tpu.ops import orb as jorb
from ros_stereo_slam_tpu.ops import ransac as jransac
from ros_stereo_slam_tpu.utils import lie as jlie
from ros_stereo_slam_tpu_torch.config import LoopClosureConfig, PipelineConfig
from ros_stereo_slam_tpu_torch.models import loop_closure as lc
from ros_stereo_slam_tpu_torch.models import pose_graph as pg
from ros_stereo_slam_tpu_torch.models import slam_scan
from ros_stereo_slam_tpu_torch.ops import linalg, ransac


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit_F(F):
    F = np.asarray(F, np.float64)
    F = F / np.linalg.norm(F)
    return F * np.sign(F.flat[np.argmax(np.abs(F))])


def _two_view(seed=0, n=160, outliers=0.3):
    """Projections of random 3D points into two cameras, with outliers."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-4, -2, 6], [4, 2, 20], (n, 3))
    ang = 0.08
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t = np.array([0.6, 0.05, 0.2])

    def proj(P):
        return np.stack([500 * P[:, 0] / P[:, 2] + 320, 500 * P[:, 1] / P[:, 2] + 240], 1)

    p1 = proj(X) + rng.normal(0, 0.3, (n, 2))
    p2 = proj(X @ R.T + t) + rng.normal(0, 0.3, (n, 2))
    bad = rng.random(n) < outliers
    p2[bad] += rng.uniform(-60, 60, (bad.sum(), 2))
    mask = rng.random(n) > 0.05
    return p1.astype(np.float32), p2.astype(np.float32), mask


@pytest.mark.parametrize("seed,thresh", [(0, 1.0), (1, 2.0)])
def test_fmat_ransac_equal_inliers_with_jax_sets(seed, thresh):
    p1, p2, mask = _two_view(seed)
    key = jax.random.PRNGKey(seed + 10)
    rj = jransac.fmat_ransac(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                             thresh_px=thresh, iters=128)
    idx = np.array(jransac._sample_minimal_sets(key, jnp.asarray(mask), 128, 8))
    rt = ransac._fmat_from_sets(torch.from_numpy(idx), torch.from_numpy(p1),
                                torch.from_numpy(p2), torch.from_numpy(mask), thresh)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    assert int(rt.n_inliers) == int(rj.n_inliers) > 60
    np.testing.assert_allclose(rt.errors.numpy(), np.asarray(rj.errors), atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(_unit_F(rt.F.numpy()), _unit_F(rj.F), atol=1e-3)
    # the port's own draws find the same model on clean data
    own = ransac.fmat_ransac(torch.Generator().manual_seed(0), torch.from_numpy(p1),
                             torch.from_numpy(p2), torch.from_numpy(mask), thresh, 128)
    assert abs(int(own.n_inliers) - int(rj.n_inliers)) <= 0.1 * int(rj.n_inliers)


def test_fmat_helpers_match_reference():
    rng = np.random.default_rng(4)
    F = rng.normal(size=(5, 3, 3)).astype(np.float32)
    np.testing.assert_allclose(ransac._rank2(torch.from_numpy(F)).numpy(),
                               np.asarray(jax.vmap(jransac._rank2)(jnp.asarray(F))), atol=1e-5)
    p1h = np.concatenate([rng.uniform(0, 600, (40, 2)), np.ones((40, 1))], 1).astype(np.float32)
    p2h = np.concatenate([rng.uniform(0, 600, (40, 2)), np.ones((40, 1))], 1).astype(np.float32)
    np.testing.assert_allclose(
        ransac.sampson_distance(torch.from_numpy(F), torch.from_numpy(p1h),
                                torch.from_numpy(p2h)).numpy(),
        np.asarray(jransac.sampson_distance(jnp.asarray(F), jnp.asarray(p1h),
                                            jnp.asarray(p2h))), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def feature_pair():
    """ORB features (JAX jnp route) of two frames of the small world."""
    world = small_world(n_frames=4, seed=5)
    out = []
    for i in (0, 1):
        f = jorb.detect_and_compute(jnp.asarray(world.render(i)[0]), 128, backend="jnp")
        out.append(tuple(np.asarray(x) for x in (f.desc_bits, f.pts, f.valid)))
    return out


def test_geom_match_equal_with_jax_sets(feature_pair):
    (bq, pq, vq), (bm, pm, vm) = feature_pair
    q_fid, m_fid, thresh, ratio, iters = 130, 12, 2.0, 0.6, 256
    key = jlc.geom_key(q_fid, m_fid)
    n_j, best_j, meas_j = jlc._geom_match(
        jnp.asarray(bq), jnp.asarray(pq), jnp.asarray(vq), jnp.asarray(bm), jnp.asarray(pm),
        jnp.asarray(vm), key, jnp.float32(thresh), jnp.float32(ratio), iters=iters)
    # The JAX check's own ratio gate, to draw its index sets.
    ham = jorb.hamming_mxu(jorb.sign_of_packed(jnp.asarray(bq)),
                           jorb.sign_of_packed(jnp.asarray(bm)))
    ham = jnp.where(jnp.asarray(vm)[None, :], ham, 1e9)
    neg2, _ = jax.lax.top_k(-ham, 2)
    d1, d2 = -neg2[:, 0], -neg2[:, 1]
    good_j = jnp.asarray(vq) & (d1 < jnp.float32(ratio) * d2) & (d1 < 1e8)
    idx = np.array(jransac._sample_minimal_sets(key, good_j, iters, 8))

    t = [torch.from_numpy(np.array(a)) for a in (bq.view(np.int32), pq, vq,
                                                 bm.view(np.int32), pm, vm)]
    best, good, loose = lc._ratio_matches(t[0], t[2], t[3], t[5], ratio)
    np.testing.assert_array_equal(best.numpy(), np.asarray(best_j))
    np.testing.assert_array_equal(good.numpy(), np.asarray(good_j))
    n_t, meas_t = lc._geom_from_sets(torch.from_numpy(idx), t[1], t[4][best], good, loose,
                                     thresh)
    assert int(n_t) == int(n_j) >= 12
    np.testing.assert_array_equal(meas_t.numpy(), np.asarray(meas_j))
    # the whole check with the port's own pair generator: same verdict
    n_own, best_own, _ = lc._geom_match(*t[:3], *t[3:], lc.geom_key(q_fid, m_fid, "cpu"),
                                        thresh, ratio, iters)
    assert torch.equal(best_own, best)
    assert abs(int(n_own) - int(n_j)) <= 0.1 * int(n_j)


def test_pair_keys_are_pure_functions_of_the_pair():
    a = torch.rand(4, generator=lc.geom_key(130, 12, "cpu"))
    b = torch.rand(4, generator=lc.geom_key(130, 12, "cpu"))
    c = torch.rand(4, generator=lc.edge_key(130, 12, "cpu"))
    d = torch.rand(4, generator=lc.geom_key(12, 130, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def test_candidate_gater_same_decisions():
    rng = np.random.default_rng(5)
    kw = dict(dislocal=4, alpha=0.3, min_nss=0.001, k_consistency=1, max_db_results=8)
    gj = jlc.CandidateGater(JLoop(**kw), stride=2)
    gt = lc.CandidateGater(LoopClosureConfig(**kw), stride=2)
    decisions = []
    for fid in range(10, 200, 2):
        base = 20 + 13 * (fid // 24)  # runs of consistent candidates
        ids = (base + rng.integers(-4, 5, 8)).astype(np.int32)
        ids[rng.random(8) < 0.2] = -1
        scores = np.sort(rng.random(8).astype(np.float32))[::-1] * rng.choice([0.0, 0.1, 1.0])
        ns = float(rng.choice([0.0, 0.05, 0.5], p=[0.1, 0.2, 0.7]))
        a, b = gj.gate(fid, ids, scores, ns), gt.gate(fid, ids, scores, ns)
        assert a == b, (fid, a, b)
        decisions.append(a)
    assert sum(d is not None for d in decisions) >= 5
    assert lc.group_islands(ids, scores) == jlc.group_islands(ids, scores)


def _gater_accept_sets(monkeypatch, phase: int):
    """Both packages' EpilogueGater(phase=) over the same shortlists, with
    detection rows on the frames of that phase; returns both accept lists."""
    kw = dict(dislocal=4, min_separation=20, cooldown=6, detect_every=2, alpha=0.3,
              min_nss=0.001, k_consistency=1, geom_min_points=12, db_capacity=64,
              max_db_results=8, orb_features=16)
    cfg_t = PipelineConfig(loop=LoopClosureConfig(**kw))
    cfg_j = JPipeline(loop=JLoop(**kw))

    def verdict(q, m):
        return 30 if (q + m) % 3 else 5

    def fake_j(db_bits, db_pts, db_ptv, q_fids, m_fids, t, r, iters):
        n = np.array([verdict(int(q), int(m)) for q, m in zip(q_fids, m_fids)], np.int32)
        P = n.shape[0]
        return jnp.asarray(n), jnp.zeros((P, 16), jnp.int32), jnp.zeros((P, 16), bool)

    def fake_t(db_bits, db_pts, db_ptv, q_fids, m_fids, t, r, iters):
        n = torch.tensor([verdict(int(q), int(m)) for q, m in zip(q_fids, m_fids)])
        P = n.shape[0]
        return n, torch.zeros((P, 16), dtype=torch.int64), torch.zeros((P, 16), dtype=torch.bool)

    monkeypatch.setattr(jlc, "_geom_match_many", fake_j)
    monkeypatch.setattr(lc, "_geom_match_many", fake_t)
    rng = np.random.default_rng(8)
    n, K = 120, 8
    ids = np.full((n, K), -1, np.int32)
    scores = np.full((n, K), -1e9, np.float32)
    ns = np.full((n,), -1.0, np.float32)
    for i in range(n):  # detection rows: fid = i + 1 of the gater's phase
        fid = i + 1
        if fid % 2 != phase:
            continue
        ids[i] = np.clip(fid - 40 + rng.integers(-2, 3, K), 0, None)
        scores[i] = np.sort(rng.random(K))[::-1].astype(np.float32)
        ns[i] = 0.5
    gj = jscan.EpilogueGater(cfg_j, phase=phase)
    gt = slam_scan.EpilogueGater(cfg_t, key=None, phase=phase)
    lc_j = jscan.init_lc_state(cfg_j, 16)
    lc_t = slam_scan.init_lc_state(cfg_t, device="cpu")
    acc_j, acc_t = [], []
    for s, e in ((0, 50), (50, n)):
        acc_j += gj.process(lc_j, ids[s:e], scores[s:e], ns[s:e], fid_start=1 + s)
        acc_t += gt.process(lc_t, ids[s:e], scores[s:e], ns[s:e], fid_start=1 + s)
        assert gj.cooldown == gt.cooldown
    assert [(a[0], a[1], a[4]) for a in acc_t] == [(a[0], a[1], a[4]) for a in acc_j]
    assert len(acc_t) >= 3
    return acc_t


def test_epilogue_gater_same_accept_set(monkeypatch):
    """Both packages' EpilogueGater on the same stats, geometry stubbed by
    the same rule: the accepted (query, match, n_inliers) lists are equal,
    across a block split that carries the cooldown."""
    _gater_accept_sets(monkeypatch, 0)


def test_epilogue_gater_phase_matches_jax(monkeypatch):
    """A lane of the interleaved cadence: ``phase=1`` gates the odd frames,
    as the JAX gater does, and accepts only odd queries."""
    acc = _gater_accept_sets(monkeypatch, 1)
    assert all(a[0] % 2 == 1 for a in acc)


def _circle(n, radius=10.0):
    poses = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        th = 2 * np.pi * i / (n - 1)
        c, s = np.cos(th), np.sin(th)
        poses[i] = np.eye(4)
        poses[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        poses[i, :3, 3] = [radius * s, 0.0, radius * (1 - c)]
    return poses


def _drifted(gt, drift, seed):
    rng = np.random.default_rng(seed)
    out = gt.copy()
    for i in range(1, gt.shape[0]):
        noise = np.concatenate([rng.normal(0, drift, 3), rng.normal(0, drift * 0.1, 3)])
        Zn = (np.linalg.inv(gt[i - 1]) @ gt[i]) @ np.asarray(
            jlie.exp_se3(jnp.asarray(noise, jnp.float32)))
        out[i] = out[i - 1] @ Zn
    return out.astype(np.float32)


def test_pose_graph_matches_reference():
    n = 40
    gt = _circle(n)
    est = _drifted(gt, 0.03, 0)
    F = 48
    poses = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    poses[:n] = est
    Zj = np.asarray(jpg.chain_measurements(jnp.asarray(poses)))
    Zt = pg.chain_measurements(torch.from_numpy(poses))
    np.testing.assert_allclose(Zt.numpy(), Zj, atol=1e-5)
    # two loop edges: the identity revisit and a measured mid-loop edge
    li = np.array([n - 1, 30], np.int32)
    lj = np.array([0, 10], np.int32)
    lZ = np.stack([np.eye(4), np.linalg.inv(gt[30]) @ gt[10]]).astype(np.float32)
    lv = np.array([True, True])
    kw = dict(iters=10, cg_iters=64, damping=1e-6)
    oj = np.asarray(jpg.optimize(jnp.asarray(poses), jnp.int32(n), jnp.asarray(Zj),
                                 jnp.asarray(li), jnp.asarray(lj), jnp.asarray(lZ),
                                 jnp.asarray(lv), **kw))
    ot = pg.optimize(torch.from_numpy(poses), n, Zt, torch.from_numpy(li),
                     torch.from_numpy(lj), torch.from_numpy(lZ), torch.from_numpy(lv),
                     **kw).numpy()
    np.testing.assert_allclose(ot[:, :3, 3], oj[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(ot[:, :3, :3], oj[:, :3, :3], atol=1e-3)
    np.testing.assert_array_equal(ot[n:], poses[n:])  # beyond n_poses: untouched
    err_before = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1).mean()
    err_after = np.linalg.norm(ot[:n, :3, 3] - gt[:, :3, 3], axis=1).mean()
    assert err_after < 0.6 * err_before

    # map rewrite of keyframe clouds at frames 0, 15, 39
    rng = np.random.default_rng(1)
    pts = rng.normal(0, 5, (3, 20, 3)).astype(np.float32)
    fidx = np.array([0, 15, 39], np.int32)
    rj = np.asarray(jpg.rewrite_points(jnp.asarray(pts), jnp.asarray(fidx),
                                       jnp.asarray(poses), jnp.asarray(oj)))
    rt = pg.rewrite_points(torch.from_numpy(pts), torch.from_numpy(fidx),
                           torch.from_numpy(poses), torch.from_numpy(oj)).numpy()
    np.testing.assert_allclose(rt, rj, atol=1e-4)


def test_spd_inverse_small_matches_reference():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(10, 6, 6)).astype(np.float32)
    B = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(6, dtype=np.float32)
    it = linalg.spd_inverse_small(torch.from_numpy(B)).numpy()
    ij = np.asarray(jlinalg.spd_inverse_small(jnp.asarray(B)))
    np.testing.assert_allclose(it, ij, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(it @ B, np.broadcast_to(np.eye(6), B.shape), atol=1e-3)


def test_unported_parts_documented():
    """The online slice refuses nothing any more.  The multi-device mesh is
    ported (tests/test_torch_parallel.py): a mesh that is not a
    ``parallel.mesh.Mesh`` raises TypeError.  The four frontend choices of
    ROADMAP item 23 are ported: both online drivers take each one (with BA
    on) and bootstrap frame 0 with it."""
    from ros_stereo_slam_tpu_torch.config import PGOConfig
    from ros_stereo_slam_tpu_torch.models import slam, slam_chunked
    from ros_stereo_slam_tpu_torch.models.vocab import Vocabulary

    cfg = PipelineConfig()
    with pytest.raises(TypeError, match="Mesh"):
        slam.StereoSLAM(cfg, device="cpu", mesh=object())
    graph = pg.PoseGraph(PGOConfig(max_poses=8), device="cpu")
    graph.initialize()
    with pytest.raises(TypeError, match="Mesh"):
        graph.optimize(torch.eye(4).repeat(8, 1, 1), mesh=object())
    voc = Vocabulary(k=2, levels=1, centers=[torch.ones((2, 256), dtype=torch.int8)],
                     idf=torch.ones(2))
    world = small_world(n_frames=1, seed=3)
    left, right, _ = world.render(0)
    for choice in (dict(sampler="anms"), dict(stereo_matcher="orb"),
                   dict(fmat_gate="ransac"), dict(stereo_gate="fmat")):
        other = cfg.replace(camera=world.camera, ba_enabled=True,
                            frontend=dataclasses.replace(cfg.frontend, **choice))
        s = slam.StereoSLAM(other, device="cpu")
        s.initialize(left, right)
        c = slam_chunked.ChunkedSLAM(other, voc, device="cpu")
        c.initialize(left, right)
        for carry in (s._carry, c._carry):
            assert int(carry.track.mask.sum()) > 50, choice
            assert carry.ba is not None
    assert dataclasses.is_dataclass(slam_scan.ScanSlamResult)
