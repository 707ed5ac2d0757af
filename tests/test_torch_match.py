"""Descriptor matching (``ops/match.py``) and the ORB-stereo frontend: the
port against the JAX package.

Mirrors tests/test_match.py.  Bounds:

- ``mutual_hamming_match``: ``idx`` and ``valid`` equal to JAX's exactly
  (the distances are exact integers with TF32 off), ``dist`` within 0 on
  the three unit cases and on constructed ties (a query with two equal
  best columns takes the first and fails the strict ratio test; a column
  nearest to two queries is mutual with the first);
- the lane form: lane b of one (B, N, M) call equals the 2-D call on
  lane b, bitwise;
- the ORB-stereo bootstrap of frame 0 (``stereo_matcher="orb"``): the
  left corners, the match validity and the matched right points equal to
  JAX's exactly;
- ``run_offline`` with ORB stereo on the 6-frame world of
  tests/test_match.py: every frame tracked, JAX's own per-frame bound
  (0.15 m x frame), the same keyframes as JAX's run, and each position
  within 4 cm of JAX's (the RANSAC draws differ; 1.8 cm measured).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import preset_odometry as j_preset
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.ops import match as jmatch
from ros_stereo_slam_tpu.ops import pyramid as jpyr
from ros_stereo_slam_tpu_torch.config import preset_odometry
from ros_stereo_slam_tpu_torch.models import pipeline, step
from ros_stereo_slam_tpu_torch.ops import match, pyramid
from ros_stereo_slam_tpu_torch.ops.orb import N_BITS

POS_TOL_M = 0.04
# tests/test_match.py: the ORB corners need the full seeded GN budget, and
# the feature count doubles as the stereo match pool.
ORB_STEREO = dict(stereo_matcher="orb", lk_seeded_iters=10, max_points=1152)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signs(bits):
    return np.where(bits, 1.0, -1.0).astype(np.float32)


def _both(sa, va, sb, vb, **kw):
    """(JAX result, port result) as numpy tuples."""
    pm = kw.pop("pair_mask", None)
    j = jmatch.mutual_hamming_match(jnp.asarray(sa), jnp.asarray(va), jnp.asarray(sb),
                                    jnp.asarray(vb), pair_mask=None if pm is None
                                    else jnp.asarray(pm), **kw)
    t = match.mutual_hamming_match(torch.from_numpy(sa), torch.from_numpy(va),
                                   torch.from_numpy(sb), torch.from_numpy(vb),
                                   pair_mask=None if pm is None else torch.from_numpy(pm), **kw)
    return [np.asarray(x) for x in j], [x.numpy() for x in t]


def _assert_same(j, t):
    np.testing.assert_array_equal(t[0], j[0])
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[1], j[1])


def test_mutual_match_exact_and_ratio():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 2, (32, N_BITS)).astype(bool)
    perm = rng.permutation(32)
    b = np.concatenate([a[perm], rng.integers(0, 2, (16, N_BITS)).astype(bool)])
    j, t = _both(_signs(a), np.ones(32, bool), _signs(b), np.ones(48, bool),
                 max_dist=10.0, ratio=0.8)
    _assert_same(j, t)
    assert t[2].all()
    np.testing.assert_array_equal(t[0], np.argsort(perm))
    np.testing.assert_allclose(t[1], 0.0)


def test_mutual_match_rejects_ambiguous():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2, (8, N_BITS)).astype(bool)
    j, t = _both(_signs(a), np.ones(8, bool), _signs(np.concatenate([a, a])), np.ones(16, bool),
                 max_dist=10.0, ratio=0.8)
    _assert_same(j, t)
    assert not t[2].any()  # the ratio test kills duplicates
    np.testing.assert_array_equal(t[0], np.arange(8))  # the first of two equal columns


def test_mutual_match_respects_masks():
    rng = np.random.default_rng(2)
    a = _signs(rng.integers(0, 2, (8, N_BITS)).astype(bool))
    j, t = _both(a, np.zeros(8, bool), a, np.ones(8, bool))
    _assert_same(j, t)
    assert not t[2].any()


def test_mutual_match_ties_and_pair_mask():
    """Constructed ties: B holds, for query i, two columns at the same
    distance (the first must win and fail the strict ratio test), and two
    queries share a nearest column (mutual with the first only); a pair
    mask removes one exact match."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2, (12, N_BITS)).astype(bool)
    a[2] = a[1]  # queries 1 and 2 share their nearest column, 1
    b = a.copy()
    b[2] = rng.integers(0, 2, N_BITS).astype(bool)
    b[0, :3] = ~b[0, :3]  # query 0: column 0 at distance 3 ...
    extra = a[0].copy()
    extra[-3:] = ~extra[-3:]  # ... and column 12 at distance 3
    b = np.concatenate([b, extra[None]])
    va, vb = np.ones(len(a), bool), np.ones(len(b), bool)
    pair = np.ones((len(a), len(b)), bool)
    pair[5, 5] = False
    j, t = _both(_signs(a), va, _signs(b), vb, max_dist=64.0, ratio=0.8, pair_mask=pair)
    _assert_same(j, t)
    assert t[0][0] == 0 and not t[2][0]
    assert t[0][1] == t[0][2] == 1 and t[2][1] and not t[2][2]
    assert t[0][5] != 5


def test_lane_form_equals_per_lane_calls():
    rng = np.random.default_rng(4)
    B, N, M = 3, 40, 56
    sa = _signs(rng.integers(0, 2, (B, N, N_BITS)).astype(bool))
    sb = np.concatenate([sa[:, rng.permutation(N)[:30]],
                         _signs(rng.integers(0, 2, (B, M - 30, N_BITS)).astype(bool))], axis=1)
    sb[:, :30, :20] *= -1  # matches at distance 20
    va, vb = rng.random((B, N)) < 0.9, rng.random((B, M)) < 0.9
    pair = rng.random((B, N, M)) < 0.8
    lanes = match.mutual_hamming_match(*map(torch.from_numpy, (sa, va, sb, vb)),
                                       pair_mask=torch.from_numpy(pair))
    assert lanes.valid.any()
    for b in range(B):
        one = match.mutual_hamming_match(*(torch.from_numpy(x[b]) for x in (sa, va, sb, vb)),
                                         pair_mask=torch.from_numpy(pair[b]))
        for x, y in zip(lanes, one):
            assert torch.equal(x[b], y)


@pytest.fixture(scope="module")
def world():
    w = small_world(n_frames=6, seed=3)
    frames = [w.render(i) for i in range(6)]
    return w, np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames])


def _cfgs(camera):
    t = preset_odometry()
    j = j_preset()
    return (t.replace(camera=camera, frontend=dataclasses.replace(t.frontend, **ORB_STEREO)),
            dataclasses.replace(j, camera=camera,
                                frontend=dataclasses.replace(j.frontend, **ORB_STEREO)))


def test_orb_bootstrap_equals_jax(world):
    w, L, R = world
    tcfg, jcfg = _cfgs(w.camera)
    levels = tcfg.frontend.lk_levels
    jl = tuple(jpyr.build_pyramid(jnp.asarray(L[0]), levels))
    jr = tuple(jpyr.build_pyramid(jnp.asarray(R[0]), levels))
    jtrack, jr_uv, jmask = jstep._bootstrap_track(jl, jr, None, None, jnp.eye(4),
                                                  jax.random.PRNGKey(0), jcfg)
    tl = tuple(p[None] for p in pyramid.build_pyramid(torch.from_numpy(L[0]), levels))
    tr = tuple(p[None] for p in pyramid.build_pyramid(torch.from_numpy(R[0]), 1))
    ttrack, tr_uv, tmask = step._bootstrap_track(tl, tr, None, None, torch.eye(4)[None], tcfg)
    np.testing.assert_array_equal(ttrack.pts2d[0].numpy(), np.asarray(jtrack.pts2d))
    np.testing.assert_array_equal(tmask[0].numpy(), np.asarray(jmask))
    m = np.asarray(jmask)
    assert m.sum() > 200, m.sum()
    np.testing.assert_array_equal(tr_uv[0].numpy()[m], np.asarray(jr_uv)[m])
    np.testing.assert_allclose(ttrack.pts3d[0].numpy()[m], np.asarray(jtrack.pts3d)[m],
                               rtol=1e-5, atol=1e-5)


def test_orb_stereo_pipeline_tracks(world):
    w, L, R = world
    tcfg, jcfg = _cfgs(w.camera)
    jres = jpipe.run_offline(jcfg, L, R)
    res = pipeline.run_offline(tcfg, L, R, device="cpu")
    assert res.tracking_ok.all(), res.n_inliers
    np.testing.assert_array_equal(res.is_keyframe, jres.is_keyframe)
    for i in range(1, 6):
        err = np.linalg.norm(res.trajectory[i][:3, 3] - w.poses[i][:3, 3])
        assert err < 0.15 * i, (i, err)
    diff = np.linalg.norm(res.trajectory[:, :3, 3] - jres.trajectory[:, :3, 3], axis=1)
    assert diff.max() < POS_TOL_M, diff
