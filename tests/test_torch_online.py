"""The pieces of the online drivers, the port against the JAX package.

Same seeded inputs through both packages on the CPU.  Bounds:

- ``PoseGraph``: a JAX graph with odometry and loop edges, carried across
  by ``convert.graph_from_numpy``, optimizes within the bounds of
  ``test_torch_loop.py::test_pose_graph_matches_reference`` (positions 2
  mm, rotations 1e-3); the port's ``add_odometry``/``add_loop`` build the
  same arrays (odometry edges within 1e-6);
- g2o: each package loads the other's file: poses within 1e-6 (a
  quaternion round trip in float32), edge endpoints and counts equal;
- capacity: every append raises on a full graph;
- checkpoint: a bf16 leaf round-trips exactly; a structure or shape
  mismatch raises;
- ``LoopDetector`` stats on frames 20, 40 and 72 of the 80-frame revisit
  world (every frame added, the world, configuration and vocabulary of
  ``test_torch_slam_slice.py``) against JAX's ``LoopDetector`` and
  ``_query_scores`` on the same ORB features: top ids equal, scores
  within 1e-5, ns within 1e-4; a detector carried across from JAX's at
  frame 40 answers frame 72 the same way; and the port's
  ``_lc_scan_step`` gives the detector's stats bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop import _circle, _drifted
from test_torch_slam_slice import _one_torch_thread, world_and_vocab  # noqa: F401

from ros_stereo_slam_tpu.config import PGOConfig as JPGO
from ros_stereo_slam_tpu.models import loop_closure as jlc
from ros_stereo_slam_tpu.models import pose_graph as jpg
from ros_stereo_slam_tpu.models import vocab as jvocab
from ros_stereo_slam_tpu.ops import orb as jorb
from ros_stereo_slam_tpu_torch.config import PGOConfig
from ros_stereo_slam_tpu_torch.models import convert, slam_scan
from ros_stereo_slam_tpu_torch.models import loop_closure as lc
from ros_stereo_slam_tpu_torch.models import pose_graph as pg
from ros_stereo_slam_tpu_torch.ops import orb
from ros_stereo_slam_tpu_torch.utils import checkpoint

N_POSES = 40
CFG = dict(max_poses=48, max_loop_edges=8, iters=10, cg_iters=64)


def _jax_graph():
    """A drifted 40-pose loop in the JAX PoseGraph: the identity revisit
    edge and a measured mid-loop edge.  Returns (graph, poses, loop edges)."""
    gt = _circle(N_POSES)
    est = _drifted(gt, 0.03, 0)
    g = jpg.PoseGraph(JPGO(**CFG))
    g.initialize()
    for i in range(1, N_POSES):
        g.add_odometry(jnp.asarray(np.linalg.inv(est[i - 1]) @ est[i], jnp.float32))
    loops = [(N_POSES - 1, 0, None), (30, 10, (np.linalg.inv(gt[30]) @ gt[10]).astype(np.float32))]
    for i, j, Z in loops:
        g.add_loop(i, j, None if Z is None else jnp.asarray(Z))
    poses = np.tile(np.eye(4, dtype=np.float32), (CFG["max_poses"], 1, 1))
    poses[:N_POSES] = est
    return g, poses, loops


def test_pose_graph_carried_across_matches_jax():
    jg, poses, loops = _jax_graph()
    tg = convert.graph_from_numpy(jg, "cpu")
    assert (tg.count, tg.n_loops) == (N_POSES, 2)
    oj = np.asarray(jg.optimize(jnp.asarray(poses)))
    ot = tg.optimize(torch.from_numpy(poses)).numpy()
    np.testing.assert_allclose(ot[:, :3, 3], oj[:, :3, 3], atol=2e-3)
    np.testing.assert_allclose(ot[:, :3, :3], oj[:, :3, :3], atol=1e-3)

    # the port's incremental API builds the same graph
    g = pg.PoseGraph(PGOConfig(**CFG), device="cpu")
    g.initialize()
    g.add_odometry_batch(np.linalg.inv(poses[:N_POSES - 1]) @ poses[1:N_POSES])
    for i, j, Z in loops:
        g.add_loop(i, j, Z)
    np.testing.assert_allclose(g.odo_Z.numpy(), tg.odo_Z.numpy(), atol=1e-6)
    for name in ("loop_i", "loop_j", "loop_Z", "loop_valid"):
        np.testing.assert_array_equal(getattr(g, name).numpy(), getattr(tg, name).numpy())
    assert (g.count, g.n_loops) == (tg.count, tg.n_loops)


def test_g2o_files_cross_load(tmp_path):
    jg, poses, _ = _jax_graph()
    tg = convert.graph_from_numpy(jg, "cpu")
    cases = (
        (tg.save, lambda p: jpg.PoseGraph.load(p, JPGO(**CFG))),
        (jg.save, lambda p: pg.PoseGraph.load(p, PGOConfig(**CFG), device="cpu")),
    )
    for k, (save, load) in enumerate(cases):
        path = str(tmp_path / f"graph{k}.g2o")
        save(path, poses[:N_POSES])
        g, loaded = load(path)
        assert (g.count, g.n_loops) == (N_POSES, 2)
        np.testing.assert_allclose(loaded[:N_POSES], poses[:N_POSES], atol=1e-6)
        np.testing.assert_array_equal(loaded[N_POSES:], poses[N_POSES:])
        np.testing.assert_allclose(np.asarray(g.odo_Z)[:N_POSES],
                                   tg.odo_Z.numpy()[:N_POSES], atol=1e-6)
        for name in ("loop_i", "loop_j", "loop_valid"):
            np.testing.assert_array_equal(np.asarray(getattr(g, name)),
                                          getattr(tg, name).numpy(), name)
        np.testing.assert_allclose(np.asarray(g.loop_Z), tg.loop_Z.numpy(), atol=1e-6)


@pytest.mark.parametrize("append", ["add_odometry", "add_odometry_batch", "add_loop"])
def test_pose_graph_capacity_raises(append):
    g = pg.PoseGraph(PGOConfig(max_poses=4, max_loop_edges=2), device="cpu")
    g.initialize()
    eye = np.eye(4, dtype=np.float32)
    if append == "add_loop":
        g.add_loop(2, 0)
        g.add_loop(3, 1, eye)
        with pytest.raises(RuntimeError, match="loop-edge capacity"):
            g.add_loop(3, 0)
        assert g.n_loops == 2
    else:
        g.add_odometry_batch(np.stack([eye, eye]))
        g.add_odometry(eye)
        with pytest.raises(RuntimeError, match="pose-graph capacity"):
            getattr(g, append)(eye if append == "add_odometry" else eye[None])
        assert g.count == 4


def _tree(rng):
    return {
        "db": slam_scan.LCScanState(*(
            torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)).to(dt)
            for dt in (torch.int32, torch.float32, torch.bfloat16, torch.int32, torch.float32,
                       torch.bool, torch.bool, torch.int32, torch.int32, torch.float32,
                       torch.bool))),
        "pyr": (torch.zeros(4, 4), torch.zeros(2, 2)),
        "key": (123456789012345678, 7),
        "frame_idx": 41,
    }


def test_checkpoint_round_trips_bf16_and_plain_leaves(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_pytree(path, tree, {"frame_count": 41})
    like = _tree(np.random.default_rng(1))
    like["key"], like["frame_idx"] = (0, 0), 0
    out, meta = checkpoint.load_pytree(path, like)
    assert meta == {"frame_count": 41}
    assert type(out["db"]) is slam_scan.LCScanState
    assert out["db"].db_bins.dtype == torch.bfloat16
    for a, b in zip(out["db"] + out["pyr"], tree["db"] + tree["pyr"]):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)
    assert out["key"] == (123456789012345678, 7) and out["frame_idx"] == 41


@pytest.mark.parametrize("change", ["structure", "shape"])
def test_checkpoint_mismatch_raises(tmp_path, change):
    rng = np.random.default_rng(0)
    path = str(tmp_path / "ck.npz")
    checkpoint.save_pytree(path, _tree(rng))
    like = _tree(rng)
    if change == "structure":
        like["pyr"] = like["pyr"][:1]
        match = "structure"
    else:
        like["pyr"] = (torch.zeros(4, 5), torch.zeros(2, 2))
        match = "shape"
    with pytest.raises(ValueError, match=match):
        checkpoint.load_pytree(path, like)


def _jax_feats(f: orb.OrbFeatures) -> jorb.OrbFeatures:
    return jorb.OrbFeatures(
        pts=jnp.asarray(f.pts.numpy()), angle=jnp.asarray(f.angle.numpy()),
        desc_bits=jnp.asarray(f.desc_bits.numpy().view(np.uint32)),
        desc_sign=jnp.asarray(f.desc_sign.numpy()), valid=jnp.asarray(f.valid.numpy()),
        octave=jnp.asarray(f.octave.numpy()))


def _port_stats(det: lc.LoopDetector, bow, fid: int):
    lcc, db = det.config, det.lc
    uw, uv = bow
    ids, scores = lc._query_scores(
        uw, uv, lc.vocab_mod.bin_of_sparse(uw, uv, lcc.n_bins), db.db_words, db.db_wvals,
        db.db_bins, db.db_valid, fid - lcc.dislocal - 1, db.db_ids, lcc.max_db_results,
        lcc.shortlist)
    ns = lc.vocab_mod.score_pair_min(uw, uv, db.last_words, db.last_wvals)
    return float(ns), ids.numpy(), scores.numpy()


def _jax_stats(det, bow, fid: int):
    lcc = det.config
    ids, scores = jlc._query_scores(
        *bow, jvocab.bin_of_sparse(*bow, lcc.n_bins), det.db_words, det.db_wvals,
        det.db_bins, det.db_valid, jnp.int32(fid - lcc.dislocal - 1), det.db_ids,
        lcc.max_db_results, lcc.shortlist)
    ns = float(jvocab.score_pair_min(*bow, *det._last))
    return ns, np.asarray(ids), np.asarray(scores)


def _assert_stats(port, ref, fid, ns_tol=1e-4):
    ns_t, ids_t, sc_t = port
    ns_j, ids_j, sc_j = ref
    assert abs(ns_t - ns_j) < ns_tol, (fid, ns_t, ns_j)
    real = sc_j > -1e8  # JAX leaves the ids of empty slots unmasked
    np.testing.assert_array_equal(real, sc_t > -1e8, err_msg=f"frame {fid}")
    np.testing.assert_array_equal(ids_t[real], ids_j[real], err_msg=f"frame {fid}")
    np.testing.assert_array_equal(ids_t[~real], -1)
    np.testing.assert_allclose(sc_t[real], sc_j[real], atol=1e-5, err_msg=f"frame {fid}")


def test_loop_detector_matches_jax_and_scan_step(world_and_vocab):
    _, L, _, voc, jcfg, tcfg = world_and_vocab
    tvoc = convert.vocab_from_numpy(voc, "cpu")
    lcc = tcfg.loop
    check = (20, 40, 72)
    det_t = lc.LoopDetector(tvoc, lcc, device="cpu")
    det_j = jlc.LoopDetector(vocab=voc, config=jcfg.loop)
    carried = None
    scan_lc = slam_scan.init_lc_state(tcfg, device="cpu")
    tree = tvoc.packed()
    n_checked = 0
    for i in range(max(check) + 1):
        img = torch.from_numpy(L[i])
        feats = orb.detect_and_compute(img, lcc.orb_features, tcfg.frontend.fast_thresh / 255.0,
                                       n_levels=lcc.orb_levels)
        jfeats = _jax_feats(feats)
        bow_t, bow_j = det_t._bow_of(feats), det_j._bow_of(jfeats)
        scan_lc, scan_stats = slam_scan._lc_scan_step(scan_lc, img, i, tree, tvoc.idf, tcfg,
                                                      tvoc.k)
        if i in check:
            stats_t = _port_stats(det_t, bow_t, i)
            _assert_stats(stats_t, _jax_stats(det_j, bow_j, i), i)
            # the scan step's query is the detector's, bit for bit
            assert float(scan_stats.ns) == stats_t[0]
            np.testing.assert_array_equal(scan_stats.top_ids.numpy(), stats_t[1])
            np.testing.assert_array_equal(scan_stats.top_scores.numpy(), stats_t[2])
            if carried is not None:
                _assert_stats(_port_stats(carried, carried._bow_of(feats), i),
                              _jax_stats(det_j, bow_j, i), i)
            n_checked += 1
        det_t.add(i, feats, bow_t)
        det_j.add(i, jfeats, bow_j)
        if carried is not None:
            carried.add(i, feats)
        if i == 40:
            carried = convert.detector_from_numpy(det_j, tvoc, "cpu")
            assert carried.has_last and carried.config == lcc
    assert n_checked == len(check)
