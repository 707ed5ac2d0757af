"""The endurance regime (``ros_stereo_slam_tpu_torch.tools.endurance_run``)
against the JAX package, on the CPU at small sizes.

- The render: ``render_frames`` (worker processes) equals the JAX tool's
  serial recipe (``tools/endurance_run.py:103-175``), rebuilt here from
  ``ros_stereo_slam_tpu.data.synthetic``, bitwise in uint8 frames and
  ground-truth poses, plain and jittered.
- Wrapped rings: the world, vocabulary and loop settings of
  ``tests/test_torch_slam_slice.py`` over three exact laps of 48 poses
  (145 frames), with 16 keyframe slots and a 96-frame database, so that
  both rings wrap.  The JAX package's detection step and epilogue gater
  (its scan posture's; its fused scan is not compiled here, as in the
  slice test) against the port's, frame by frame and in the final
  database; the port's ``run_offline_slam`` accepts the JAX gater's
  set, within the slice test's trajectory bounds; ``StereoSLAM`` and
  ``run_online_slam(chunk=8)`` accept the same set.  The database spans
  two laps, so the rows it overwrites belong to lap 1 and are overwritten
  by lap 3's identical frames: F6 (below) cannot change a verdict here.
  The CLI's ``run_postures`` on the first two laps as uint8: StereoSLAM,
  fed the tool's ``x / 255`` frames, accepts the scan's set.
- F6: the scan posture verifies its candidates after the whole run, on
  the rows then in the ring slots ``frame_id % db_capacity``; once the
  ring has overwritten a candidate's row it verifies the frame that
  overwrote it.  Pinned on the same world with a 60-frame database: a
  revisit that passes on its own rows fails on the overwriting ones, in
  both packages alike (the port mirrors the JAX package).
- F7 (a)'s mechanism: the streaming posture's ``x / 255`` frames differ
  from the step's ``x * (1/255)`` in the last bit, and ORB finds other
  corners on them, in both packages.
- The CLI at ``--device cpu`` and a tiny size: ``summary.json`` with the
  JAX tool's keys (those of ``endurance_jitter/summary.json``) and the
  port's, ``metrics.jsonl`` with one line per frame after frame 0, exit
  code 1 below 3 closures (0 at 3 or more), 2 for a card that is absent.
"""

import json
import math
from pathlib import Path

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
from ros_stereo_slam_tpu.models import loop_closure as jlc
from ros_stereo_slam_tpu.models import slam_scan as jscan
from ros_stereo_slam_tpu.models import vocab as jvocab
from ros_stereo_slam_tpu.ops import orb as jorb
from ros_stereo_slam_tpu.utils import metrics
from ros_stereo_slam_tpu_torch.config import (
    CameraConfig, FrontendConfig, KeyframeConfig, LoopClosureConfig, PGOConfig,
    preset_loop_closure,
)
from ros_stereo_slam_tpu_torch.models import convert, loop_closure, slam, slam_chunked, slam_scan
from ros_stereo_slam_tpu_torch.tools import endurance_run

from test_torch_slam_slice import LOOP as SLICE_LOOP

ROOT = Path(__file__).resolve().parent.parent
LAP = 48  # poses a lap
N_FRAMES = 3 * LAP + 1
KF_SLOTS = 16
DB_CAP = 2 * LAP
F6_CAP = 60
F6_FRAMES = 91  # frames 0..90: frame 84 overwrites frame 24's row
F6_PAIR = (72, 24)  # the first revisit: query 72 sees frame 24's pose again


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the render ------------------------------------------------------------


def _jax_recipe(frames: int, lap: int, radius: float, scale: int, jitter: bool):
    """The JAX tool's render (tools/endurance_run.py:72-175), serially."""
    from ros_stereo_slam_tpu.config import CameraConfig as JCamera
    from ros_stereo_slam_tpu.data.synthetic import SyntheticWorld, jitter_poses

    s = scale
    cam = JCamera(fx=718.856 / s, fy=718.856 / s, cx=607.1928 / s, cy=185.2157 / s,
                  width=1241 // s, height=376 // s)
    L, r = lap, radius
    lap_poses = np.zeros((L, 4, 4))
    for i in range(L):
        th = 2 * np.pi * i / L
        c, sn = np.cos(th), np.sin(th)
        lap_poses[i] = np.eye(4)
        lap_poses[i, :3, :3] = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]])
        lap_poses[i, :3, 3] = np.array([r * (1 - c), 0.0, r * sn])
    F = frames
    idx = np.arange(F) % L
    world_kw = dict(half_w=max(3.0 * r, 18.0), end_z=max(6.0 * r, 260.0))
    if jitter:
        n_laps = int(np.ceil(F / L))
        rng = np.random.default_rng(17)
        lefts, rights, gt_list = [], [], []
        lap0_left = None
        for lap_i in range(n_laps):
            poses_l = (lap_poses if lap_i == 0
                       else jitter_poses(lap_poses, rng, trans_m=0.1, rot_deg=1.0))
            world = SyntheticWorld(camera=cam, n_frames=L, seed=11, custom_poses=poses_l,
                                   **world_kw)
            b = rng.uniform(0.85, 1.15) if lap_i > 0 else 1.0
            for i in range(L):
                if len(lefts) >= F:
                    break
                l_im, r_im, _ = world.render(i)
                if lap_i > 0:
                    noise = rng.normal(0, 0.02, l_im.shape).astype(l_im.dtype)
                    l_im = np.clip(l_im * b + noise, 0, 1)
                    r_im = np.clip(r_im * b + noise, 0, 1)
                lefts.append((l_im * 255).astype(np.uint8))
                rights.append((r_im * 255).astype(np.uint8))
                gt_list.append(poses_l[i])
            if lap_i == 0:
                lap0_left = np.stack(lefts[:L])
        return np.stack(lefts), np.stack(rights), np.stack(gt_list), lap0_left
    world = SyntheticWorld(camera=cam, n_frames=L, seed=11, custom_poses=lap_poses, **world_kw)
    lefts, rights = [], []
    for i in range(L):
        l_im, r_im, _ = world.render(i)
        lefts.append((l_im * 255).astype(np.uint8))
        rights.append((r_im * 255).astype(np.uint8))
    lap_left, lap_right = np.stack(lefts), np.stack(rights)
    return lap_left[idx], lap_right[idx], lap_poses[idx], lap_left


@pytest.mark.parametrize("jitter", [False, True], ids=["plain", "jitter"])
def test_render_frames_equal_the_jax_recipe(jitter):
    args = (20, 8, 20.0, 16, jitter)  # 20 frames, lap 8, radius 20 m, 77x23
    want = _jax_recipe(*args)
    got = endurance_run.render_frames(*args, workers=2)
    for name, w, g in zip(("left", "right", "gt", "lap_left"), want, got):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[0].dtype == np.uint8 and got[0].shape == (20, 23, 77)
    if jitter:  # later laps really differ from lap 1
        assert not np.array_equal(got[0][8], got[0][0])
    else:
        np.testing.assert_array_equal(got[0][16], got[0][0])


def test_render_with_one_worker_equals_the_recipe():
    """One worker process renders every job in turn (the noise generator's
    state handed on from job to job), bitwise the recipe's frames."""
    a = endurance_run.render_frames(12, 8, 20.0, 16, True, workers=1)
    b = _jax_recipe(12, 8, 20.0, 16, True)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_lap_geometry_and_offsets():
    poses = endurance_run.lap_poses(512, 20.0)
    steps = np.linalg.norm(np.diff(poses[:, :3, 3], axis=0), axis=1)
    np.testing.assert_allclose(steps, 2 * 20.0 * math.sin(math.pi / 512), rtol=1e-9)
    assert endurance_run.world_kw(20.0) == dict(half_w=60.0, end_z=260.0)
    assert endurance_run.revisit_offset(1156, 132, 512) == 0
    assert endurance_run.revisit_offset(3148, 2640, 512) == 4
    assert endurance_run.revisit_offset(622, 112, 512) == 2
    assert endurance_run.revisit_offset(100, 0, 512) == 100
    ring = endurance_run.bow_ring(4096, endurance_run.loop_config(1))
    assert ring == {"bow_inserts": 2048, "bow_ring_wraps": 0, "bow_rows_overwritten": 0}
    ring = endurance_run.bow_ring(1024, endurance_run.loop_config(1, 960, detect_every=1))
    assert ring == {"bow_inserts": 1024, "bow_ring_wraps": 1, "bow_rows_overwritten": 64}


# -- three laps with wrapped rings -------------------------------------------


def _configs(world, cap: int, n_frames: int):
    loop = dict(SLICE_LOOP, db_capacity=cap)
    pgo = dict(max_poses=n_frames + 7, max_loop_edges=16, iters=10, cg_iters=64)
    kf = dict(max_keyframes=KF_SLOTS, min_pnp_inliers=150, map_block_points=1024)
    jcfg = j_preset().replace(camera=world.camera,
                              frontend=JFrontend(grid_step=12, max_points=1024),
                              keyframes=JKeyframe(**kf), loop=JLoop(**loop), pgo=JPGO(**pgo))
    tcfg = preset_loop_closure().replace(camera=CameraConfig(**vars(world.camera)),
                                         frontend=FrontendConfig(grid_step=12, max_points=1024),
                                         keyframes=KeyframeConfig(**kf),
                                         loop=LoopClosureConfig(**loop), pgo=PGOConfig(**pgo))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def laps():
    """The slice test's world over three exact laps, and its vocabulary."""
    poses = loop_trajectory(N_FRAMES, radius=2.5, overlap=N_FRAMES - LAP)
    world = small_world(custom_poses=poses, seed=13)
    world.half_w = 10.0
    frames = [world.render(i)[:2] for i in range(N_FRAMES)]
    L = np.stack([f[0] for f in frames]).astype(np.float32)
    R = np.stack([f[1] for f in frames]).astype(np.float32)
    descs, docs = [], []
    for i in range(0, 80, 4):
        f = jorb.detect_and_compute(jnp.asarray(L[i]), 128)
        v = np.asarray(f.valid)
        descs.append(np.asarray(f.desc_sign)[v])
        docs.append(np.full(v.sum(), i))
    voc = jvocab.train(np.concatenate(descs), k=4, levels=3, doc_ids=np.concatenate(docs))
    return world, L, R, voc, convert.vocab_from_numpy(voc, "cpu")


def _detect_both(laps, cap: int, n_frames: int, snapshot_at: int | None = None):
    """Both packages' detection over every detection frame of frames
    0..n_frames-1 with a `cap`-frame database: (JAX state, port state, JAX
    rows, port rows, per-frame (fid, jax stats, port stats), port state
    copied after frame `snapshot_at`, JAX state then)."""
    world, L, _, voc, tvoc = laps
    jcfg, tcfg = _configs(world, cap, n_frames)
    lcj = jscan.init_lc_state(jcfg, voc.n_words)
    lct = slam_scan.init_lc_state(tcfg, device="cpu")
    centers, idf = tuple(voc.centers), jnp.asarray(voc.idf)
    K = slam_scan._top_k_count(tcfg.loop)
    rows = {name: (np.full((n_frames - 1, K), -1, np.int32),
                   np.full((n_frames - 1, K), -1e9, np.float32),
                   np.full((n_frames - 1,), -1.0, np.float32)) for name in ("jax", "port")}
    per_frame, snap = [], None
    tree = tvoc.packed()
    for fid in range(0, n_frames, tcfg.loop.detect_every):
        lcj, sj = jscan._lc_scan_step_jit(lcj, jnp.asarray(L[fid]), jnp.int32(fid), centers,
                                          idf, jcfg, voc.k)
        lct, st = slam_scan._lc_scan_step(lct, torch.from_numpy(L[fid]), fid, tree, tvoc.idf,
                                          tcfg, tvoc.k)
        sj = jax.device_get(sj)
        st = tuple(x.numpy() for x in st)
        per_frame.append((fid, sj, st))
        if fid >= 1:
            for name, s in (("jax", (sj.top_ids, sj.top_scores, sj.ns)), ("port", st)):
                for arr, val in zip(rows[name], s):
                    arr[fid - 1] = val
        if fid == snapshot_at:
            snap = (type(lct)(*(x.clone() for x in lct)), jax.device_get(lcj))
    return lcj, lct, rows, per_frame, snap, (jcfg, tcfg)


@pytest.fixture(scope="module")
def wrapped_detection(laps):
    return _detect_both(laps, DB_CAP, N_FRAMES)


@pytest.fixture(scope="module")
def wrapped_scan(laps, wrapped_detection):
    world, L, R, _, tvoc = laps
    tcfg = wrapped_detection[-1][1]
    return slam_scan.run_offline_slam(tcfg, tvoc, L, R, device="cpu")


def test_wrapped_database_matches_jax(wrapped_detection):
    """Frame by frame and in the final state, with the BoW ring wrapped
    (slot ``frame_id % 96``): the slice test's bounds."""
    lcj, lct, _, per_frame, _, _ = wrapped_detection
    for fid, sj, (ids, scores, ns) in per_frame:
        np.testing.assert_array_equal(ids, sj.top_ids, err_msg=f"frame {fid}")
        np.testing.assert_allclose(scores, sj.top_scores, atol=1e-5, err_msg=f"frame {fid}")
        assert abs(float(ns) - float(sj.ns)) < 1e-5, (fid, ns, sj.ns)
    j = jax.device_get(lcj)
    t = convert.lc_state_to_numpy(lct)
    for name in ("db_words", "db_pt_valid", "db_valid", "db_ids", "last_words", "have_last"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)), name)
    np.testing.assert_allclose(t.db_wvals, np.asarray(j.db_wvals), atol=1e-6)
    np.testing.assert_allclose(t.db_pts, np.asarray(j.db_pts), atol=1e-4)
    assert (t.db_bits == np.asarray(j.db_bits)).mean() >= 0.999
    # the ring wrapped: every slot holds the last detection frame that maps to it
    fids = np.arange(0, N_FRAMES, 2)
    assert fids[-1] >= DB_CAP
    want = np.full(DB_CAP, -1)
    for f in fids:
        want[f % DB_CAP] = f
    np.testing.assert_array_equal(t.db_ids, want)
    assert (t.db_ids >= DB_CAP).sum() == (fids >= DB_CAP).sum() > LAP // 2 - 1


def test_scan_with_wrapped_rings_accepts_the_jax_set(laps, wrapped_detection, wrapped_scan):
    world, *_ = laps
    lcj, lct, rows, _, _, (jcfg, tcfg) = wrapped_detection
    acc_j = jscan.EpilogueGater(jcfg).process(lcj, *rows["jax"], fid_start=1)
    acc_t = slam_scan.EpilogueGater(tcfg).process(lct, *rows["port"], fid_start=1)
    want = [(a[0], a[1]) for a in acc_j]
    assert [(a[0], a[1]) for a in acc_t] == want
    for a_t, a_j in zip(acc_t, acc_j):
        assert abs(a_t[4] - a_j[4]) <= 0.1 * a_j[4], (a_t[4], a_j[4])
    res = wrapped_scan
    assert [(q, m) for q, m, _ in res.loop_events] == want
    assert len(want) >= 3 and all(endurance_run.revisit_offset(q, m, LAP) == 0 for q, m in want)
    assert any(q >= 2 * LAP for q, _ in want), "lap 3 must close too"
    # the keyframe ring wrapped (more keyframes inserted than slots)
    kf = res.keyframes
    assert int(kf.count) > 2 * KF_SLOTS and bool(kf.valid.all())
    # the slice test's trajectory bounds
    assert res.tracking_ok.all()
    gt = world.poses[:N_FRAMES]
    ate = metrics.ate_rmse(res.trajectory, gt)
    ate_odo = metrics.ate_rmse(res.trajectory_odo, gt)
    assert ate < ate_odo and ate < 0.25, (ate, ate_odo)
    fidx = kf.frame_idx.numpy()
    assert fidx.min() > N_FRAMES - 1 - 4 * KF_SLOTS  # the ring holds recent keyframes only
    np.testing.assert_allclose(kf.poses.numpy(), res.trajectory[fidx], atol=1e-5)
    assert kf.retrack.numpy().all()


@pytest.mark.parametrize("posture", ["streaming", "chunked"])
def test_online_postures_accept_the_scan_set(laps, wrapped_detection, wrapped_scan, posture):
    """StereoSLAM and run_online_slam(chunk=8) with both rings wrapped
    accept the scan's set, and their keyframe rings wrapped too."""
    world, L, R, _, tvoc = laps
    tcfg = wrapped_detection[-1][1]
    if posture == "streaming":
        s = slam.StereoSLAM(tcfg, tvoc, device="cpu")
        s.initialize(L[0], R[0])
        for i in range(1, N_FRAMES):
            s.process_frame(L[i], R[i])
        events = [(e.query, e.match) for e in s.loop_events]
        traj, kf = s.trajectory_array(), s.keyframes
        assert not s.tracking_failed
    else:
        res = slam_chunked.run_online_slam(tcfg, tvoc, L, R, chunk=8, device="cpu")
        events = [(q, m) for q, m, _ in res.loop_events]
        traj, kf = res.trajectory, res.keyframes
        assert res.n_corrections == len(events) and res.tracking_ok.all()
    assert events == [(q, m) for q, m, _ in wrapped_scan.loop_events]
    assert int(kf.count) > 2 * KF_SLOTS
    gt = world.poses[:N_FRAMES]
    assert metrics.ate_rmse(traj, gt) < metrics.ate_rmse(wrapped_scan.trajectory_odo, gt)


def test_run_postures_on_uint8_frames(laps, wrapped_detection):
    """The CLI's run_postures on uint8 frames (two laps): StereoSLAM, fed
    the tool's ``x / 255`` frames, accepts the scan's set here (F7 (a)
    shows only at the card's 4,096 frames)."""
    world, L, R, _, tvoc = laps
    tcfg = wrapped_detection[-1][1]
    n = 2 * LAP + 1
    u8 = [(x[:n] * 255).astype(np.uint8) for x in (L, R)]
    out = endurance_run.run_postures(tcfg, tvoc, *u8, world.poses[:n], "cpu", LAP,
                                     streaming=True)
    sets = {k: [tuple(e[:2]) for e in v["loop_events"]] for k, v in out.items()}
    assert list(out) == ["scan", "streaming"] and len(sets["scan"]) >= 2
    assert sets["streaming"] == sets["scan"]
    assert out["scan"]["true_revisit_max_offset"] == 0
    assert out["streaming"]["keyframes_inserted"] > KF_SLOTS


def test_f6_scan_verifies_the_rows_that_overwrote_its_candidates(laps):
    """F6 in both packages: with a 60-frame database over frames 0..90,
    query 72 finds frame 24 (its pose one lap back) while frame 24's row
    is in the ring, and the pair passes the geometric check on those rows;
    by the end of the run frame 84 (a quarter lap on) has overwritten it,
    and the check the scan's epilogue makes then, on slot 24 % 60, fails.
    Both packages' gaters accept the same set without the pair."""
    lcj, lct, rows, per_frame, snap, (jcfg, tcfg) = _detect_both(laps, F6_CAP, F6_FRAMES,
                                                                  snapshot_at=F6_PAIR[0])
    q, m = F6_PAIR
    ids = dict((fid, st[0]) for fid, _, st in per_frame)[q]
    assert ids[0] == m, f"frame {q}'s best candidate is {ids[0]}"
    lcc = tcfg.loop
    snap_t, snap_j = snap

    def port_check(lc):
        n, _, _ = loop_closure._geom_match_many(
            lc.db_bits, lc.db_pts, lc.db_pt_valid, [q], [m], lcc.geom_thresh_px,
            lcc.neigh_ratio, iters=lcc.geom_ransac_iters)
        return int(n[0])

    def jax_check(lc):
        n, _, _ = jlc._geom_match_many(
            lc.db_bits, lc.db_pts, lc.db_pt_valid, jnp.asarray([q]), jnp.asarray([m]),
            jnp.float32(lcc.geom_thresh_px), jnp.float32(lcc.neigh_ratio),
            iters=lcc.geom_ransac_iters)
        return int(np.asarray(n)[0])

    assert int(snap_t.db_ids[m % F6_CAP]) == m
    assert int(lct.db_ids[m % F6_CAP]) == m + F6_CAP  # overwritten after the query
    fresh_t, fresh_j = port_check(snap_t), jax_check(snap_j)
    stale_t, stale_j = port_check(lct), jax_check(lcj)
    assert min(fresh_t, fresh_j) >= lcc.geom_min_points, (fresh_t, fresh_j)
    assert max(stale_t, stale_j) < lcc.geom_min_points, (stale_t, stale_j)
    acc_j = jscan.EpilogueGater(jcfg).process(lcj, *rows["jax"], fid_start=1)
    acc_t = slam_scan.EpilogueGater(tcfg).process(lct, *rows["port"], fid_start=1)
    assert [(a[0], a[1]) for a in acc_t] == [(a[0], a[1]) for a in acc_j]
    assert (q, m) not in [(a[0], a[1]) for a in acc_t]


def _port_orb(img):
    from ros_stereo_slam_tpu_torch.ops import orb

    return orb.detect_and_compute(img, 512, 12.0 / 255.0, n_levels=4)


def test_f7_streaming_frames_are_not_the_steps_frames():
    """F7 (a)'s mechanism, in both packages: the endurance tools feed the
    streaming posture ``x / 255`` (numpy) while the scan and chunked
    drivers scale uint8 frames as ``x * (1/255)`` in float32 inside the
    step.  About a quarter of the pixels differ in the last bit, and ORB
    finds other corners on them, so detection sees other features."""
    from ros_stereo_slam_tpu_torch.models import step

    u8 = endurance_run.render_frames(1, 512, 20.0, 2, True, workers=1)[0][0]  # 620x188
    host = u8.astype(np.float32) / 255.0
    t_step = step._to_unit(torch.from_numpy(u8)).numpy()
    j_step = np.asarray(jnp.asarray(u8).astype(jnp.float32) * (1.0 / 255.0))
    np.testing.assert_array_equal(t_step, j_step)  # the two steps scale alike
    np.testing.assert_allclose(host, t_step, rtol=1.2e-7, atol=0)  # one ulp at most
    assert (host != t_step).mean() > 0.1
    for name, orb_of in (
            ("port", lambda im: _port_orb(torch.from_numpy(im))),
            ("jax", lambda im: jorb.detect_and_compute(jnp.asarray(im), 512, 12.0 / 255.0,
                                                       n_levels=4))):
        a, b = orb_of(host), orb_of(t_step)
        assert not np.array_equal(np.asarray(a.pts), np.asarray(b.pts)), name


# -- the CLI ---------------------------------------------------------------

CLI_ARGS = ["--device", "cpu", "--frames", "16", "--lap", "32", "--radius", "5", "--scale",
            "4"]
NEW_KEYS = {"true_revisit_max_offset", "keyframes_inserted", "keyframe_ring_wraps",
            "bow_inserts", "bow_ring_wraps", "bow_rows_overwritten", "launches",
            "chunked_true_revisit_max_offset", "streaming_true_revisit_max_offset",
            "chunked_keyframe_ring_wraps", "streaming_keyframe_ring_wraps",
            "posture_sets_identical"}


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """One run of every posture: (exit code, output dir, cache dir)."""
    root = tmp_path_factory.mktemp("endurance_cli")
    out, cache = root / "out", root / "cache"
    rc = endurance_run.main(CLI_ARGS + ["--out", str(out), "--cache-dir", str(cache),
                                        "--compare-streaming", "--compare-chunked",
                                        "--frame-cache"])
    return rc, out, cache


def test_cli_writes_the_jax_tools_outputs(cli_run):
    rc, out, cache = cli_run
    summary = json.loads((out / "summary.json").read_text())
    jax_keys = set(json.loads((ROOT / "endurance_jitter" / "summary.json").read_text()))
    assert jax_keys <= set(summary), jax_keys - set(summary)
    assert NEW_KEYS <= set(summary), NEW_KEYS - set(summary)
    assert summary["platform"] == "cpu" and summary["frames"] == 16
    assert summary["resolution"] == "310x94" and summary["db_capacity"] == 4096
    assert summary["postures_run"] == ["scan", "chunked", "streaming"]
    assert rc == (1 if summary["n_loop_closures"] < 3 else 0)
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 15
    assert set(json.loads(lines[0])) == {"frame", "n_inliers", "is_keyframe", "tracking_ok"}
    assert [json.loads(x)["frame"] for x in lines] == list(range(1, 16))
    assert len(list(cache.glob("endurance_frames_16_32_5_4_p.npz"))) == 1
    assert len(list(cache.glob("endurance_vocab_32_5_4_p_512_4_9_6.npz"))) == 1


def test_cli_exit_codes(cli_run, tmp_path, monkeypatch):
    """Exit 1 below 3 closures, 0 at 3 (the cached frames and vocabulary
    loaded); 2 for an absent card."""
    _, _, cache = cli_run
    if not torch.cuda.is_available():
        assert endurance_run.main(["--device", "cuda", "--out", str(tmp_path / "x")]) == 2
        assert not (tmp_path / "x").exists()

    def fake(n_events):
        def run_postures(cfg, voc, left, right, gt, device, lap, **kw):
            F = left.shape[0]
            ev = [(40 + 101 * i, 8 + 101 * i, 50) for i in range(n_events)]
            rep = dict(name="scan", loop_events=[list(e) for e in ev], ate_rmse_m=0.1,
                       true_revisit_max_offset=0 if ev else None, keyframes_inserted=3,
                       keyframe_ring_wraps=0, tracking_ok_fraction=1.0, wall_s=1.0, fps=1.0,
                       launches={}, ate_rmse_odometry_m=0.2,
                       n_inliers=np.zeros(F - 1, int), is_keyframe=np.zeros(F - 1, bool),
                       tracking_ok=np.ones(F - 1, bool))
            kw["on_posture"]({"scan": rep})
            return {"scan": rep}
        return run_postures

    monkeypatch.setattr(endurance_run, "train_vocab", None)  # the cache must serve
    for n, want in ((2, 1), (3, 0)):
        monkeypatch.setattr(endurance_run, "run_postures", fake(n))
        out = tmp_path / f"rc{n}"
        assert endurance_run.main(CLI_ARGS + ["--out", str(out), "--cache-dir", str(cache),
                                              "--frame-cache"]) == want
        assert json.loads((out / "summary.json").read_text())["n_loop_closures"] == n
