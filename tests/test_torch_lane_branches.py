"""Two lanes that see different images: the batched full-SLAM driver on two
exposures of one drive, and the any-lane branches' accounting.

- Lane b of ``run_offline_slam_batched`` over the two exposures the
  benchmark's lane driver gives (``slambench/reference/lanes.py``: lane 0
  as rendered, lane 1 at 0.85) equals ``run_offline_slam`` on lane b's
  frames started from ``lane_keys(seed, 2)[b]``: trajectories, closures,
  loop edges, keyframe flags and keyframe stores, bitwise on the CPU.
  Configuration of tests/test_torch_batched_slam.py (80-frame circular
  revisit, 128 ORB features on 4 levels, detection every 2nd frame, a
  128-frame database), a k = 4, L = 3 vocabulary trained by the port, on
  the uint8 frames of world seed 16, whose revisit both exposures close.
- The rescue and keyframe reads give the count of lanes that ask: the
  ``step.rescue`` and ``step.keyframe`` spans carry ``lanes`` and
  ``asked``, and ``step.LANE_BRANCHES`` sums the runs, lane-slots and
  asked lane-slots of steps of more than one lane, on constructed lanes
  where none, one or both ask; a single-lane step counts nothing there,
  and every step still reads the device twice.
- A graph family counts its calls on lane stacks, which
  ``tools/torch_span_report.py`` reads, and the tool sums the branches'
  lane-slots from the spans.
- The lane driver makes a recording's host stacks once, on the warm-up's
  first frames.
- The cell's configuration, ``kitti_slam_bow_lanes2``, is
  ``kitti_slam_bow`` as the lane driver runs it: the same pipeline
  configuration, and the lanes, gains and ``interleave`` the driver uses.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.config import (
    CameraConfig, FrontendConfig, KeyframeConfig, LoopClosureConfig, PGOConfig,
    preset_loop_closure, preset_odometry,
)
from ros_stereo_slam_tpu_torch.data.synthetic import loop_trajectory, small_world
from ros_stereo_slam_tpu_torch.models import pipeline, slam_scan, step, step_batched
from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
from ros_stereo_slam_tpu_torch.ops import orb
from ros_stereo_slam_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from slambench import drivers  # noqa: E402
from slambench.manifest import Manifest, load  # noqa: E402
from slambench.reference import lanes as lanes_ref  # noqa: E402

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


def _u8(img):
    return np.floor(np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


@pytest.fixture(scope="module")
def revisit():
    """The revisit world's uint8 frames, the port's vocabulary and config."""
    world = small_world(custom_poses=loop_trajectory(N_FRAMES, radius=2.5, overlap=8), seed=16)
    world.half_w = 10.0
    frames = [world.render(i)[:2] for i in range(N_FRAMES)]
    L = np.stack([_u8(f[0]) for f in frames])
    R = np.stack([_u8(f[1]) for f in frames])
    descs, docs = [], []
    for i in range(0, N_FRAMES, 4):
        f = orb.detect_and_compute(torch.from_numpy(L[i]).float() / 255.0, 128)
        v = f.valid.numpy()
        descs.append(f.desc_sign.numpy()[v])
        docs.append(np.full(v.sum(), i))
    voc = vocab_mod.train(np.concatenate(descs), k=4, levels=3, doc_ids=np.concatenate(docs),
                          device="cpu")
    cfg = preset_loop_closure().replace(
        camera=CameraConfig(**vars(world.camera)),
        frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=64, min_pnp_inliers=150, map_block_points=1024),
        loop=LoopClosureConfig(**LOOP),
        pgo=PGOConfig(max_poses=128, max_loop_edges=8, iters=10, cg_iters=64))
    return world, L, R, voc, cfg


def test_lanes_on_two_exposures_match_single_lane(revisit):
    world, L, R, voc, cfg = revisit
    driver = load(ROOT / "slambench" / "entries" / "run_offline_slam_batched.py").Driver(
        cfg, voc, "cpu")
    reads = step.HOST_READS
    lanes = driver.session(L, R)
    assert step.HOST_READS - reads == 2 * (N_FRAMES - 1)  # 2 a frame, whatever B is
    stacks = driver.stacks(L, R)
    assert driver.stacks(L, R) is stacks  # made once for the same frames
    assert [s.shape for s in stacks] == [(B,) + L.shape] * 2
    np.testing.assert_array_equal(stacks[0][0], L)
    np.testing.assert_array_equal(stacks[0][1], (L.astype(np.int64) * 17 + 10) // 20)
    res = slam_scan.run_offline_slam_batched(cfg, voc, *stacks, device="cpu")
    keys = step_batched.lane_keys(cfg.seed, B)
    for b in range(B):
        single = slam_scan.run_offline_slam(cfg.replace(seed=keys[b]), voc, stacks[0][b],
                                            stacks[1][b], device="cpu")
        got = res[b]
        np.testing.assert_array_equal(got.trajectory, single.trajectory)
        np.testing.assert_array_equal(got.trajectory_odo, single.trajectory_odo)
        np.testing.assert_array_equal(got.is_keyframe, single.is_keyframe)
        np.testing.assert_array_equal(got.n_inliers, single.n_inliers)
        assert got.loop_events == single.loop_events, b
        assert [(i, j) for i, j, _ in got.loop_edges] == [(i, j) for i, j, _ in single.loop_edges]
        for (_, _, Z), (_, _, Zs) in zip(got.loop_edges, single.loop_edges):
            np.testing.assert_array_equal(Z, Zs)
        for name, x in got.keyframes._asdict().items():
            assert torch.equal(x, getattr(single.keyframes, name)), (b, name)
        # the driver's session is this run's lane
        np.testing.assert_array_equal(lanes[b].trajectory, got.trajectory)
        assert lanes[b].closures == [(q, m) for q, m, _ in got.loop_events]
        assert got.loop_events, f"lane {b} must close its revisit"
    # the exposures differ where the branches look: the lanes' tracks differ
    assert not np.array_equal(res[0].n_inliers, res[1].n_inliers)


def _odometry_lanes():
    """Two lanes of a small odometry world's frames, float32 in [0, 1]."""
    world = small_world(n_frames=3, seed=7)
    frames = [world.render(i)[:2] for i in range(3)]
    L = np.stack([f[0] for f in frames]).astype(np.float32)
    R = np.stack([f[1] for f in frames]).astype(np.float32)
    cfg = preset_odometry().replace(
        camera=CameraConfig(**vars(world.camera)),
        frontend=FrontendConfig(grid_step=12, max_points=1024))
    return np.stack([L, L]), np.stack([R, R]), cfg


def _branch_spans(fn):
    """Run `fn()` with spans on: its (step.rescue, step.keyframe) spans'
    (lanes, asked), LANE_BRANCHES' change and the host reads made."""
    before = {k: dict(v) for k, v in step.LANE_BRANCHES.items()}
    reads = step.HOST_READS
    profiling.reset()
    with profiling.tracing():
        fn()
    got = {name: [(s.attrs["lanes"], s.attrs["asked"]) for s in profiling.spans()
                  if s.name == name] for name in ("step.rescue", "step.keyframe")}
    delta = {k: {f: step.LANE_BRANCHES[k][f] - before[k][f] for f in v}
             for k, v in before.items()}
    return got, delta, step.HOST_READS - reads


@pytest.mark.parametrize("case,asked", [("none", 0), ("one", 1), ("both", 2)])
def test_the_branches_count_the_lanes_that_ask(case, asked):
    """Frame 1 of two lanes.  A cold velocity prior sends a lane to the
    rescue; a lane whose scene stands still, with a warm zero-motion prior,
    asks for nothing.  "none": both lanes still and warm; "one": lane 0
    moves from a cold prior, lane 1 still and warm; "both": both move from
    a cold prior.  The keyframe trigger (every lane below 10,000 PnP
    inliers) makes every lane ask for the keyframe branch in each case."""
    L, R, cfg = _odometry_lanes()
    if case != "both":
        L[1], R[1] = L[1, :1], R[1, :1]
    if case == "none":
        L[0], R[0] = L[0, :1], R[0, :1]
    cfg = cfg.replace(keyframes=dataclasses.replace(cfg.keyframes, min_pnp_inliers=10_000))
    gp, gm = pipeline._grid_for(cfg, "cpu")
    Lt, Rt = torch.from_numpy(L), torch.from_numpy(R)
    c0 = step.init_carry_batched(Lt[:, 0], Rt[:, 0], gp, gm, step_batched.lane_keys(0, B), cfg)
    c0 = c0._replace(dT_valid=torch.tensor([case == "none", case != "both"]))
    got, delta, reads = _branch_spans(
        lambda: step_batched.slam_frame_step_batched(c0, Lt[:, 1], Rt[:, 1], gp, gm, cfg))
    assert reads == 2
    assert got["step.rescue"] == ([(B, asked)] if asked else [])
    assert delta["rescue"] == ({"runs": 1, "lanes": B, "asked": asked} if asked
                               else {"runs": 0, "lanes": 0, "asked": 0})
    assert got["step.keyframe"] == [(B, B)]
    assert delta["keyframe"] == {"runs": 1, "lanes": B, "asked": B}


def test_a_single_lane_step_counts_no_lane_slots():
    L, R, cfg = _odometry_lanes()
    gp, gm = pipeline._grid_for(cfg, "cpu")
    Lt, Rt = torch.from_numpy(L[0]), torch.from_numpy(R[0])
    c0 = step.init_carry(Lt[0], Rt[0], gp, gm, 0, cfg)  # a cold prior: the rescue runs
    rescues = step.RESCUES
    got, delta, reads = _branch_spans(
        lambda: step.slam_frame_step(c0, Lt[1], Rt[1], gp, gm, cfg))
    assert reads == 2 and step.RESCUES - rescues == 1
    assert got["step.rescue"] == [(1, 1)]
    assert all(v == 0 for d in delta.values() for v in d.values())


def test_the_span_tool_counts_lane_stacked_calls_and_branch_slots():
    """A graph family counts its calls on lane stacks (PnP's (B, N) masks,
    ORB's image stack) and the replays among them;
    ``tools/torch_span_report.py`` reads those counters and sums each
    branch's lane-slots from the session's spans."""
    import importlib.util

    from ros_stereo_slam_tpu_torch.utils import cuda_graph
    from ros_stereo_slam_tpu_torch.utils.profiling import Span

    spec = importlib.util.spec_from_file_location("torch_span_report",
                                                  ROOT / "tools" / "torch_span_report.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    before = tool.graph_counts()
    for lanes in (2, 1, 3):
        cuda_graph.PNP(lambda mask: mask.sum(), mask=torch.zeros(lanes, 4, dtype=torch.bool))
    cuda_graph.ORB(lambda img: img.sum(), img=torch.zeros(2, 8, 8))
    cuda_graph.ORB(lambda img: img.sum(), img=torch.zeros(8, 8))
    got = tool.graph_solves(before, tool.graph_counts(), {})
    assert {k: (v["lane_stacked_calls"], v["lane_stacked_replays"]) for k, v in got.items()} == {
        "pnp": (2, 0), "orb": (1, 0), "ba": (0, 0)}  # eager on the CPU
    spans = [Span(name, 0, 1, i, 1, attrs) for i, (name, attrs) in enumerate((
        ("step.keyframe", {"lanes": 2, "asked": 2}), ("step.keyframe", {"lanes": 2, "asked": 1}),
        ("step.rescue", {"lanes": 1, "asked": 1}), ("step.keyframe", {"lanes": 2, "asked": 1})))]
    assert tool.lane_branches(spans) == {
        "rescue": {"runs": 0, "lanes": 0, "asked": 0, "idle_pct": None},
        "keyframe": {"runs": 3, "lanes": 6, "asked": 4, "idle_pct": 100.0 * 2 / 6}}


def test_the_driver_makes_a_recordings_stacks_once(revisit):
    """The lane driver's host stacks of a recording are made on its first
    frames' session (the warm-up's) and kept for the whole recording."""
    _, L, R, voc, cfg = revisit
    driver = load(ROOT / "slambench" / "entries" / "run_offline_slam_batched.py").Driver(
        cfg, voc, "cpu")
    warm = driver.stacks(L[:10], R[:10])
    full = driver.stacks(L, R)
    assert [s.shape for s in warm] == [(B, 10) + L.shape[1:]] * 2
    assert all(np.shares_memory(w, f) for w, f in zip(warm, full))
    assert all(a is b for a, b in zip(driver.stacks(L, R), full))
    np.testing.assert_array_equal(full[1][1], lanes_ref.lane_frames(R, 1).numpy())
    other = driver.stacks(L.copy(), R.copy())  # another recording: made anew
    assert not np.shares_memory(other[0], full[0])


def test_the_lanes_configuration_is_kitti_slam_bow_as_the_driver_runs_it(monkeypatch):
    man = Manifest(ROOT)
    cell = man.cell("slam.revisit.lanes2")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "kitti_slam_bow_lanes2", "revisit_lanes2", 1)
    conf, single, mix = man.config(cell["config"]), man.config("kitti_slam_bow"), man.traffic(
        cell["traffic"])
    assert mix["driver"] == "run_offline_slam_batched"
    stated = {"name", "source", "deployment", "lanes", "lane_gains", "interleave", "overrides",
              "assumed"}
    assert {k: v for k, v in conf.items() if k not in stated} == {
        k: v for k, v in single.items() if k not in stated}
    assert conf["assumed"][:len(single["assumed"])] == single["assumed"]
    cfg = drivers.pipeline_config(conf, mix.get("overrides", {}), 7)
    assert cfg == drivers.pipeline_config(single, mix.get("overrides", {}), 7)
    assert cfg.keyframes.batch_align_window == 1
    assert tuple(tuple(g) for g in conf["lane_gains"]) == lanes_ref.GAINS
    driver = load(ROOT / "slambench" / "entries" / "run_offline_slam_batched.py").Driver(
        cfg, None, "cpu")
    assert driver.lanes == conf["lanes"]
    seen = {}

    def run_offline_slam_batched(cfg, voc, left, right, **kwargs):
        seen.update(kwargs, lanes=left.shape[0])
        return []

    monkeypatch.setattr(slam_scan, "run_offline_slam_batched", run_offline_slam_batched)
    frames = np.zeros((2, 4, 6), np.uint8)
    assert driver.session(frames, frames) == []
    assert seen == {"device": "cpu", "interleave": conf["interleave"], "lanes": conf["lanes"]}
