"""The program's spans (``utils/profiling.py``): off by default and cheap,
recording under a ``torch.profiler`` capture or ``profiling.tracing()``,
nested with their parents, bounded, on the clock of the profiler's
events, and placed at the layer boundaries of the drivers.

The file imports nothing of JAX, so its ``cuda`` test runs on the GPU
host: ``python -m pytest tests/test_torch_profiling.py -m cuda
--noconftest -q -s``.  The world of the SLAM run is the port's slice
tests' (80 frames of a loop at 620x188 that closes at frame 72).
"""

import statistics
import time

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.config import (
    CameraConfig, FrontendConfig, KeyframeConfig, LoopClosureConfig, PGOConfig,
    preset_loop_closure,
)
from ros_stereo_slam_tpu_torch.data.synthetic import loop_trajectory, small_world
from ros_stereo_slam_tpu_torch.models import pipeline, slam_scan
from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
from ros_stereo_slam_tpu_torch.ops import orb
from ros_stereo_slam_tpu_torch.utils import profiling

N_FRAMES = 80
LOOP = dict(orb_features=128, dislocal=8, min_separation=30, cooldown=10, max_db_results=12,
            k_consistency=1, geom_min_points=12, db_capacity=128, alpha=0.3, min_nss=0.001)


@pytest.fixture(autouse=True)
def _fresh_spans():
    profiling.reset(profiling.CAPACITY)
    yield
    profiling.reset(profiling.CAPACITY)


def _median_ns(fn, n: int) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter_ns()
        fn()
        times.append(time.perf_counter_ns() - t0)
    return statistics.median(times)


def _one_span():
    with profiling.span("x", frame=1):
        pass


def test_spans_off_record_nothing_and_cost_little():
    off = _median_ns(_one_span, 100_000)
    assert profiling.spans() == [] and profiling.summary() == {}
    with profiling.tracing():
        on = _median_ns(_one_span, 100_000)
    assert len(profiling.spans()) == profiling.CAPACITY and profiling.dropped() == 100_000 - \
        profiling.CAPACITY
    assert profiling.summary()["x"]["calls"] == 100_000
    print(f"span cost: off {off:.0f} ns, on {on:.0f} ns (median of 1e5, timer included)")
    assert off < 20_000


def test_spans_nest_under_a_profiler_capture():
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("driver.session", frames=2):
            for fid in (1, 2):
                with profiling.span("step.frame", frame=fid):
                    with profiling.span("step.track") as sp:
                        sp.set(points=fid)
                    profiling.annotate(lanes=1)
    with profiling.span("after"):  # the capture has ended
        pass
    got = profiling.spans()
    by = {(s.name, s.attrs.get("frame")): s for s in got}
    sess = by[("driver.session", None)]
    assert [s.name for s in got] == ["step.track", "step.frame"] * 2 + ["driver.session"]
    assert sess.parent is None and sess.attrs == {"frames": 2}
    for fid in (1, 2):
        frame = by[("step.frame", fid)]
        assert frame.parent == sess.id and frame.attrs == {"frame": fid, "lanes": 1}
        track = [s for s in got if s.name == "step.track" and s.parent == frame.id]
        assert len(track) == 1 and track[0].attrs == {"points": fid}
        assert frame.start_ns <= track[0].start_ns <= track[0].end_ns <= frame.end_ns
    s = profiling.summary()
    assert s["step.frame"]["calls"] == 2
    assert set(s["step.frame"]) == {"total_s", "calls", "mean_ms", "self_ms"}
    assert s["driver.session"]["self_ms"] <= s["driver.session"]["total_s"] * 1e3 + 0.05

    profiling.reset(capacity=8)
    with profiling.tracing():
        for _ in range(20):
            _one_span()
    assert len(profiling.spans()) == 8 and profiling.dropped() == 12
    assert profiling.summary()["x"]["calls"] == 20


def _recorded(name, t0_ms, t1_ms, sid, parent):
    return profiling.Span(name, t0_ms * 1_000_000, t1_ms * 1_000_000, sid, parent, {})


def test_per_frame_reads_each_layer_of_a_recorded_session():
    """A 96 ms session over two frames holding two frame steps (26 + 20
    ms), one detection (10 ms) and the epilogue (20 ms), so 20 ms are the
    driver's own; the host waits 2 + 1 + 4 + 1 ms on reads; a detection
    nested deeper than the session's children is no layer of its own."""
    got = [_recorded(*s) for s in (
        ("host_read", 10, 12, 2, 1), ("step.pnp", 12, 20, 3, 1), ("step.frame", 4, 30, 1, 0),
        ("detect.orb", 31, 35, 5, 4), ("detect.frame", 30, 40, 4, 0),
        ("host_read", 60, 61, 7, 6), ("step.frame", 50, 70, 6, 0),
        ("detect.frame", 62, 64, 12, 6),
        ("host_read", 80, 84, 9, 8), ("epilogue", 75, 95, 8, 0),
        ("host_read", 96, 97, 10, 0), ("driver.session", 2, 98, 0, None))]
    assert profiling.per_frame(got, 2) == pytest.approx({
        "driver.session": 48.0, "step.frame": 23.0, "detect.frame": 5.0, "epilogue": 10.0,
        "driver.self": 10.0, "host_read": 4.0}, rel=1e-12)
    assert profiling.per_frame(got[:-1], 2) == {} and profiling.per_frame([], 0) == {}


def test_a_span_holds_the_profiler_event_it_issued():
    """The shared clock: under a capture of the host's ops,
    ``slambench.trace.reduce`` puts ``aten::mm`` in its host ops inside
    the span around ``x @ x``, within 1 ms of each end."""
    from slambench import trace

    x = torch.randn(64, 64)
    x @ x
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t0 = time.time_ns()
        with profiling.span("mm"):
            x @ x
        session = (trace.SESSION_SPAN, t0, time.time_ns())
    rec = trace.reduce(prof.profiler.kineto_results.events(), [session])
    sp, = [s for s in profiling.spans(*rec["window_ns"]) if s.name == "mm"]
    mm = [(t0, t0 + d) for name, t0, d in rec["host_ops"] if name == "aten::mm"]
    assert len(mm) == 1
    lead, lag = mm[0][0] - sp.start_ns, sp.end_ns - mm[0][1]
    print(f"aten::mm starts {lead} ns after its span and ends {lag} ns before its end")
    assert 0 <= lead <= 1_000_000 and 0 <= lag <= 1_000_000


@pytest.fixture(scope="module")
def world():
    """The slice tests' loop world, configuration and a k=4 L=3 vocabulary
    trained by the port on every 4th frame."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    w = small_world(custom_poses=loop_trajectory(N_FRAMES, radius=2.5, overlap=8), seed=13)
    w.half_w = 10.0
    frames = [w.render(i)[:2] for i in range(N_FRAMES)]
    L = np.stack([f[0] for f in frames]).astype(np.float32)
    R = np.stack([f[1] for f in frames]).astype(np.float32)
    descs, docs = [], []
    for i in range(0, N_FRAMES, 4):
        f = orb.detect_and_compute(torch.from_numpy(L[i]), 128)
        v = f.valid.numpy()
        descs.append(f.desc_sign.numpy()[v])
        docs.append(np.full(v.sum(), i))
    voc = vocab_mod.train(np.concatenate(descs), k=4, levels=3, doc_ids=np.concatenate(docs),
                          device="cpu")
    cfg = preset_loop_closure().replace(
        camera=CameraConfig(**vars(w.camera)),
        frontend=FrontendConfig(grid_step=12, max_points=1024),
        keyframes=KeyframeConfig(max_keyframes=64, min_pnp_inliers=150, map_block_points=1024),
        loop=LoopClosureConfig(**LOOP),
        pgo=PGOConfig(max_poses=128, max_loop_edges=8, iters=10, cg_iters=64))
    yield L, R, voc, cfg
    torch.set_num_threads(n)


def _children(got, parent):
    return [s for s in got if s.parent == parent.id]


def test_run_offline_slam_spans_each_layer(world):
    L, R, voc, cfg = world
    with profiling.tracing():
        res = slam_scan.run_offline_slam(cfg, voc, L, R, device="cpu")
    got = profiling.spans()
    assert profiling.dropped() == 0 and res.loop_events
    sess, = [s for s in got if s.name == "driver.session"]
    assert sess.attrs == {"driver": "run_offline_slam", "frames": N_FRAMES, "lanes": 1}
    steps = [s for s in got if s.name == "step.frame"]
    assert [s.attrs["frame"] for s in steps] == list(range(N_FRAMES))
    detects = [s for s in got if s.name == "detect.frame"]
    assert [s.attrs["frame"] for s in detects] == list(range(0, N_FRAMES, cfg.loop.detect_every))
    for d in detects[1:]:
        assert {s.name for s in _children(got, d)} == {"detect.orb", "detect.bow",
                                                       "detect.query", "detect.insert"}
    epi, = [s for s in got if s.name == "epilogue"]
    assert epi.attrs == {"closures": len(res.loop_events)}
    assert {s.name for s in _children(got, epi)} == {"epilogue.gates", "epilogue.geom",
                                                     "epilogue.edges", "epilogue.pgo",
                                                     "epilogue.rewrite"}
    pgo, = [s for s in got if s.name == "epilogue.pgo"]
    assert pgo.attrs["gn_iters"] == cfg.pgo.iters
    assert pgo.attrs["cg_steps"] == cfg.pgo.iters * cfg.pgo.cg_iters
    assert pgo.attrs["poses"] == N_FRAMES and pgo.attrs["loop_edges"] == len(res.loop_edges)
    # the frame step, detection and the epilogue are siblings under the
    # session, in time order and apart; the rest of the session is the
    # driver's own
    top = sorted(steps + detects + [epi], key=lambda s: s.start_ns)
    assert all(s.parent == sess.id for s in top)
    assert all(a.end_ns <= b.start_ns for a, b in zip(top, top[1:]))
    assert sess.start_ns <= top[0].start_ns and top[-1].end_ns <= sess.end_ns
    per = profiling.per_frame(got, N_FRAMES)
    assert set(per) == {"driver.session", "driver.self", "host_read", *profiling.LAYERS}
    assert all(v > 0 for v in per.values()), per
    assert sum(per[n] for n in (*profiling.LAYERS, "driver.self")) == pytest.approx(
        per["driver.session"], rel=1e-9)
    reads = [s for s in got if s.name == "host_read"]
    sites = {s.attrs["site"] for s in reads}
    assert {"step.keyframe", "slam.stats", "epilogue.geom", "epilogue.edges",
            "epilogue.pgo"} <= sites
    assert sum(s.attrs["site"] == "step.keyframe" for s in reads) == N_FRAMES - 1
    rescues = [s for s in got if s.name == "step.rescue"]
    assert sum(s.attrs["site"] == "step.rescue" for s in reads) == N_FRAMES - 1
    assert all(s.parent in {f.id for f in steps} for s in rescues)


def test_run_offline_spans_no_detection_or_epilogue(world):
    L, R, _, cfg = world
    with profiling.tracing():
        pipeline.run_offline(cfg, L[:6], R[:6], device="cpu")
    names = {s.name for s in profiling.spans()}
    assert {"driver.session", "step.frame", "step.track", "step.pnp", "host_read"} <= names
    assert not any(n.startswith(("detect.", "epilogue")) for n in names)
    per = profiling.per_frame(profiling.spans(), 6)
    assert set(per) == {"driver.session", "driver.self", "host_read", "step.frame"}


@pytest.mark.cuda
def test_a_span_holds_its_kernel_launch_on_the_card():
    """A span around one K1 call holds the launch call the capture records,
    and the kernel starts on the device no earlier than the span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from torch.autograd import DeviceType

    from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((376, 1241), dtype=np.float32)).to(dev)
    pts = torch.from_numpy(np.stack([rng.uniform(40, 1200, 768), rng.uniform(40, 336, 768)], 1)
                           .astype(np.float32)).to(dev)
    params = lk.LKParams(window=15, iters=6, walk_iters=6)
    lk_cuda.track_level(img, img, pts, pts, params)  # builds and loads K1
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("k1"):
            lk_cuda.track_level(img, img, pts, pts, params)
        torch.cuda.synchronize()
    sp, = [s for s in profiling.spans() if s.name == "k1"]
    evs = list(prof.profiler.kineto_results.events())
    launches = [e for e in evs if "LaunchKernel" in e.name()
                and sp.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= sp.end_ns]
    kernels = [e for e in evs if e.device_type() == DeviceType.CUDA and "lk_level" in e.name()]
    assert len(launches) == 1 and len(kernels) == 1, [e.name() for e in evs]
    k0 = kernels[0].start_ns()
    print(f"K1: launch {launches[0].name()} at span + {launches[0].start_ns() - sp.start_ns} ns, "
          f"span {sp.end_ns - sp.start_ns} ns; kernel on the device at span + "
          f"{k0 - sp.start_ns} ns for {kernels[0].duration_ns()} ns")
    assert k0 >= sp.start_ns
