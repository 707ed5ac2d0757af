#!/usr/bin/env python3
"""Where the host time of a benchmark cell's session goes, span by span.

    python3 tools/torch_span_report.py --workload slam.revisit.offline \
        --seed 5400000011 [--seed ...] [--overhead 2] [--syncs] [--out DIR]

from the root of a checkout, on the card (``--device cpu``, without
``--syncs``, rehearses it on a checkout whose configurations are cut
small, as ``slambench/tests/conftest.py::small_root`` cuts them).  Per seed it makes
the cell's set-up (``slambench.run.Setup``: frames, vocabulary, warm-up),
then one session under the benchmark's own traced path
(``Setup.measure(traced=True)``: the ``torch.profiler`` capture, which
turns the program's spans on, and the kernel-call recorder), and from the
program's spans (``ros_stereo_slam_tpu_torch/utils/profiling.py``)
inside the session it prints, and writes to ``DIR/<workload>.<seed>.json``
(``--out``, default ``runs/spans``):

- per span name: calls, total and self host time in ms a frame, and the
  device's idle time inside the self time (every moment charged to the
  innermost span open then, on the capture's clock), ms a frame and %;
- the host time a frame of each layer (``slambench/spans.py::per_frame``,
  the benchmark's own arithmetic: the frame step, detection, the
  epilogue, the driver's own, the reads of the device), the session window
  a frame, and the two sums they must meet (layers to the
  ``driver.session`` span, that to the window);
- the benchmark's per-layer metrics of the cell but the kernels' rooflines;
- per CUDA-graph family (``utils/cuda_graph.py``: ``pnp``, ``ba``,
  ``orb``): graphs captured in the set-up and in the session, the
  session's replays, eager solves and solves (for ``orb``, corner stages),
  the session's calls of the family's span (``step.pnp``, ``step.ba``,
  ``detect.orb``), and the share of solves replayed; for BA
  also the Gauss-Newton iterations (``models/bundle_adjust.py``'s
  ``ITERATIONS``) and the iterations a solve.  A BA replay records no
  ``ba.*`` span: on the card those rows appear only in a session that
  captured; also the session's calls on lane stacks (more than one lane,
  ``lane_calls`` for ``pnp`` and ``orb``) and the share of them replayed;
- per any-lane branch of the frame step (``rescue``, ``keyframe``), from
  the session's ``step.rescue`` and ``step.keyframe`` spans: the runs with
  more than one lane, the lane-slots they ran and the lane-slots that
  asked;
- ``--overhead n``: n pairs of sessions under the same capture without
  the recorder, one with spans on and one with them forced off, and each
  session's seconds;
- ``--syncs``: one more session (no capture, spans on) with
  ``torch.cuda``'s sync debug mode warning on every synchronizing call:
  each call site (the innermost line of the program) with its count and
  whether a ``host_read`` span held it.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import sys
import time
import traceback
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

NO_SPAN = "(no span)"
# the span around each graph family's calls
FAMILY_SPANS = {"pnp": "step.pnp", "ba": "step.ba", "orb": "detect.orb"}


def _busy_before(busy: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Device-busy ns before each time in `t` (merged, sorted `busy`)."""
    if len(busy) == 0:
        return np.zeros(len(t), np.int64)
    starts, ends = busy[:, 0], busy[:, 1]
    cum = np.concatenate([[0], np.cumsum(ends - starts)])
    j = np.searchsorted(starts, t, side="right")  # intervals starting at or before t
    k = np.maximum(j - 1, 0)
    return np.where(j > 0, cum[k] + np.minimum(t, ends[k]) - starts[k], 0)


def innermost(spans: list, busy: np.ndarray, lo: int, hi: int) -> dict:
    """{name: [self ns, idle ns]}: every moment of [lo, hi] charged to the
    innermost span open then (NO_SPAN where none is)."""
    depth: dict = {}
    by_id = {s.id: s for s in spans}
    for s in spans:
        d, p = 0, s.parent
        while p in by_id:
            d, p = d + 1, by_id[p].parent
        depth[s.id] = d
    # at one time: ends (innermost first) before starts (outermost first)
    ev = sorted([(s.end_ns, 0, -depth[s.id], s) for s in spans]
                + [(s.start_ns, 1, depth[s.id], s) for s in spans], key=lambda e: e[:3])
    times, owners, stack, t_prev = [], [], [], lo
    for t, kind, _, s in ev:
        t = min(max(t, lo), hi)
        if t > t_prev:
            times.append((t_prev, t))
            owners.append(stack[-1].name if stack else NO_SPAN)
            t_prev = t
        if kind:
            stack.append(s)
        else:
            stack.remove(s)
    if hi > t_prev:
        times.append((t_prev, hi))
        owners.append(NO_SPAN)
    seg = np.asarray(times, np.int64).reshape(-1, 2)
    covered = _busy_before(busy, seg[:, 1]) - _busy_before(busy, seg[:, 0])
    out: dict = collections.defaultdict(lambda: [0, 0])
    for name, (a, b), c in zip(owners, seg, covered):
        out[name][0] += int(b - a)
        out[name][1] += int(b - a - c)
    return dict(out)


def report(st, got: dict, frames: int) -> dict:
    from ros_stereo_slam_tpu_torch.utils import profiling
    from slambench import spans as layer_spans

    lo, hi = got["window_ns"]
    spans = profiling.spans(lo, hi)
    calls, total = collections.Counter(), collections.Counter()
    for s in spans:
        calls[s.name] += 1
        total[s.name] += s.end_ns - s.start_ns
    own = innermost(spans, got["busy"], lo, hi)
    per = 1e-6 / frames
    rows = {name: {"calls": calls.get(name, 0), "total_ms": total.get(name, 0) * per,
                   "self_ms": ns * per, "idle_ms": idle * per,
                   "idle_pct": 100.0 * idle / ns if ns else None}
            for name, (ns, idle) in sorted(own.items(), key=lambda kv: -kv[1][0])}
    rec = {"trace": got, "spans": got["spans"], "frames": frames, "k1_work": []}
    metrics = {m["name"]: st.man.reader(m["name"])(rec)
               for m in st.man.metrics(st.cell["name"], "per_layer")
               if not m["name"].endswith("_roofline_pct")}
    layers = layer_spans.per_frame(spans, frames)
    session_ms = layers.get("driver.session", 0.0)
    summed = sum(layers.get(n, 0.0) for n in (*layer_spans.LAYERS, "driver.self"))
    return {"frames": frames, "spans": len(spans), "dropped": profiling.dropped(),
            "spans_per_frame": len(spans) / frames, "rows": rows, "metrics": metrics,
            "layers_ms": layers, "window_ms": got["window_s"] * 1e3 / frames,
            "layers_over_session": summed / session_ms if session_ms else None,
            "session_over_window": session_ms / (got["window_s"] * 1e3 / frames)}


def graph_counts() -> dict:
    """Every graph family's counters, and BA's iterations asked for."""
    from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba
    from ros_stereo_slam_tpu_torch.utils import cuda_graph

    out = {name: {"captures": f.captures, "replays": f.replays, "eager": f.eager,
                  "lane_calls": f.lane_calls, "lane_replays": f.lane_replays}
           for name, f in cuda_graph.FAMILIES.items()}
    out["ba"]["iterations"] = ba.ITERATIONS
    return out


def graph_solves(before: dict, after: dict, rows: dict) -> dict:
    """Each family's solves in the session, from the counters before and
    after it."""
    out = {}
    for name, b in before.items():
        d = {k: after[name][k] - v for k, v in b.items()}
        solves = d["replays"] + d["eager"]
        span = FAMILY_SPANS[name]
        out[name] = {"solves": solves,
                     f"{span.replace('.', '_')}_calls": rows.get(span, {}).get("calls", 0),
                     "captures_before_session": b["captures"], "captures_session": d["captures"],
                     "replays": d["replays"], "eager_solves": d["eager"],
                     "replayed_share": d["replays"] / solves if solves else None}
        if "lane_calls" in d:
            calls = d["lane_calls"]
            out[name].update(lane_stacked_calls=calls, lane_stacked_replays=d["lane_replays"],
                             lane_stacked_replayed_share=d["lane_replays"] / calls if calls
                             else None)
        if "iterations" in d:
            out[name].update(iterations=d["iterations"],
                             iterations_per_solve=d["iterations"] / solves if solves else None)
    return out


def lane_branches(spans) -> dict:
    """Each any-lane branch's runs of more than one lane in `spans`
    (``step.rescue``, ``step.keyframe`` with their ``lanes`` and
    ``asked``), the lane-slots they ran and those that asked, and the
    share of lane-slots that did not ask."""
    out = {}
    for name in ("rescue", "keyframe"):
        runs = [s.attrs for s in spans
                if s.name == f"step.{name}" and s.attrs.get("lanes", 1) > 1]
        lanes, asked = sum(r["lanes"] for r in runs), sum(r["asked"] for r in runs)
        out[name] = {"runs": len(runs), "lanes": lanes, "asked": asked,
                     "idle_pct": 100.0 * (lanes - asked) / lanes if lanes else None}
    return out


def captured_session(st) -> float:
    """One session under the benchmark's capture (no recorder); seconds."""
    from slambench import drivers, trace

    drivers.synchronize(st.device)
    cap = trace.Capture()
    cap.start()
    with cap.span(trace.SESSION_SPAN):
        st.driver.session(st.left, st.right)
        drivers.synchronize(st.device)
    return cap.stop()["window_s"]


@contextlib.contextmanager
def spans_forced_off():
    from ros_stereo_slam_tpu_torch.utils import profiling

    span, annotate = profiling.span, profiling.annotate
    profiling.span = lambda name, **attrs: profiling._OFF
    profiling.annotate = lambda **attrs: None
    try:
        yield
    finally:
        profiling.span, profiling.annotate = span, annotate


def overhead(st, pairs: int) -> dict:
    on, off = [], []
    for _ in range(pairs):
        on.append(captured_session(st))
        with spans_forced_off():
            off.append(captured_session(st))
    return {"on_s": on, "off_s": off}


def syncs(st) -> list:
    """Synchronizing calls of one session: [site, caller, held by a
    host_read span, count a session]."""
    import torch

    from ros_stereo_slam_tpu_torch.utils import profiling

    pkg = str(ROOT / "ros_stereo_slam_tpu_torch")
    found: collections.Counter = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        frames = [f for f in traceback.extract_stack() if f.filename.startswith(pkg)]
        where = [f"{os.path.relpath(f.filename, ROOT)}:{f.lineno} {f.name}" for f in frames[-2:]]
        held = any(o.name == "host_read" for o in profiling._open)
        found[(where[-1] if where else filename, where[0] if len(where) > 1 else "", held)] += 1

    with warnings.catch_warnings(), profiling.tracing():
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.set_sync_debug_mode("warn")
        try:
            st.driver.session(st.left, st.right)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [[site, caller, held, n] for (site, caller, held), n in found.most_common()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    ap.add_argument("--overhead", type=int, default=0)
    ap.add_argument("--syncs", action="store_true")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="runs/spans")
    args = ap.parse_args(argv)
    from slambench import drivers, run
    from ros_stereo_slam_tpu_torch.utils import profiling

    os.makedirs(args.out, exist_ok=True)
    for seed in args.seed:
        t0 = time.perf_counter()
        st = run.Setup(run.parse(["--workload", args.workload, "--seed", str(seed),
                                  "--seconds", "0", "--trace", "1"]), args.device, ROOT)
        profiling.reset()
        before = graph_counts()
        window, _, got, _, _ = st.measure(0.0, traced=True)
        frames = len(drivers.flatten(window.sessions[:1])) * len(st.frames)
        out = {"workload": args.workload, "seed": seed, "card": run.smi_line(),
               **report(st, got, frames)}
        out.update(graph_solves(before, graph_counts(), out["rows"]))
        out["lane_branches"] = lane_branches(got["spans"])
        if args.overhead:
            out["overhead"] = overhead(st, args.overhead)
        if args.syncs:
            out["syncs"] = syncs(st)
        out["seconds"] = time.perf_counter() - t0
        with open(Path(args.out) / f"{args.workload}.{seed}.json", "w") as f:
            json.dump(out, f, indent=1, default=str)
        print(json.dumps({k: v for k, v in out.items() if k not in ("rows", "syncs")}))
        for name, r in out["rows"].items():
            print(f"  {name:24s} calls {r['calls']:6d}  total {r['total_ms']:9.3f}  self "
                  f"{r['self_ms']:9.3f}  idle {r['idle_ms']:9.3f} ms/frame "
                  f"({r['idle_pct'] or 0:.1f} %)")
        for row in out.get("syncs", []):
            print("  sync", row)
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
