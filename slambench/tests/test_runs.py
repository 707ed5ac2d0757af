"""Whole runs of each cell on the CPU at the small camera: the last line,
the faults and the control that must make ``correct`` false, and a cell
and a metric added by files and manifest entries alone."""

import json

import pytest

from slambench import faults, run
from slambench.tests.conftest import ROOT, small_root

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]
# A seed whose small revisit world closes a loop, at (60, 0): the
# closure and pose-graph faults need one to alter.
SEED = 2**33 + 16
# Limits at the small camera, above what sound small runs read (the card's
# limits are the cells' own files).
SMALL = {"odo.corridor.offline": {"ate_session_max_m": 1.0, "step_err_p50_m": 0.3,
                                  "k1_gap_px": 0.01, "k1_ok_flips": 0.01},
         "slam.revisit.offline": {"step_err_p50_m": 0.3,
                                  "pgo_cost_left": 0.01,
                                  "k1_gap_px": 0.01, "k1_ok_flips": 0.01,
                                  "k2_bits_differ": 0.01, "k2_corner_bits_max": 16}}


def _run(tmp_path, capsys, cell, trace=0, seconds=1.0, fault=None, root=None):
    root = root or small_root(tmp_path, SMALL)
    args = run.parse(["--workload", cell, "--seed", str(SEED), "--seconds", str(seconds),
                      "--trace", str(trace)])
    assert run.run(args, "cpu", root=root, faults=fault) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    return json.loads(line)


@pytest.mark.parametrize("cell,seconds", [("odo.corridor.offline", 1.0),
                                          ("slam.revisit.offline", 1.0)])
def test_a_run_prints_its_last_line(tmp_path, capsys, cell, seconds):
    out = _run(tmp_path, capsys, cell, seconds=seconds)
    assert list(out) == KEYS[:4] + ["device", "checks"]
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and 0 <= out["failed"] <= out["attempted"]
    assert set(out["metrics"]) == {"fps", "setup_s"}
    assert all(set(v) == {"value", "unit"} for v in out["metrics"].values())
    assert set(out["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in out["checks"].values())


def test_a_traced_run_prints_the_layers_and_a_breakdown(tmp_path, capsys):
    out = _run(tmp_path, capsys, "odo.corridor.offline", trace=1)
    assert list(out) == ["correct", "attempted", "failed", "metrics", "breakdown", "device",
                         "checks"]
    assert {"launches_per_frame.offline", "device_idle_pct.offline"} <= set(out["metrics"])
    assert "k1_roofline_pct" not in out["metrics"]  # no kernel on the CPU: nothing to read
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell,fault,number", [
    ("odo.corridor.offline", "state_unchanged", "step_err_p50_m"),
    ("odo.corridor.offline", "poses_half", "poses_missing"),
    ("odo.corridor.offline", "k1_half", "k1_gap_px"),
    ("odo.corridor.offline", "k1_altered", "k1_gap_px"),
    ("slam.revisit.offline", "state_unchanged", "step_err_p50_m"),
    ("slam.revisit.offline", "poses_half", "poses_missing"),
    ("slam.revisit.offline", "k2_altered", "k2_corner_bits_max"),
    ("slam.revisit.offline", "k3_altered", "k3_words_differ"),
    ("slam.revisit.offline", "closure_altered", "closures_off_revisit"),
    ("slam.revisit.offline", "pgo_skipped", "pgo_cost_left"),
])
def test_a_fault_under_the_timed_path_is_not_correct(tmp_path, capsys, monkeypatch, cell, fault,
                                                     number):
    out = _run(tmp_path, capsys, cell, fault=lambda: faults.PLANTS[fault](monkeypatch))
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path, capsys):
    root = small_root(tmp_path, SMALL)
    d = root / "slambench"
    mix = json.loads((d / "traffic" / "corridor_closed.json").read_text())
    mix["world"]["frames"] = 9
    (d / "traffic" / "corridor_short.json").write_text(json.dumps(mix))
    (d / "cells" / "odo.short.offline.json").write_text(
        (d / "cells" / "odo.corridor.offline.json").read_text())
    (d / "metrics" / "frames_traced.py").write_text(
        "def read(rec):\n    return float(rec['frames'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "odo.short.offline", "config": "kitti_odometry",
                              "traffic": "corridor_short", "chips": 1, "why": "a short drive"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "odo.corridor.offline" in m.get("workloads", []):
            m["workloads"].append("odo.short.offline")
    bench["per_layer"].append({"name": "frames_traced", "unit": "frames", "better": "higher",
                               "source": "host_clock", "layer": "frame step", "moves": "fps",
                               "workloads": ["odo.short.offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = _run(tmp_path, capsys, "odo.short.offline", trace=1, root=root)
    assert out["metrics"]["frames_traced"]["value"] == 9.0
    assert out["attempted"] % 9 == 0


TWO_LANES = '''"""Two lanes of ``run_offline``, each a drive of the mix's frames."""

import numpy as np

from slambench.drivers import Session


class Driver:
    lanes = 2

    def __init__(self, cfg, voc, device):
        self.cfg, self.device = cfg, device

    def session(self, left, right):
        from ros_stereo_slam_tpu_torch.models import pipeline

        out = []
        for _ in range(self.lanes):
            res = pipeline.run_offline(self.cfg, left, right, device=self.device)
            out.append(Session(res.trajectory, np.concatenate([[True], res.tracking_ok])))
        return out
'''

TRI_SITE = '''"""Stereo triangulation (``ops/triangulate.triangulate_rectified``).
Number: ``tri_depth_gap``, the widest relative gap of a valid point's
depth from fx * baseline / disparity."""

from slambench.record import copy

TARGET = ("ops.triangulate", "triangulate_rectified")


def wrap(orig, tap):
    def triangulate_rectified(cam, baseline, uv_left, uv_right, mask, *a, **k):
        out = orig(cam, baseline, uv_left, uv_right, mask, *a, **k)
        if tap.active:
            tap.calls += 1
            tap.offer(lambda: dict(fb=float(cam.fx) * float(baseline),
                                   d=copy(uv_left[..., 0] - uv_right[..., 0]),
                                   valid=copy(out.valid), z=copy(out.depth)))
        return out
    return triangulate_rectified


def numbers(items, ctx):
    gap = 0.0
    for s in items:
        v = s["valid"]
        if bool(v.any()):
            ref = s["fb"] / s["d"][v].double()
            gap = max(gap, float(((s["z"][v].double() - ref).abs() / ref).max()))
    return {"tri_depth_gap": gap}
'''

STEP_CALLS = '''"""``step.frame`` spans a frame of the traced session."""

from slambench import example

EXAMPLE = example.record
EXPECTED = 1.5  # 3 step.frame spans over 2 frames


def read(rec):
    n = sum(s.name == "step.frame" for s in rec.get("spans") or [])
    return n / rec["frames"] if n and rec.get("frames") else None
'''


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def test_a_lane_driver_a_site_and_a_span_reader_join_by_files_alone(tmp_path, capsys):
    """A queued cell's kinds of file: a two-lane driver, a sampled call site
    with its number and limit, and a reader of the program's spans, added
    as new files and manifest entries; no file the checkout had changes."""
    from slambench.tests.test_metrics import reader_case

    root = small_root(tmp_path, SMALL)
    before = _files(root)
    d = root / "slambench"
    (d / "entries" / "run_offline_lanes2.py").write_text(TWO_LANES)
    (d / "sites" / "tri.py").write_text(TRI_SITE)
    (d / "metrics" / "step_calls.py").write_text(STEP_CALLS)
    mix = json.loads((d / "traffic" / "corridor_closed.json").read_text())
    mix["world"]["frames"], mix["driver"] = 9, "run_offline_lanes2"
    (d / "traffic" / "corridor_lanes2.json").write_text(json.dumps(mix))
    cell = json.loads((d / "cells" / "odo.corridor.offline.json").read_text())
    cell["samples"]["tri"] = 4
    cell["limits"]["tri_depth_gap"] = 1e-5
    (d / "cells" / "odo.lanes2.offline.json").write_text(json.dumps(cell))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    old = json.loads(json.dumps(bench))
    bench["workloads"].append({"name": "odo.lanes2.offline", "config": "kitti_odometry",
                              "traffic": "corridor_lanes2", "chips": 1, "why": "two lanes"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("odo.lanes2.offline")
    bench["per_layer"].append({"name": "step_calls", "unit": "calls/frame", "better": "lower",
                               "source": "program_span", "layer": "frame step", "moves": "fps",
                               "workloads": ["odo.lanes2.offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    read, ex, expected = reader_case(d / "metrics" / "step_calls.py")
    assert read(ex) == expected
    out = _run(tmp_path, capsys, "odo.lanes2.offline", trace=1, seconds=0.0, root=root)
    assert out["attempted"] == 2 * 9  # one session of two lanes
    assert out["correct"] is True, out["checks"]
    assert out["checks"]["tri_depth_gap"]["limit"] == 1e-5
    assert out["checks"]["poses_missing"]["value"] == 0
    assert out["metrics"]["step_calls"]["value"] == 1.0  # frame 0 and each step, both lanes

    after = _files(root)
    changed = {p for p in before if after[p] != before[p]}
    assert changed == {"BENCHMARK.json"}
    new = json.loads(after["BENCHMARK.json"])
    for key, entries in old.items():
        if isinstance(entries, list) and key != "command" and key != "paths":
            assert [e["name"] for e in new[key][: len(entries)]] == [e["name"] for e in entries]
    for path, data in after.items():
        if path.endswith(".py") and path in before:
            assert data == (ROOT / path).read_bytes(), path


def test_the_control_judged_by_the_cells_limits_is_not_correct(tmp_path):
    """control.readings on a small SLAM set-up: the sound window is correct
    and the bfloat16 reference in the program's place is not, by the
    cell's own limits."""
    from slambench import control

    root = small_root(tmp_path, SMALL)
    args = run.parse(["--workload", "slam.revisit.offline", "--seed", str(SEED),
                      "--seconds", "0.1", "--trace", "0"])
    st = run.Setup(args, "cpu", root)
    got = control.readings(st, 0.1, [])
    assert got["sound"]["correct"] is True, got["sound"]["checks"]
    assert got["control"]["correct"] is False
    failed = {k for k, c in got["control"]["checks"].items() if c["value"] > c["limit"]}
    assert {"k1_gap_px", "k2_bits_differ"} <= failed, got["control"]["checks"]


def test_judge_holds_the_limited_numbers_and_fails_one_not_produced():
    from slambench import check

    ok, checks = check.judge({"a": 0.5, "b": 3.0}, {"a": 1.0})
    assert ok is True and checks == {"a": {"value": 0.5, "limit": 1.0}}
    ok, checks = check.judge({"a": 0.5}, {"a": 1.0, "k1_gap_px": 0.1})
    assert ok is False and checks["k1_gap_px"]["value"] is None
    assert check.judge({"a": 1.5}, {"a": 1.0})[0] is False
