"""Every per-layer metric's reader on its own test case, and the traced
record they read."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from slambench import example, manifest, trace
from slambench.tests.conftest import ROOT

METRICS = ROOT / "slambench" / "metrics"
READERS = sorted(p.name[:-3] for p in METRICS.glob("*.py"))


def reader_case(path: Path):
    """(read, the reader's example record, EXPECTED) of a reader file."""
    mod = manifest.load(path)
    ex = mod.EXAMPLE() if callable(mod.EXAMPLE) else mod.EXAMPLE
    return mod.read, ex, mod.EXPECTED


def test_every_metric_in_the_manifest_has_a_reader_and_every_reader_a_test():
    names = {m["name"] for m in manifest.Manifest(ROOT).data["per_layer"]}
    assert names <= set(READERS)
    for name in READERS:
        mod = manifest.load(METRICS / f"{name}.py")
        assert callable(mod.read) and hasattr(mod, "EXAMPLE") and hasattr(mod, "EXPECTED"), name


@pytest.mark.parametrize("name", READERS)
def test_reader(name):
    read, ex, expected = reader_case(METRICS / f"{name}.py")
    assert read(ex) == pytest.approx(expected, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_reader_with_nothing_to_read_returns_none(name):
    assert manifest.Manifest(ROOT).reader(name)(example.empty()) is None


def test_the_span_layers_add_up_to_the_session():
    from ros_stereo_slam_tpu_torch.utils import profiling

    from slambench import spans

    rec = example.record()
    assert spans.per_frame(rec["spans"], 2) == profiling.per_frame(rec["spans"], 2)
    man = manifest.Manifest(ROOT)
    parts = ("step_host_ms", "detect_host_ms", "epilogue_host_ms", "driver_self_ms")
    total = sum(man.reader(f"{p}.offline")(rec) for p in parts)
    assert total == pytest.approx(spans.per_frame(rec["spans"], 2)["driver.session"], rel=1e-12)


def test_idle_gaps_charge_the_host_op_at_each_gap():
    gaps = dict(trace.idle_gaps(example.record()["trace"]))
    assert gaps["aten::mul"] == pytest.approx(0.02)  # the gap 20-40 ms, its middle at 30
    assert sum(gaps.values()) == pytest.approx(0.07)
    ops = dict(trace.device_ops(example.record()["trace"]))
    assert ops == pytest.approx({"lk_level_kernel<4, 2>": 0.01, "elementwise": 0.01,
                                 "reduce": 0.01})


def test_reduce_reads_a_real_profile():
    cap = trace.Capture()
    cap.start()
    with cap.span(trace.SESSION_SPAN):
        x = torch.randn(64, 64)
        (x @ x).sum()
    rec = cap.stop()
    assert rec["window_s"] > 0
    assert any(name == "aten::mm" for name, _, _ in rec["host_ops"])
    assert rec["kernels"] == [] and rec["busy_s"] == 0.0
    json.dumps(trace.idle_gaps(rec))


def test_the_record_holds_the_programs_spans_of_the_session():
    """Under a capture the program's spans record; the record keeps those
    inside the session span, with their parents, and none from outside."""
    from ros_stereo_slam_tpu_torch.utils import profiling

    cap = trace.Capture()
    cap.start()
    with profiling.span("driver.session", driver="before"):
        pass
    with cap.span(trace.SESSION_SPAN):
        with profiling.span("driver.session", driver="run_offline") as top:
            with profiling.span("step.frame", frame=1):
                profiling.annotate(points=7)
    with profiling.span("step.frame", frame=2):
        pass
    rec = cap.stop()
    got = {s.name: s for s in rec["spans"]}
    assert len(rec["spans"]) == 2 and set(got) == {"driver.session", "step.frame"}
    assert got["driver.session"].attrs == {"driver": "run_offline"}
    assert got["step.frame"].parent == top.id == got["driver.session"].id
    assert got["step.frame"].attrs == {"frame": 1, "points": 7}
    lo, hi = rec["window_ns"]
    assert all(lo <= s.start_ns <= s.end_ns <= hi for s in rec["spans"])


def test_merge_unions_intervals():
    iv = np.array([[5, 9], [0, 3], [2, 4], [8, 12], [20, 21]], np.int64)
    np.testing.assert_array_equal(trace.merge(iv), [[0, 4], [5, 12], [20, 21]])
    assert trace.covered(trace.merge(iv), 3, 10) == 1 + 5
