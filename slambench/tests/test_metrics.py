"""Every per-layer metric's reader on a recorded small trace."""

import json

import numpy as np
import pytest
import torch

from slambench import manifest, trace
from slambench.tests.conftest import ROOT

MS = 1_000_000  # ns


def _record():
    """A session span of 100 ms over two frames holding 4 kernels (two of
    K1); the device is busy 30 ms of it."""
    busy = np.array([[10, 20], [40, 50], [70, 80]], np.int64) * MS
    kernels = [("lk_level_kernel<4, 2>", 10 * MS, 5 * MS), ("lk_level_kernel<4, 2>", 15 * MS, 5 * MS),
               ("elementwise", 40 * MS, 10 * MS), ("reduce", 70 * MS, 10 * MS)]
    t = {"window_ns": (0, 100 * MS), "window_s": 0.1, "kernels": kernels, "copies": 1,
         "busy": busy, "busy_s": 0.03,
         "host_ops": [("aten::mul", 20 * MS, 15 * MS), ("cudaLaunchKernel", 25 * MS, 2 * MS)]}
    work = [{"bound_s": 0.0005}, {"bound_s": 0.0005}]
    return {"trace": t, "frames": 2, "k1_work": work}


EXPECTED = {
    "launches_per_frame.offline": 2.0,
    "device_idle_pct.offline": 70.0,
    "k1_roofline_pct": 10.0,
}


def test_every_metric_in_the_manifest_has_a_reader_and_every_reader_a_test():
    names = {m["name"] for m in manifest.Manifest(ROOT).data["per_layer"]}
    files = {p.name[:-3] for p in (ROOT / "slambench" / "metrics").glob("*.py")}
    assert names <= files and files == set(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader(name):
    got = manifest.Manifest(ROOT).reader(name)(_record())
    assert got == pytest.approx(EXPECTED[name], rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_with_nothing_to_read_returns_none(name):
    rec = _record()
    rec["trace"]["kernels"] = []
    rec["k1_work"], rec["frames"] = [], 0
    rec["trace"]["window_s"] = 0.0
    assert manifest.Manifest(ROOT).reader(name)(rec) is None


def test_idle_gaps_charge_the_host_op_at_each_gap():
    gaps = dict(trace.idle_gaps(_record()["trace"]))
    assert gaps["aten::mul"] == pytest.approx(0.02)  # the gap 20-40 ms, its middle at 30
    assert sum(gaps.values()) == pytest.approx(0.07)
    ops = dict(trace.device_ops(_record()["trace"]))
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


def test_merge_unions_intervals():
    iv = np.array([[5, 9], [0, 3], [2, 4], [8, 12], [20, 21]], np.int64)
    np.testing.assert_array_equal(trace.merge(iv), [[0, 4], [5, 12], [20, 21]])
    assert trace.covered(trace.merge(iv), 3, 10) == 1 + 5
