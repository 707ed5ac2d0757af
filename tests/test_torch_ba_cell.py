"""The benchmark's BA cell, ``ba.corridor.offline`` (configuration
``kitti08_ba``, config 4 on KITTI seq. 08's camera): the configuration
loads as ``preset_ba()``; a tiny run of the cell through
``slambench.run`` on the CPU at the benchmark tests' small camera is
correct and reports the four BA numbers and ``ba_host_ms.offline``; the
span report prints BA's counters.

The run goes in a child process: ``slambench.run`` refuses to report
from a process that has JAX loaded, as this suite's has.  It keeps 128
landmark slots (every grid point of the small camera) and samples 2 BA
solves, so the dense reference's window stays small on a CPU.
"""

import importlib.util
import json
import os
import subprocess
import sys

import pytest

from ros_stereo_slam_tpu_torch.config import CameraConfig, preset_ba
from slambench import drivers, manifest
from slambench.tests.conftest import ROOT, small_root

CELL = "ba.corridor.offline"
SEED = 2**33 + 16
BA_NUMBERS = {"ba_pose_gap_m", "ba_landmark_gap_rel", "ba_rms_gap_px", "ba_accept_flips"}
# the small camera's limits, as slambench/tests/test_runs.py gives the corridor's
SMALL = {CELL: {"step_err_p50_m": 0.3, "k1_gap_px": 0.01, "k1_ok_flips": 0.01}}


def _small_ba_root(tmp_path):
    root = small_root(tmp_path, SMALL)
    conf = root / "slambench" / "configs" / "kitti08_ba.json"
    c = json.loads(conf.read_text())
    c["overrides"] = {"frontend": {"max_points": 128}}
    conf.write_text(json.dumps(c))
    cell = root / "slambench" / "cells" / f"{CELL}.json"
    c = json.loads(cell.read_text())
    c["samples"]["ba"] = 2
    cell.write_text(json.dumps(c))
    return root


def test_the_configuration_is_preset_ba_on_seq08s_camera():
    man = manifest.Manifest(ROOT)
    conf = man.config("kitti08_ba")
    cell = man.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == ("kitti08_ba", "corridor_closed", 1)
    assert man.traffic(cell["traffic"])["driver"] == "run_offline"
    cfg = drivers.pipeline_config(conf, man.traffic(cell["traffic"]).get("overrides", {}), 7)
    cam = CameraConfig(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104, baseline=0.5372,
                       width=1226, height=370)
    assert cfg == preset_ba().replace(camera=cam, seed=7)
    assert cfg.ba_enabled and cfg.export_map
    assert (cfg.ba.window, cfg.ba.iters, cfg.ba.damping, cfg.ba.huber_px) == (8, 10, 1e-4, 2.0)
    sizes = conf["sizes"]
    assert (sizes["grid_step"], sizes["max_points"], sizes["ba_window"], sizes["ba_iters"],
            sizes["max_keyframes"]) == (cfg.frontend.grid_step, cfg.frontend.max_points,
                                        cfg.ba.window, cfg.ba.iters, cfg.keyframes.max_keyframes)
    assert conf["reduced"] == [] and man.cell_file(CELL)["samples"] == {"k1": 8, "ba": 8}
    assert BA_NUMBERS <= set(man.cell_file(CELL)["limits"])
    metric, = [m for m in man.data["per_layer"] if m["name"] == "ba_host_ms.offline"]
    assert metric["workloads"] == [CELL] and metric["layer"] == "bundle adjustment"


RUN = """
import json, sys
from pathlib import Path
from slambench import run
args = run.parse(["--workload", sys.argv[2], "--seed", sys.argv[3], "--seconds", "0",
                  "--trace", "1"])
sys.exit(run.run(args, "cpu", root=Path(sys.argv[1])))
"""


def test_a_tiny_run_of_the_cell_is_correct_and_reports_ba(tmp_path):
    root = _small_ba_root(tmp_path)
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", RUN, str(root), CELL, str(SEED)], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True, out["checks"]
    assert BA_NUMBERS <= set(out["checks"])
    assert out["checks"]["ba_accept_flips"]["value"] == 0
    assert out["attempted"] == 13 and out["failed"] == 0
    metrics = out["metrics"]
    assert {"ba_host_ms.offline", "step_host_ms.offline", "launches_per_frame.offline"} <= set(
        metrics)
    assert 0 < metrics["ba_host_ms.offline"]["value"] < metrics["step_host_ms.offline"]["value"]
    assert "detect_host_ms.offline" not in metrics


def _span_report():
    spec = importlib.util.spec_from_file_location("torch_span_report",
                                                  ROOT / "tools" / "torch_span_report.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ba_solves_reads_the_counters():
    """The tool's one reader over the graph families' counters: BA's
    solves, iterations and replays, and PnP's by the same keys."""
    tool = _span_report()
    rows = {"step.ba": {"calls": 12}, "step.pnp": {"calls": 13}}
    before = {"pnp": {"captures": 1, "replays": 5, "eager": 0},
              "ba": {"captures": 1, "replays": 2, "eager": 1, "iterations": 30}}
    after = {"pnp": {"captures": 2, "replays": 19, "eager": 0},
             "ba": {"captures": 1, "replays": 11, "eager": 4, "iterations": 150}}
    assert tool.graph_solves(before, after, rows) == {
        "pnp": {"solves": 14, "step_pnp_calls": 13, "captures_before_session": 1,
                "captures_session": 1, "replays": 14, "eager_solves": 0, "replayed_share": 1.0},
        "ba": {"solves": 12, "iterations": 120, "step_ba_calls": 12,
               "iterations_per_solve": 10.0, "captures_before_session": 1,
               "captures_session": 0, "replays": 9, "eager_solves": 3,
               "replayed_share": 0.75}}
    assert tool.graph_solves(before, before, {})["ba"] == {
        "solves": 0, "iterations": 0, "step_ba_calls": 0, "iterations_per_solve": None,
        "captures_before_session": 1, "captures_session": 0, "replays": 0, "eager_solves": 0,
        "replayed_share": None}


def test_the_span_report_prints_the_ba_counters(tmp_path, monkeypatch, capsys):
    """One traced session of the cell through the tool on the CPU: a solve
    for every ``step.ba`` call, ten iterations each, and the BA layer
    among the metrics."""
    tool = _span_report()
    root = _small_ba_root(tmp_path / "root")
    monkeypatch.setattr(tool, "ROOT", root)
    assert tool.main(["--workload", CELL, "--seed", str(SEED), "--device", "cpu",
                      "--out", str(tmp_path / "spans")]) == 0
    line = json.loads(capsys.readouterr().out.splitlines()[0])
    ba = line["ba"]
    assert ba["solves"] == ba["step_ba_calls"] == 12  # frames 1-12 of the 13-frame corridor
    assert ba["iterations"] == 120 and ba["iterations_per_solve"] == pytest.approx(10.0)
    assert ba["eager_solves"] == 12 and ba["replays"] == ba["captures_session"] == 0
    assert line["metrics"]["ba_host_ms.offline"] > 0
    saved = json.loads((tmp_path / "spans" / f"{CELL}.{SEED}.json").read_text())
    assert saved["ba"] == ba
    assert {"ba.linearize", "ba.reduce", "ba.factor", "ba.accept"} <= set(saved["rows"])
