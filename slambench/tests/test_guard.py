"""The import guard compares top-level module names whole."""

import subprocess
import sys
import types

from slambench import run
from slambench.tests.conftest import ROOT


def test_guard_trips_on_jax_and_the_jax_package(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ros_stereo_slam_tpu.ops", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "ros_stereo_slam_tpu"]


def test_guard_passes_the_port(monkeypatch):
    import ros_stereo_slam_tpu_torch.models.slam  # noqa: F401

    for name in ("ros_stereo_slam_tpu_torch", "jaxtyping", "flaxen", "ros_stereo_slam_tpu_x"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert run.forbidden_modules() == []


def test_nothing_the_benchmark_runs_loads_jax():
    code = ("import sys; import slambench.run, slambench.check, slambench.faults, "
            "slambench.vocabulary, slambench.drivers; "
            "import ros_stereo_slam_tpu_torch.models.slam, ros_stereo_slam_tpu_torch.models.slam_scan; "
            "print(slambench.run.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


def test_the_reference_imports_nothing_of_the_program():
    import ast

    for p in (ROOT / "slambench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] in ("torch", "numpy", "__future__"), (p, n)


def test_no_card_exits_without_a_result():
    out = subprocess.run([sys.executable, "-m", "slambench.run", "--workload",
                          "odo.corridor.offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_a_tree_of_the_benchmark_alone_exits_without_a_result(tmp_path):
    import shutil

    shutil.copytree(ROOT / "slambench", tmp_path / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "-m", "slambench.run", "--workload",
                          "odo.corridor.offline", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
