"""BENCHMARK.json against the benchmark's contract, and every name it
gives against the files the harness finds by name."""

import importlib
import json
import re

import pytest

from slambench import manifest, record
from slambench.tests.conftest import ROOT

DATA = json.loads((ROOT / "BENCHMARK.json").read_text())
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_size():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(DATA["paths"]) <= 16 and all(PATH.match(p) for p in DATA["paths"])
    assert len(DATA["command"]) <= 32 and all(LINE.match(w) for w in DATA["command"])
    assert not any(w.startswith("/") or ".." in w for w in DATA["command"])


def test_run_seconds_fits_the_full_check_with_24_cells():
    s = DATA["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for e in DATA[k]]
    names += [w[k] for w in DATA["workloads"] for k in ("config", "traffic")]
    names += [r for c in DATA["configs"] for r in c["reduced"]]
    assert all(manifest.NAME.match(n) for n in names), names
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in DATA[k]}) == len(DATA[k])
    for m in DATA["end_to_end"] + DATA["per_layer"]:
        assert manifest.UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for e in DATA["configs"] + DATA["workloads"]:
        assert LINE.match(e["why"])
    for c in DATA["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
    for m in DATA["per_layer"]:
        assert LINE.match(m["layer"])


def test_entry_keys():
    assert all(set(c) == {"name", "source", "file", "reduced", "why"} for c in DATA["configs"])
    assert all(set(w) == {"name", "config", "traffic", "chips", "why"} for w in DATA["workloads"])
    for m in DATA["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in DATA["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_bounds():
    for m in DATA["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert [m for m in DATA["end_to_end"] if m["name"] == "setup_s"][0]["bound"] <= 0.25


def test_every_cell_reports_setup_another_metric_and_a_layer():
    man = manifest.Manifest(ROOT)
    for w in DATA["workloads"]:
        e2e = {m["name"] for m in man.metrics(w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert man.metrics(w["name"], "per_layer")
        assert w["chips"] in (1, 4)


def test_each_layer_metric_moves_a_metric_its_cells_report():
    man = manifest.Manifest(ROOT)
    for m in DATA["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in DATA["workloads"]]):
            assert m["moves"] in {e["name"] for e in man.metrics(cell, "end_to_end")}


def test_every_name_finds_its_files():
    man = manifest.Manifest(ROOT)
    used = {w["config"] for w in DATA["workloads"]}
    assert used == {c["name"] for c in DATA["configs"]}
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files)
    for c in DATA["configs"]:
        assert any(c["file"].startswith(p + "/") for p in DATA["paths"])
        conf = man.config(c["name"])
        assert conf["reduced"] == c["reduced"] and conf["name"] == c["name"]
        assert LINE.match(conf["source"])
    for w in DATA["workloads"]:
        mix = man.traffic(w["traffic"])
        assert {"world", "driver", "loop", "warm_frames"} <= set(mix)
        cell = man.cell_file(w["name"])
        assert set(cell) == {"samples", "limits"}
    for m in DATA["per_layer"]:
        assert callable(man.reader(m["name"]))


@pytest.mark.parametrize("mix", sorted(p.name[:-5] for p in (ROOT / "slambench" / "traffic")
                                        .glob("*.json")))
def test_each_mix_finds_its_driver_file(mix):
    man = manifest.Manifest(ROOT)
    driver = man.traffic(mix)["driver"]
    assert (man.dir / "entries" / f"{driver}.py").is_file()
    assert callable(manifest.find(man.dir / "entries", driver, "driver").Driver)


def test_an_unknown_driver_is_refused_with_the_files_listed():
    from slambench import drivers

    with pytest.raises(KeyError, match="run_offline_slam"):
        drivers.make("run_nowhere", None, None, "cpu")


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_each_cells_samples_find_their_site_files(cell):
    man = manifest.Manifest(ROOT)
    for name in man.cell_file(cell)["samples"]:
        assert (man.dir / "sites" / f"{name}.py").is_file(), name
        site = man.site(name)
        mod, fn = site.TARGET
        assert callable(getattr(importlib.import_module(f"{record.PKG}.{mod}"), fn))
        assert callable(site.wrap) and callable(site.numbers)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "slambench").rglob("*")
                                        if p.is_file() and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    assert PATH.match(path)
