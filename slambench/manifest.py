"""``BENCHMARK.json`` and the files it names, found by name.

- a cell (``workloads[]``) names a configuration and a traffic mix;
- a configuration's file is ``configs[].file``;
- a mix is ``slambench/traffic/<traffic>.json``; its ``driver`` names the
  program entry point it runs, ``slambench/entries/<driver>.py``, exposing
  ``Driver(cfg, voc, device)`` with ``session(left, right)``
  (:mod:`slambench.drivers`);
- a cell's sample sizes and limits are ``slambench/cells/<workload>.json``;
  each key of its ``samples`` names a sampled call site,
  ``slambench/sites/<name>.py``, exposing ``TARGET``, ``wrap`` and
  ``numbers`` (:mod:`slambench.record`);
- a per-layer metric is ``slambench/metrics/<name>.py``, exposing
  ``read(record) -> float | None`` and its own test case, ``EXAMPLE`` (a
  record, or a function that builds one) and ``EXPECTED`` (what ``read``
  gives on it).

All of them are read from the checkout the manifest is in (`root`).

A new cell, mix, configuration, driver, site or metric is a new file and
a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.data = _json(self.root / "BENCHMARK.json")
        self.dir = self.root / "slambench"

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in self.data['workloads']]}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def cell_file(self, name: str) -> dict:
        return _json(self.dir / "cells" / f"{name}.json")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The `kind` ("end_to_end" or "per_layer") metrics the cell reports."""
        return [m for m in self.data[kind] if cell in m.get("workloads", [cell])]

    def reader(self, name: str):
        """The ``read`` function of ``metrics/<name>.py``."""
        return find(self.dir / "metrics", name, "per-layer metric").read

    def site(self, name: str):
        """The module of ``sites/<name>.py``."""
        return find(self.dir / "sites", name, "sampled call site")


def find(directory: Path, name: str, what: str):
    """The module of ``<directory>/<name>.py``; for a name with no file, an
    error that lists the files there."""
    path = Path(directory) / f"{name}.py"
    if not path.is_file():
        known = sorted(p.name[:-3] for p in Path(directory).glob("*.py"))
        raise KeyError(f"no {what} {name!r}: no file {path}; known: {known}")
    return load(path)


def load(path: Path):
    """The module of the Python file at `path`, loaded anew under a name of
    its own (``slambench_<directory>_<file>``, in ``sys.modules`` as a
    dataclass in it needs)."""
    path = Path(path)
    name = re.sub(r"\W", "_", f"slambench_{path.parent.name}_{path.name[:-3]}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
