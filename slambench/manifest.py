"""``BENCHMARK.json`` and the files it names, found by name.

- a cell (``workloads[]``) names a configuration and a traffic mix;
- a configuration's file is ``configs[].file``;
- a mix is ``slambench/traffic/<traffic>.json``;
- a cell's sample sizes and limits are ``slambench/cells/<workload>.json``;
- a per-layer metric is ``slambench/metrics/<name>.py``, exposing
  ``read(record) -> float | None``.

All of them are read from the checkout the manifest is in (`root`).

A new cell, mix, configuration or metric is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import re
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
        return reader(self.dir / "metrics" / f"{name}.py")


def reader(path: Path):
    """The ``read`` function of the metric file at `path`."""
    name = path.name[:-3]
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
