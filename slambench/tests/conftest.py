"""Helpers of the benchmark's own tests, which run on the CPU.  Run:
``python -m pytest slambench/tests -q`` from the root."""

import json
import shutil
import sys
from pathlib import Path


ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# A small camera (416x160, the full camera's field of view) and small
# worlds, so that a whole run takes seconds on the CPU.
SMALL_CAMERA = {"fx": 240.97, "fy": 240.97, "cx": 203.5, "cy": 78.8, "baseline": 0.54,
                "width": 416, "height": 160, "rate_hz": 10}


def small_root(dest: Path, limits: dict | None = None) -> Path:
    """A checkout of the benchmark's data at the small camera: a k=4, L=3
    vocabulary from one 8-frame scene, a 72-frame revisit world (laps of
    60), a 13-frame corridor, closures allowed 20 frames apart, 4 warm-up
    frames.  `limits` ({cell: {number: limit}}) replaces limits."""
    shutil.copytree(ROOT / "slambench", dest / "slambench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    for p in (dest / "slambench" / "configs").glob("*.json"):
        c = json.loads(p.read_text())
        c["camera"] = SMALL_CAMERA
        if c.get("vocabulary"):
            c["vocabulary"].update(k=4, levels=3, train_scenes=[20121])
            c["vocabulary"]["corners"]["per_frame"] = 256
            c["vocabulary"]["train_world"]["frames"] = 8
            c["overrides"] = {"loop": {"vocab_k": 4, "vocab_levels": 3, "min_separation": 20,
                                       "cooldown": 20, "dislocal": 10}}
        p.write_text(json.dumps(c))
    for p in (dest / "slambench" / "traffic").glob("*.json"):
        t = json.loads(p.read_text())
        if t["world"]["recipe"] == "revisit":
            t["world"].update(frames=72, lap=60)
        else:
            t["world"]["frames"] = 13
        t["warm_frames"] = 4
        p.write_text(json.dumps(t))
    for cell, lim in (limits or {}).items():
        p = dest / "slambench" / "cells" / f"{cell}.json"
        c = json.loads(p.read_text())
        c["limits"].update(lim)
        p.write_text(json.dumps(c))
    return dest
