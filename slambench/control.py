"""The readings that the limits of ``correct`` are set from, on the card.

    python3 -m slambench.control --workload <cell> --seeds 11 12 13 \\
        [--fault-seeds 2] [--faults NAME ...] [--seconds 1] [--out chiprun_out/control]

For each seed one set-up of the cell, then short windows (one session
each, at the cell's own size): the sound program; then, on the first
``--fault-seeds`` seeds, the program with each fault the cell can have
(or each named by ``--faults``) planted under the timed path
(:mod:`slambench.faults`).  The control, the
reference computed in bfloat16 (the precision below the configuration's
float32) put in the program's place, is read from the sound window's
kernel samples.  Each reading is judged by the cell's own limits
(``check.judge``), so a line shows which of them come out not correct.
Prints one JSON line per seed and, with ``--out``, appends them to
``<out>/<cell>.jsonl``.  Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch


class Patch:
    """``setattr`` that :meth:`undo` takes back (a monkeypatch)."""

    def __init__(self):
        self.saved = []

    def setattr(self, obj, name, value):
        self.saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        for obj, name, value in reversed(self.saved):
            setattr(obj, name, value)
        self.saved.clear()


def control_numbers(rec, frames) -> dict:
    """The kernels' numbers with the bfloat16 reference's outputs standing
    where the program's stood."""
    from slambench import check

    index = check.FrameIndex(frames)
    ctx = check.Context(index, None, None, "cpu")
    out = {}
    for name, ref in (("k1", _ref_k1), ("k2", _ref_k2)):
        tap = rec.taps.get(name)
        if tap is not None and tap.sample.items:
            out.update(tap.site.numbers([dict(x, out=ref(x, index, torch.bfloat16))
                                         for x in tap.sample.items], ctx))
    return out


def _ref_k1(x, index, dtype):
    from slambench.check import unit
    from slambench.reference import lk as lk_ref

    p, dev = x["params"], x["ref_pts"].device
    return lk_ref.track_level(unit(index.find(x["ref_img"]), dev),
                              unit(index.find(x["cur_img"]), dev), x["ref_pts"], x["guesses"],
                              p.window, p.iters, p.walk_iters, p.eps, p.min_eig, dtype)[:3]


def _ref_k2(x, index, dtype):
    from slambench.check import unit
    from slambench.reference import orb as orb_ref

    s = orb_ref.signs(unit(index.find(x["img"]), x["pts"].device), x["pts"], x["valid"], dtype)
    return (s,) + tuple(x["out"][1:])


def readings(st, seconds: float, faults: list) -> dict:
    """{"sound" | "control" | fault: {"correct", "checks"}} of one set-up."""
    from slambench import check
    from slambench import faults as faults_mod

    limits = st.cell_file["limits"]
    out = {}
    window, rec, _, _, _ = st.measure(seconds)
    ok, checks, info = st.judge(window, rec)
    out["sound"] = {"correct": ok, "checks": checks, "info": info}
    nums = {k: c["value"] for k, c in checks.items()}
    nums.update(control_numbers(rec, st.frames))
    ok, checks = check.judge(nums, limits)
    out["control"] = {"correct": ok, "checks": checks}
    for name in faults:
        mp = Patch()
        faults_mod.PLANTS[name](mp)
        try:
            window, rec, _, _, _ = st.measure(seconds)
        finally:
            mp.undo()
        ok, checks, _ = st.judge(window, rec)
        out[name] = {"correct": ok, "checks": checks}
    return out


def cell_faults(st) -> list:
    from slambench import faults

    slam = st.conf.get("vocabulary") is not None
    return [f for f in faults.PLANTS if slam or f not in faults.SLAM_ONLY]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m slambench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="read the faults on this many of the seeds, the first ones")
    ap.add_argument("--faults", nargs="+", default=None, help="these faults only")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from slambench import run

    for n, seed in enumerate(args.seeds):
        rargs = run.parse(["--workload", args.workload, "--seed", str(seed),
                           "--seconds", str(args.seconds), "--trace", "0"])
        st = run.Setup(rargs, "cuda:0", run.ROOT)
        faults = [f for f in cell_faults(st) if args.faults is None or f in args.faults]
        got = readings(st, args.seconds, faults if n < args.fault_seeds else [])
        line = json.dumps({"workload": args.workload, "seed": seed, **got})
        print(f"READINGS {line}", flush=True)
        if args.out:
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            with open(out / f"{args.workload}.jsonl", "a") as f:
                f.write(line + "\n")
        del st
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
