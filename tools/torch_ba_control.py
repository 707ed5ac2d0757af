#!/usr/bin/env python3
"""The readings that the BA cell's limits of ``correct`` are set from.

    python3 tools/torch_ba_control.py --seeds 11 12 13 [--fault-seeds 3] \
        [--seconds 0] [--out DIR] [--device cuda:0]

from the root of a checkout, on the card (``--device cpu`` rehearses it on
a checkout whose configurations are cut small, as
``slambench/tests/conftest.py::small_root`` cuts them; ``--root`` names
that checkout).  For each seed one set-up of ``ba.corridor.offline``
(``slambench.run.Setup``: the frames at full size and the warm-up), then
windows of one session each:

- ``sound``: the program as it is, every number of the cell's checks;
- ``control``: the same window's sampled calls with the references
  computed one precision below the configuration's standing in the
  program's place: BA's dense reference (``slambench/reference/ba.py``)
  in float32 where the configuration's BA is float64, and K1's in
  bfloat16 (``slambench.control.control_numbers``);
- on the first ``--fault-seeds`` seeds, a fault planted under the timed
  path: ``ba_input_returned`` (``ba_solve`` returns the window it was
  given) and ``ba_iters_1`` (one Gauss-Newton step where the
  configuration asks for ten).

Each reading is judged by the cell's own limits (``check.judge``).  The
sound reading also lists each sampled BA solve: whether the reference
refined it, and its RMS before and after.  Prints one line per seed,
``READINGS {json}``, and appends the JSON to
``DIR/ba.corridor.offline.jsonl`` (``--out``).  Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELL = "ba.corridor.offline"


def _ba_module():
    from ros_stereo_slam_tpu_torch.models import bundle_adjust

    return bundle_adjust


def plant_input_returned(mp) -> None:
    """``ba_solve`` solves, then returns the window it was given."""
    mod = _ba_module()
    orig = mod.ba_solve

    def ba_solve(cam, T_cw, landmarks, *a, **k):
        r = orig(cam, T_cw, landmarks, *a, **k)
        return r._replace(T_cw=T_cw, landmarks=landmarks, rms_after=r.rms_before)

    mp.setattr(mod, "ba_solve", ba_solve)


def plant_iters_1(mp) -> None:
    """``ba_solve`` takes one Gauss-Newton step, whatever it is asked."""
    mod = _ba_module()
    orig = mod.ba_solve

    def ba_solve(*a, iters=10, **k):
        return orig(*a, iters=1, **k)

    mp.setattr(mod, "ba_solve", ba_solve)


FAULTS = {"ba_input_returned": plant_input_returned, "ba_iters_1": plant_iters_1}


def control_numbers(st, rec) -> dict:
    """The sites' numbers with the lower-precision references' outputs
    standing where the program's stood."""
    import torch

    from slambench import check, control

    out = control.control_numbers(rec, st.frames)
    site, tap = st.man.site("ba"), rec.taps["ba"]
    items = []
    for x in tap.sample.items:
        r = site.reference(x, torch.float32)
        items.append(dict(x, out=(r.T_cw, r.landmarks, r.rms_before, r.rms_after)))
    ctx = check.Context(check.FrameIndex(st.frames), None, st.conf, st.device)
    out.update(site.numbers(items, ctx))
    return out


def ba_samples(st, rec) -> list:
    """[reference refined it, RMS before, RMS after] of each sampled solve."""
    site = st.man.site("ba")
    out = []
    for x in rec.taps["ba"].sample.items:
        r = site.reference(x)
        out.append([r.accepted, float(r.rms_before), float(r.rms_after)])
    return out


def readings(st, seconds: float, faults: list) -> dict:
    from slambench import check, control

    limits = st.cell_file["limits"]
    window, rec, _, _, _ = st.measure(seconds)
    ok, checks, info = st.judge(window, rec)
    out = {"sound": {"correct": ok, "checks": checks, "info": info,
                     "ba_samples": ba_samples(st, rec), "ba_calls": rec.calls.get("ba")}}
    nums = {k: c["value"] for k, c in checks.items()}
    nums.update(control_numbers(st, rec))
    ok, checks = check.judge(nums, limits)
    out["control"] = {"correct": ok, "checks": checks}
    for name in faults:
        mp = control.Patch()
        FAULTS[name](mp)
        try:
            window, rec, _, _, _ = st.measure(seconds)
        finally:
            mp.undo()
        ok, checks, _ = st.judge(window, rec)
        out[name] = {"correct": ok, "checks": checks}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault-seeds", type=int, default=3,
                    help="read the faults on this many of the seeds, the first ones")
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose benchmark is read")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from slambench import run

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for n, seed in enumerate(args.seeds):
        rargs = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds",
                           str(args.seconds), "--trace", "0"])
        st = run.Setup(rargs, args.device, Path(args.root))
        got = readings(st, args.seconds, list(FAULTS) if n < args.fault_seeds else [])
        line = json.dumps({"workload": CELL, "seed": seed, "card": run.smi_line(), **got},
                          default=str)
        print(f"READINGS {line}", flush=True)
        if args.out:
            out = Path(args.out)
            out.mkdir(parents=True, exist_ok=True)
            with open(out / f"{CELL}.jsonl", "a") as f:
                f.write(line + "\n")
        del st
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
