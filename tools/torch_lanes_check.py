#!/usr/bin/env python3
"""The two-lane SLAM cell's readings: its lane sites against the control,
and each lane against the single-lane path.

    python3 tools/torch_lanes_check.py --seeds 11 12 13 [--out DIR] [--device cuda:0]

from the root of a checkout, on the card (``--device cpu`` rehearses it on
a checkout whose configurations are cut small, as
``slambench/tests/conftest.py::small_root`` cuts them; ``--root`` names
that checkout).  For each seed one set-up of ``slam.revisit.lanes2``
(``slambench.run.Setup``: the frames at full size, the vocabulary, the
warm-up), then one timed session of the lane driver
(``run_offline_slam_batched`` over lane 0 as rendered and lane 1 at 0.85
exposure) and:

- ``sound``: every number of the cell's checks on that session;
- ``control``: the same session's sampled K1b and K2b lanes with the plain
  references computed in bfloat16, one precision below the
  configuration's float32, standing in the program's place, judged by the
  same limits;
- ``lanes``: each lane against ``run_offline_slam`` on that lane's frames
  from that lane's key (``step_batched.lane_keys(seed, 2)[b]``): the
  accepted closures of both, whether they are equal, and the widest gap
  between their poses (after the pose graph and before it), in metres
  and in rotation-matrix entries;
- the session's any-lane branch counters (``step.LANE_BRANCHES``), its
  closures per lane, the peak device memory of the window, the seconds
  the lane driver takes to make its (lanes, F, H, W) host stacks for
  frames it has not seen (``stacks_s``) and the card.

Prints one line per seed, ``READINGS {json}``, and appends the JSON to
``DIR/slam.revisit.lanes2.jsonl`` (``--out``).  Not run by the benchmark's
own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CELL = "slam.revisit.lanes2"


def control_numbers(st, rec) -> dict:
    """The lane sites' numbers with the bfloat16 references' outputs
    standing where the program's stood (``slambench.control``'s references,
    each lane's image found among that lane's frames)."""
    import torch

    from slambench import check, control
    from slambench.reference import lanes as lanes_ref

    ctx = check.Context(check.FrameIndex(st.frames), None, None, st.device)
    index = [check.FrameIndex(lanes_ref.lane_stacks(st.frames.left, st.frames.right, b))
             for b in range(st.driver.lanes)]
    out = {}
    for name, ref in (("k1b", control._ref_k1), ("k2b", control._ref_k2)):
        tap = rec.taps.get(name)
        if tap is not None and tap.sample.items:
            items = [dict(x, out=ref(x, index[x["lane"]], torch.bfloat16))
                     for x in tap.sample.items]
            out.update(tap.site.numbers(items, ctx))
    return out


def lane_gaps(st, sessions) -> list:
    """Each lane of a session against the single-lane run from its key."""
    import numpy as np

    from ros_stereo_slam_tpu_torch.models import slam_scan, step_batched

    drv = st.driver
    L, R = drv.stacks(st.left, st.right)
    keys = step_batched.lane_keys(drv.cfg.seed, drv.lanes)
    out = []
    for b, s in enumerate(sessions):
        one = slam_scan.run_offline_slam(drv.cfg.replace(seed=keys[b]), drv.voc, L[b], R[b],
                                         device=st.device)
        single = [(int(q), int(m)) for q, m, _ in one.loop_events]
        row = {"lane": b, "closures": s.closures, "single_closures": single,
               "closures_equal": s.closures == single}
        for name, a, c in (("pgo", s.trajectory, one.trajectory),
                           ("odo", s.trajectory_odo, one.trajectory_odo)):
            a, c = np.asarray(a, np.float64), np.asarray(c, np.float64)
            row[f"{name}_gap_m"] = float(np.linalg.norm(a[:, :3, 3] - c[:, :3, 3], axis=1).max())
            row[f"{name}_rot_gap"] = float(np.abs(a[:, :3, :3] - c[:, :3, :3]).max())
            row[f"{name}_bitwise"] = bool(np.array_equal(a, c))
        out.append(row)
    return out


def readings(st) -> dict:
    from ros_stereo_slam_tpu_torch.models import step
    from slambench import check, drivers

    t = time.perf_counter()
    st.driver.stacks(st.left.copy(), st.right.copy())
    stacks_s = time.perf_counter() - t  # what a session given new frames pays first
    st.driver.stacks(st.left, st.right)  # the window's recording, made before it as set-up does
    before = {k: dict(v) for k, v in step.LANE_BRANCHES.items()}
    window, rec, _, _, peak = st.measure(0.0)
    branches = {k: {f: step.LANE_BRANCHES[k][f] - before[k][f] for f in v}
                for k, v in before.items()}
    ok, checks, info = st.judge(window, rec)
    out = {"sound": {"correct": ok, "checks": checks, "info": info},
           "memory_peak_bytes": int(peak), "stacks_s": stacks_s, "lane_branches": branches,
           "site_calls": rec.calls}
    nums = {k: c["value"] for k, c in checks.items()}
    nums.update(control_numbers(st, rec))
    ok, checks = check.judge(nums, st.cell_file["limits"])
    out["control"] = {"correct": ok, "checks": checks}
    out["lanes"] = lane_gaps(st, drivers.flatten(window.sessions[:1]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--root", default=str(ROOT), help="the checkout whose benchmark is read")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from slambench import run

    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        rargs = run.parse(["--workload", CELL, "--seed", str(seed), "--seconds", "0",
                           "--trace", "0"])
        st = run.Setup(rargs, args.device, Path(args.root))
        line = json.dumps({"workload": CELL, "seed": seed, "card": run.smi_line(),
                           **readings(st)}, default=str)
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
