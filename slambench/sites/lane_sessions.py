"""Each lane's session of the lane driver, tied to that lane's own drive
(``models/slam_scan.run_offline_slam_batched``).

The driver's call runs the host epilogue once a lane (``_epilogue_one``:
closures, loop edges, the pose graph) on that lane's frames, odometry
chain and database.  While a call runs in the window the site watches
those epilogues (the lane's last frame, the uint8 image the epilogue's
``frame_of`` gives, and the chain it was given), then matches each lane
of the call's result to them.  Sampled: whole calls, every lane of a
call.
Numbers:

- ``lane_sessions_unmatched``: lanes whose result is not what an epilogue
  returned on that lane's own frames (lane b's last frame,
  :mod:`slambench.reference.lanes`), from the chain it was given (the
  result's odometry chain after frame 0).  A lane whose epilogue was
  skipped, or that returns another lane's result, counts (0);
- ``lane_sessions_twins``: pairs of lanes of one call with the same
  odometry chain, bit for bit: two drives at different exposures never
  give it (0).

Each lane's poses are then held to the plain pose graph on that lane's own
chain and loop edges by ``pgo_cost_left``, a session a lane.
"""

import numpy as np
import torch

from slambench.record import copy
from slambench.reference import lanes as lanes_ref

TARGET = ("models.slam_scan", "run_offline_slam_batched")


def _result(res) -> dict:
    return dict(odo=np.array(res.trajectory_odo), poses=np.array(res.trajectory),
                closures=[(int(q), int(m)) for q, m, _ in res.loop_events])


def _same(a: dict, b: dict) -> bool:
    return (a["closures"] == b["closures"] and np.array_equal(a["odo"], b["odo"])
            and np.array_equal(a["poses"], b["poses"]))


def wrap(orig, tap):
    def run_offline_slam_batched(cfg, vocab, left_seqs, right_seqs, *args, **kwargs):
        if not tap.active:
            return orig(cfg, vocab, left_seqs, right_seqs, *args, **kwargs)
        from ros_stereo_slam_tpu_torch.models import slam_scan

        epilogue, runs = slam_scan._epilogue_one, []

        def _epilogue_one(cfg, lc, top_ids, top_scores, ns, fstats, keyframes, frame_of,
                          phase=0):
            res = epilogue(cfg, lc, top_ids, top_scores, ns, fstats, keyframes, frame_of,
                           phase=phase)
            last = len(fstats.T_wc)
            runs.append(dict(frame=last, left=copy(frame_of(last)[0]),
                             chain=np.array(fstats.T_wc), out=_result(res)))
            return res

        slam_scan._epilogue_one = _epilogue_one
        try:
            results = orig(cfg, vocab, left_seqs, right_seqs, *args, **kwargs)
        finally:
            slam_scan._epilogue_one = epilogue
        tap.calls += 1
        tap.offer(lambda: dict(runs=runs, lanes=[_result(r) for r in results]))
        return results
    return run_offline_slam_batched


def numbers(items, ctx) -> dict:
    left = ctx.index.stacks["left"]
    unmatched, twins = 0, 0
    for s in items:
        for b, got in enumerate(s["lanes"]):
            own = [r for r in s["runs"]
                   if torch.equal(r["left"].to(left.device),
                                  lanes_ref.lane_frames(left[r["frame"]:r["frame"] + 1], b)[0])]
            unmatched += not any(_same(got, r["out"]) and np.array_equal(got["odo"][1:], r["chain"])
                                 for r in own)
            twins += sum(np.array_equal(got["odo"], o["odo"]) for o in s["lanes"][:b])
    return {"lane_sessions_unmatched": unmatched, "lane_sessions_twins": twins}
