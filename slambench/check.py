"""What decides ``correct``: the timed path's outputs against the plain
reference (:mod:`slambench.reference`), once the window has closed.

Numbers worked out, each compared against the limit that the cell's file
gives (``cells/<workload>.json``) where it gives one, and shown in the
log beside the checks where it does not; a number whose outputs the cell
does not produce is left out:

- ``sessions_raised``: sessions that ended in an exception (limit 0);
- ``poses_missing``: frames offered for which a session returned no pose
  (limit 0): the configuration's guarantee of a pose for every frame;
- ``ate_session_max_m``: the largest absolute trajectory error of a
  session's poses against the ground truth of the rendered world, after
  a rigid alignment: every frame's pose, every session;
- ``step_err_p50_m``: the median, over a session's frames, of the
  translation error of each frame's motion from the frame before against
  the true motion (the relative pose error of one frame), the largest
  over the sessions;
- ``closures_off_revisit``: accepted closures whose two frames' true
  positions lie more than the configuration's ``revisit_m`` apart (0);
- ``loop_edge_err_m``: the largest translation error of a PnP-measured
  loop edge the pose graph was given, against the true relative pose of
  its two frames (edges the program sets to the identity where PnP
  starves are counted apart, ``identity_edges``);
- ``pgo_cost_left``: of the cost reduction that the plain reference's
  optimization (:mod:`.reference.pose_graph`) of a session's odometry
  chain and loop edges achieves with the configuration's iterations, the
  share the program's poses after the pose graph leave undone:
  (cost(program) - cost(reference)) / (cost(chain) - cost(reference)),
  the largest over the sessions with a loop edge (0 where the program
  reaches the reference's optimum, 1 where it leaves the chain as it
  was).  The poses themselves are not compared: along the chain's soft
  directions a truncated solve sits metres from the optimum at a cost
  within a few parts in ten thousand of it (the log gives that distance
  as ``pgo_gap_m``);
- the numbers of each sampled call site the cell installs
  (``slambench/sites/<name>.py``, :mod:`slambench.record`), which its file
  describes: K1's ``k1_*``, K2's ``k2_*``, K3's ``k3_words_differ``.

Every lane of a lane driver's session is a session here.

The reference follows the program from its own state where the program's
choices are not the benchmark's to make: the points and guesses K1 is
given, the corners K2 is given, the descriptors K3 is given, the odometry
chain and the loop edges the pose graph is given.  The images, the
vocabulary and the ground truth are the benchmark's own; the chain is
held to the ground truth by itself (``step_err_p50_m``,
``ate_session_max_m``), the edges' pairs by ``closures_off_revisit``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slambench.drivers import flatten
from slambench.reference import pose_graph as pgo_ref
from slambench.reference import trajectory

FINGERPRINT = (slice(None, None, 37), slice(None, None, 41))


class FrameIndex:
    """Finds which of the benchmark's frames a program's [0, 1] image is."""

    def __init__(self, frames):
        self.stacks = {"left": frames.left, "right": frames.right}
        self.keys = {}
        for side, st in self.stacks.items():
            fp = st[(slice(None),) + FINGERPRINT].reshape(st.shape[0], -1).cpu().numpy()
            for f in range(st.shape[0]):
                self.keys.setdefault(fp[f].tobytes(), []).append((side, f))

    def find(self, img: torch.Tensor):
        """The (H, W) uint8 frame whose scaled copy `img` is, or None."""
        q = torch.clamp(torch.round(img.float() * 255.0), 0, 255).to(torch.uint8)
        for side, f in self.keys.get(q[FINGERPRINT].reshape(-1).cpu().numpy().tobytes(), []):
            if torch.equal(q, self.stacks[side][f].to(q.device)):
                return self.stacks[side][f]
        return None


def unit(frame: torch.Tensor, device) -> torch.Tensor:
    return frame.to(device).float() / 255.0


class Context(NamedTuple):
    """What a site's ``numbers`` may read besides its samples."""

    index: FrameIndex  # the benchmark's frames, found from a program's image
    centers: list | None  # the vocabulary's centres by level (full SLAM)
    conf: dict | None  # the configuration file
    device: str


def _rel(T: np.ndarray) -> np.ndarray:
    """(F, 4, 4) poses -> (F - 1, 4, 4) motions T_{i-1}^-1 T_i."""
    T = np.asarray(T, np.float64)
    return np.linalg.inv(T[:-1]) @ T[1:]


def step_errors(est: np.ndarray, gt: np.ndarray) -> np.ndarray:
    """(F - 1,) translation errors of each frame's motion against the truth."""
    E = np.linalg.inv(_rel(gt[: len(est)])) @ _rel(est)
    return np.linalg.norm(E[:, :3, 3], axis=1)


def session_numbers(sessions, gt: np.ndarray, n_frames: int, conf: dict, device="cpu"):
    """The compared numbers of the sessions' poses, closures, loop edges
    and pose graph, and what the log shows beside them; a lane driver's
    session is each of its lanes."""
    revisit_m = conf.get("revisit_m")
    nums = {"sessions_raised": 0, "poses_missing": 0, "ate_session_max_m": 0.0,
            "step_err_p50_m": 0.0}
    info = {"ate_m": [], "ate_odo_m": [], "step_err_max_m": [], "closures": [],
            "identity_edges": 0, "pgo_gap_m": []}
    if revisit_m is not None:
        nums.update(closures_off_revisit=0, loop_edge_err_m=0.0, pgo_cost_left=0.0)
    for s in flatten(sessions):
        nums["sessions_raised"] += s.error is not None
        n = len(s.trajectory)
        nums["poses_missing"] += max(n_frames - n, 0)
        if n >= 3:
            ate = trajectory.ate_rmse(s.trajectory, gt[:n])
            nums["ate_session_max_m"] = max(nums["ate_session_max_m"], ate)
            steps = step_errors(s.trajectory, gt)
            nums["step_err_p50_m"] = max(nums["step_err_p50_m"], float(np.median(steps)))
            info["ate_m"].append(ate)
            info["step_err_max_m"].append(float(steps.max()))
        if revisit_m is None:
            continue
        info["closures"].append(list(s.closures))
        for q, m in s.closures:
            if np.linalg.norm(gt[q, :3, 3] - gt[m, :3, 3]) > revisit_m:
                nums["closures_off_revisit"] += 1
        for i, j, Z in s.loop_edges or []:
            if np.allclose(Z, np.eye(4)):
                info["identity_edges"] += 1
                continue
            true = np.linalg.inv(gt[i]) @ gt[j]
            nums["loop_edge_err_m"] = max(nums["loop_edge_err_m"],
                                          float(np.linalg.norm(Z[:3, 3] - true[:3, 3])))
        if s.trajectory_odo is None or n != len(s.trajectory_odo) or n < 3:
            continue  # the poses missing are counted above
        info["ate_odo_m"].append(trajectory.ate_rmse(s.trajectory_odo, gt[:n]))
        if not s.loop_edges:
            continue
        chain = torch.as_tensor(np.asarray(s.trajectory_odo), device=device)
        ref = pgo_ref.optimize(chain, s.loop_edges, int(conf["sizes"]["pgo_iters"]))
        got = torch.as_tensor(np.asarray(s.trajectory), device=device)
        costs = [pgo_ref.cost(T, chain, s.loop_edges) for T in (got, ref, chain)]
        left = (costs[0] - costs[1]) / max(costs[2] - costs[1], 1e-300)
        nums["pgo_cost_left"] = max(nums["pgo_cost_left"], left)
        gap = (got.to(ref.dtype)[:, :3, 3] - ref[:, :3, 3]).norm(dim=1).max()
        info["pgo_gap_m"].append(float(gap))
    return nums, info


def compare(sessions, frames, recorder, centers, conf: dict, device="cpu"):
    """All compared numbers of a run, and what the log shows beside them:
    the sessions', then each installed site's over its sample."""
    nums, info = session_numbers(sessions, frames.gt, len(frames), conf, device)
    ctx = Context(FrameIndex(frames), centers, conf, device)
    for tap in recorder.taps.values():
        if tap.sample.items:
            nums.update(tap.site.numbers(tap.sample.items, ctx))
    return nums, info


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}}) for
    the numbers the cell's file gives a limit; one of them that the run
    did not produce fails.  The other numbers are the log's."""
    checks = {k: {"value": nums.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
