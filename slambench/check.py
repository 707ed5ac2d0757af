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
- ``k1_unmatched`` / ``k2_unmatched``: sampled K1 / K2 calls whose
  full-size image is none of the session's frames as the benchmark made
  them (0): the start of the chain the reference does not follow;
- ``k1_gap_px``: the widest gap between a sampled K1 call's tracked points
  and the reference's on the same frames, points and guesses, over points
  both call tracked, that keep `reference.lk.BORDER_PX` inside the image
  and that converged in the reference (a point still moving after the
  last step walks where rounding takes it, on either side);
  ``k1_ok_flips``: the share of the points inside whose gate differs;
- ``k2_bits_differ``: the share of the valid corners' descriptor bits of
  the sampled K2 calls that differ from the reference's;
  ``k2_corner_bits_max``: the most bits of any one corner that differ;
- ``k3_words_differ``: sampled K3 words that differ from the reference
  descent over the benchmark's vocabulary tables (0).

The reference follows the program from its own state where the program's
choices are not the benchmark's to make: the points and guesses K1 is
given, the corners K2 is given, the descriptors K3 is given, the odometry
chain and the loop edges the pose graph is given.  The images, the
vocabulary and the ground truth are the benchmark's own; the chain is
held to the ground truth by itself (``step_err_p50_m``,
``ate_session_max_m``), the edges' pairs by ``closures_off_revisit``.
"""

from __future__ import annotations

import numpy as np
import torch

from slambench.reference import lk as lk_ref
from slambench.reference import orb as orb_ref
from slambench.reference import pose_graph as pgo_ref
from slambench.reference import trajectory
from slambench.reference import vocab as vocab_ref

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


def k1_numbers(samples, index) -> dict:
    unmatched, gaps, flips, n = 0, [0.0], 0, 0
    for s in samples:
        ref, cur = index.find(s["ref_img"]), index.find(s["cur_img"])
        if ref is None or cur is None:
            unmatched += 1
            continue
        dev = s["ref_pts"].device
        p = s["params"]
        pts, _, ok, conv = lk_ref.track_level(unit(ref, dev), unit(cur, dev), s["ref_pts"],
                                              s["guesses"], p.window, p.iters, p.walk_iters,
                                              p.eps, p.min_eig)
        kp, _, kok = s["out"]
        H, W = ref.shape
        inner = (lk_ref.interior(pts, H, W) & lk_ref.interior(kp, H, W)
                 & lk_ref.interior(s["guesses"], H, W) & lk_ref.interior(s["ref_pts"], H, W))
        both = inner & ok & kok & conv
        if bool(both.any()):
            gaps.append(float((pts - kp)[both].abs().max()))
        flips += int((ok != kok)[inner].sum())
        n += int(inner.sum())
    return {"k1_unmatched": unmatched, "k1_gap_px": max(gaps),
            "k1_ok_flips": flips / max(n, 1)}


def k2_numbers(samples, index) -> dict:
    unmatched, differ, bits, worst = 0, 0, 0, 0
    for s in samples:
        img = index.find(s["img"])
        if img is None:
            unmatched += 1
            continue
        dev = s["pts"].device
        ref = orb_ref.signs(unit(img, dev), s["pts"], s["valid"])
        v = s["valid"]
        per_corner = (ref[v] != s["out"][0][v]).sum(1)
        if per_corner.numel():
            differ += int(per_corner.sum())
            worst = max(worst, int(per_corner.max()))
        bits += int(v.sum()) * orb_ref.N_BITS
    return {"k2_unmatched": unmatched, "k2_bits_differ": differ / max(bits, 1),
            "k2_corner_bits_max": worst}


def k3_numbers(samples, centers) -> dict:
    differ = 0
    for s in samples:
        cs = [c.to(s["q_bits"].device) for c in centers[: s["upto"]]]
        ref = vocab_ref.words(s["q_bits"], s["valid"], cs, s["k"])
        differ += int((ref != s["out"]).sum())
    return {"k3_words_differ": differ}


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
    and pose graph, and what the log shows beside them."""
    revisit_m = conf.get("revisit_m")
    nums = {"sessions_raised": 0, "poses_missing": 0, "ate_session_max_m": 0.0,
            "step_err_p50_m": 0.0}
    info = {"ate_m": [], "ate_odo_m": [], "step_err_max_m": [], "closures": [],
            "identity_edges": 0, "pgo_gap_m": []}
    if revisit_m is not None:
        nums.update(closures_off_revisit=0, loop_edge_err_m=0.0, pgo_cost_left=0.0)
    for s in sessions:
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
    """All compared numbers of a run, and what the log shows beside them."""
    nums, info = session_numbers(sessions, frames.gt, len(frames), conf, device)
    index = FrameIndex(frames)
    s = recorder.samples
    if s["k1"].items:
        nums.update(k1_numbers(s["k1"].items, index))
    if s["k2"].items:
        nums.update(k2_numbers(s["k2"].items, index))
    if s["k3"].items and centers is not None:
        nums.update(k3_numbers(s["k3"].items, centers))
    return nums, info


def judge(nums: dict, limits: dict) -> tuple[bool, dict]:
    """(every limited number within its limit, {name: {value, limit}}) for
    the numbers the cell's file gives a limit; one of them that the run
    did not produce fails.  The other numbers are the log's."""
    checks = {k: {"value": nums.get(k), "limit": lim} for k, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
