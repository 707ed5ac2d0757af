"""Windowed bundle adjustment, one window's solve
(``models/bundle_adjust.ba_solve``, called lane by lane through its
module by ``models/step.py::_ba_refine``).

Sampled: calls without a mesh, with their inputs (camera, poses,
landmarks, observations and mask, the fixed poses, iterations, damping,
Huber threshold) and outputs.  The plain dense reference
(:mod:`slambench.reference.ba`, float64) solves the same window.
Numbers:

- ``ba_pose_gap_m``: the widest gap between a free pose's refined camera
  centre and the reference's;
- ``ba_landmark_gap_rel``: the widest gap between a refined landmark and
  the reference's, over its depth (the least z of the views that observe
  it, in the reference's window), over landmarks observed in 2 or more
  views;
- ``ba_rms_gap_px``: the widest gap between the final reprojection RMS
  and the reference's;
- ``ba_accept_flips``: sampled solves where the program kept its input
  and the reference did not, or the other way round (a refinement equal
  to the input counts as kept).

The reference follows the program's window: which window BA is given is
not the benchmark's choice.
"""

import torch

from slambench.record import copy
from slambench.reference import ba as ba_ref

TARGET = ("models.bundle_adjust", "ba_solve")


def wrap(orig, tap):
    def ba_solve(cam, T_cw, landmarks, obs, obs_mask, fixed, iters=10, damping=1e-4,
                 huber_px=2.0, mesh=None):
        out = orig(cam, T_cw, landmarks, obs, obs_mask, fixed, iters=iters, damping=damping,
                   huber_px=huber_px, mesh=mesh)
        if tap.active and mesh is None:
            tap.calls += 1
            tap.offer(lambda: dict(
                cam=tuple(float(v) for v in cam), T_cw=copy(T_cw), landmarks=copy(landmarks),
                obs=copy(obs), obs_mask=copy(obs_mask), fixed=copy(fixed), iters=int(iters),
                damping=float(damping), huber_px=float(huber_px),
                out=tuple(copy(t) for t in out[:4])))
        return out
    return ba_solve


def reference(s, dtype=torch.float64) -> ba_ref.Result:
    """The reference's solve of a sampled call's window, in `dtype`."""
    return ba_ref.solve(s["cam"], s["T_cw"], s["landmarks"], s["obs"], s["obs_mask"], s["fixed"],
                        s["iters"], s["damping"], s["huber_px"], dtype)


def _centres(T: torch.Tensor) -> torch.Tensor:
    T = T.double()
    return -(T[:, :3, :3].transpose(1, 2) @ T[:, :3, 3:])[..., 0]


def numbers(items, ctx) -> dict:
    pose, lm, rms, flips = 0.0, 0.0, 0.0, 0
    for s in items:
        ref = reference(s)
        T, X, _, rms_after = s["out"]
        free = ~s["fixed"].bool()
        if bool(free.any()):
            pose = max(pose, float((_centres(T) - _centres(ref.T_cw))[free].norm(dim=1).max()))
        mask = s["obs_mask"].bool()
        z = (torch.einsum("wij,nj->wni", ref.T_cw[:, :3, :3], ref.landmarks)
             + ref.T_cw[:, None, :3, 3])[..., 2]
        depth = torch.where(mask & (z > ba_ref.Z_MIN), z, torch.inf).min(0).values
        seen = (mask.sum(0) >= 2) & torch.isfinite(depth)
        if bool(seen.any()):
            gap = (X.double() - ref.landmarks).norm(dim=1) / depth
            lm = max(lm, float(gap[seen].max()))
        rms = max(rms, abs(float(rms_after) - float(ref.rms_after)))
        kept = torch.equal(T, s["T_cw"]) and torch.equal(X, s["landmarks"])
        ref_kept = not ref.accepted or (
            torch.equal(ref.T_cw.to(s["T_cw"].dtype), s["T_cw"])
            and torch.equal(ref.landmarks.to(s["landmarks"].dtype), s["landmarks"]))
        flips += kept != ref_kept
    return {"ba_pose_gap_m": pose, "ba_landmark_gap_rel": lm, "ba_rms_gap_px": rms,
            "ba_accept_flips": flips}
