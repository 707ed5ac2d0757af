"""Faults planted under the timed path, for the controls of ``correct``.

Each ``plant_*`` takes a pytest-style ``monkeypatch`` (anything with
``setattr(obj, name, value)`` that undoes itself) and breaks the program
where the output is produced, so a run sees what a faulty program would
give it.  A cell can have these faults: a step that returns its state
unchanged (every pose the first one), half of the batch left out (a
session's poses for half its frames; K1 tracking every other point and
returning the others' guesses), and an answer altered where it is
produced (a K1 track, a K2 descriptor, a K3 word, a closure's match),
and for full SLAM the pose graph's optimization skipped.  One
card runs each cell, so no exchange between chips can be left out.
``slambench/control.py`` reads each of them on the card.
"""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np
import torch

PKG = "ros_stereo_slam_tpu_torch"


def _mod(name: str):
    return importlib.import_module(f"{PKG}.{name}")


def plant_state_unchanged(mp) -> None:
    """Every entry returns frame 0's pose for every frame."""
    pipeline, slam_scan = _mod("models.pipeline"), _mod("models.slam_scan")

    def frozen(traj):
        return np.repeat(np.asarray(traj)[:1], len(traj), axis=0)

    run_offline, run_offline_slam = pipeline.run_offline, slam_scan.run_offline_slam

    def odo(*a, **k):
        r = run_offline(*a, **k)
        return dataclasses.replace(r, trajectory=frozen(r.trajectory))

    def scan(*a, **k):
        r = run_offline_slam(*a, **k)
        return dataclasses.replace(r, trajectory=frozen(r.trajectory))

    mp.setattr(pipeline, "run_offline", odo)
    mp.setattr(slam_scan, "run_offline_slam", scan)


def plant_k1_half(mp) -> None:
    """K1 tracks only every other point; the rest keep their guesses."""
    lk_cuda = _mod("ops.lk_cuda")
    orig = lk_cuda.track_level

    def track_level(ref_img, cur_img, ref_pts, guesses, params):
        pts, resid, ok = orig(ref_img, cur_img, ref_pts, guesses, params)
        pts = pts.clone()
        pts[1::2] = guesses[1::2]
        return pts, resid, ok

    mp.setattr(lk_cuda, "track_level", track_level)


def plant_k1_altered(mp) -> None:
    """K1 moves one tracked point of each call by a pixel: of the points
    inside the image, the one with the least residual (a settled answer)."""
    lk_cuda = _mod("ops.lk_cuda")
    orig = lk_cuda.track_level

    def track_level(ref_img, cur_img, ref_pts, guesses, params):
        pts, resid, ok = orig(ref_img, cur_img, ref_pts, guesses, params)
        return _moved(pts, resid, ok, ref_img.shape), resid, ok

    mp.setattr(lk_cuda, "track_level", track_level)


def plant_k2_altered(mp) -> None:
    """K2 inverts the descriptor of each call's first valid corner."""
    orb_cuda, orb = _mod("ops.orb_cuda"), _mod("ops.orb")
    orig = orb_cuda.level_describe

    def level_describe(img, pts, valid):
        sign, m, packed = orig(img, pts, valid)
        sign = _invert_first(sign, valid)
        return sign, m, orb.pack_bits((sign > 0) & valid[..., None])

    mp.setattr(orb_cuda, "level_describe", level_describe)


def plant_k3_altered(mp) -> None:
    """K3 gives each call's first descriptor the next word."""
    vocab_cuda = _mod("ops.vocab_cuda")
    orig = vocab_cuda.descend

    def descend(q_bits, valid, tree, k, upto):
        out = orig(q_bits, valid, tree, k, upto).clone()
        out[:1] = (out[:1] // k) * k + (out[:1] % k + 1) % k
        return out

    mp.setattr(vocab_cuda, "descend", descend)


def plant_closure_altered(mp) -> None:
    """Every accepted closure names a match 20 frames off."""
    slam_scan = _mod("models.slam_scan")
    orig = slam_scan.run_offline_slam

    def run_offline_slam(*a, **k):
        r = orig(*a, **k)
        return dataclasses.replace(r, loop_events=[(q, m + 20, n) for q, m, n in r.loop_events])

    mp.setattr(slam_scan, "run_offline_slam", run_offline_slam)


def plant_poses_half(mp) -> None:
    """Every entry returns the poses of the first half of its frames."""
    pipeline, slam_scan = _mod("models.pipeline"), _mod("models.slam_scan")
    run_offline, run_offline_slam = pipeline.run_offline, slam_scan.run_offline_slam

    def half(r):
        return dataclasses.replace(r, trajectory=np.asarray(r.trajectory)[: len(r.trajectory) // 2])

    mp.setattr(pipeline, "run_offline", lambda *a, **k: half(run_offline(*a, **k)))
    mp.setattr(slam_scan, "run_offline_slam", lambda *a, **k: half(run_offline_slam(*a, **k)))


def plant_pgo_skipped(mp) -> None:
    """The pose graph's optimization returns the poses it was given."""
    pose_graph = _mod("models.pose_graph")
    mp.setattr(pose_graph, "optimize", lambda poses, *a, **k: poses.clone())


PLANTS = {"state_unchanged": plant_state_unchanged, "poses_half": plant_poses_half,
          "k1_half": plant_k1_half, "k1_altered": plant_k1_altered,
          "k2_altered": plant_k2_altered, "k3_altered": plant_k3_altered,
          "closure_altered": plant_closure_altered, "pgo_skipped": plant_pgo_skipped}
# the faults a cell can have: the odometry entry has no detection or pose graph
SLAM_ONLY = ("k2_altered", "k3_altered", "closure_altered", "pgo_skipped")


def _moved(pts, resid, ok, shape):
    """`pts` with, of its ok points 20 px inside an image of `shape`, the
    one with the least residual (a settled answer) moved by a pixel."""
    from slambench.reference import lk as lk_ref

    pts = pts.clone()
    inside = ok & lk_ref.interior(pts, *shape[-2:], 20.0)
    if bool(inside.any()):
        r = torch.where(inside, resid.reshape(inside.shape).float(), torch.inf)
        pts[int(torch.argmin(r)), 0] += 1.0
    return pts


def _invert_first(sign, valid):
    """`sign` with the first valid row (of each lane) negated."""
    sign = sign.clone()
    flat, v = sign.reshape(-1, sign.shape[-1]), valid.reshape(-1)
    if bool(v.any()):
        i = int(v.nonzero()[0, 0])
        flat[i] = -flat[i]
    return sign
