"""The program's entry points that a traffic mix drives, found by name.

A mix's ``driver`` names one of :data:`DRIVERS`.  Each takes the pipeline
configuration, the vocabulary (or None) and the device, and runs whole
sessions (:meth:`session`).  A session gives a :class:`Session`: every
frame's pose, whether it was tracked, and, for full SLAM, the closures
accepted, the odometry chain before the pose graph and the loop edges
the pose graph was given.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Session:
    trajectory: np.ndarray  # (F, 4, 4) world-from-camera, frame 0 = identity
    tracking_ok: np.ndarray  # (F,) bool, frame 0 included
    closures: list = field(default_factory=list)  # accepted (query, match)
    error: str | None = None  # the exception that ended the session early
    trajectory_odo: np.ndarray | None = None  # (F, 4, 4) before the pose graph
    loop_edges: list | None = None  # (i, j, (4, 4) Z) edges given to the pose graph


def pipeline_config(config: dict, overrides: dict, seed: int):
    """The configuration file's preset, camera and overrides, then the
    mix's `overrides` ({section: {field: value}} or {field: value}), with
    the program's own seed (RANSAC's draws) set to `seed`."""
    from ros_stereo_slam_tpu_torch import config as cfg_mod

    cam = {k: v for k, v in config["camera"].items() if k != "rate_hz"}
    cfg = cfg_mod.PRESETS[config["preset"]]().replace(camera=cfg_mod.CameraConfig(**cam))
    for ov in (config.get("overrides", {}), overrides):
        for key, val in ov.items():
            if isinstance(val, dict):
                cfg = cfg.replace(**{key: dataclasses.replace(getattr(cfg, key), **val)})
            else:
                cfg = cfg.replace(**{key: val})
    return cfg.replace(seed=int(seed))


def program_vocabulary(centers, idf, k: int):
    """The tables as the program loads a vocabulary file."""
    from ros_stereo_slam_tpu_torch.models import vocab

    return vocab.Vocabulary(k=k, levels=len(centers), centers=list(centers), idf=idf)


class RunOffline:
    """``models/pipeline.py::run_offline``: odometry over a recorded drive."""

    def __init__(self, cfg, voc, device):
        self.cfg, self.device = cfg, device

    def session(self, left, right) -> Session:
        from ros_stereo_slam_tpu_torch.models import pipeline

        res = pipeline.run_offline(self.cfg, left, right, device=self.device)
        return Session(res.trajectory, np.concatenate([[True], res.tracking_ok]))


class RunOfflineSlam:
    """``models/slam_scan.py::run_offline_slam``: the scan posture of full
    SLAM over a recorded drive (frame loop, then the closures' epilogue)."""

    def __init__(self, cfg, voc, device):
        self.cfg, self.voc, self.device = cfg, voc, device

    def session(self, left, right) -> Session:
        from ros_stereo_slam_tpu_torch.models import slam_scan

        res = slam_scan.run_offline_slam(self.cfg, self.voc, left, right, device=self.device)
        return Session(res.trajectory, np.concatenate([[True], res.tracking_ok]),
                       [(int(q), int(m)) for q, m, _ in res.loop_events],
                       trajectory_odo=res.trajectory_odo,
                       loop_edges=[(int(i), int(j), np.asarray(Z)) for i, j, Z in
                                   (res.loop_edges or [])])


DRIVERS = {"run_offline": RunOffline, "run_offline_slam": RunOfflineSlam}


def make(name: str, cfg, voc, device):
    if name not in DRIVERS:
        raise ValueError(f"unknown driver {name!r}; known: {sorted(DRIVERS)}")
    return DRIVERS[name](cfg, voc, device)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
