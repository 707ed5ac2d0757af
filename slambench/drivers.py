"""The program's entry points that a traffic mix drives, found by name,
and what they share.

A mix's ``driver`` names a file, ``slambench/entries/<driver>.py``, that
exposes ``Driver(cfg, voc, device)``: it takes the pipeline configuration,
the vocabulary (or None) and the device, and runs whole sessions
(``session(left, right)``) over the mix's (F, H, W) uint8 frames.  A
session gives a :class:`Session`: every frame's pose, whether it was
tracked, and, for full SLAM, the closures accepted, the odometry chain
before the pose graph and the loop edges the pose graph was given.  A
driver that runs lanes (one drive of the mix's frames each) gives a list
of Sessions, one a lane, and sets ``lanes`` to their number; every lane
is counted and checked as a session of its own (:func:`flatten`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


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


def make(name: str, cfg, voc, device, bench_dir: Path = HERE):
    """The driver of ``<bench_dir>/entries/<name>.py`` on `cfg`, the
    vocabulary `voc` (or None) and `device`; for a name with no file, an
    error that lists the files."""
    from slambench import manifest

    return manifest.find(Path(bench_dir) / "entries", name, "driver").Driver(cfg, voc, device)


def flatten(results) -> list[Session]:
    """Every :class:`Session` of driver sessions' results, in order: a
    result is one Session, or a lane driver's list of them."""
    return [s for r in results for s in (r if isinstance(r, list) else [r])]


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
