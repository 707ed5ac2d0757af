#!/usr/bin/env python3
"""The frontend choices on the bench corridor at half KITTI size, on a
host CPU, through both packages' ``run_offline``.

    JAX_PLATFORMS=cpu python3 tools/torch_frontend_halfsize.py

Renders the corridor of ``chip_smoke.py`` (seed 11, 49 frames) at 620x188
with the port's renderer and runs ``preset_odometry()`` with the default
frontend and with ``chip_smoke.REFERENCE_FRONTEND`` and
``chip_smoke.ORB_STEREO``, once through the JAX package and once through
the port on the CPU.  Prints one JSON line per frontend: each package's
ATE, keyframes, whether every frame was tracked, and its seconds (the
JAX ones include its compile).  The half size keeps the run small enough
for a shared host CPU.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path.insert(0, str(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    import chip_smoke
    from ros_stereo_slam_tpu.config import CameraConfig as JCamera
    from ros_stereo_slam_tpu.config import preset_odometry as j_preset
    from ros_stereo_slam_tpu.models.pipeline import run_offline as j_run_offline
    from ros_stereo_slam_tpu_torch.config import CameraConfig, preset_odometry
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld
    from ros_stereo_slam_tpu_torch.models import pipeline
    from ros_stereo_slam_tpu_torch.utils import metrics

    cam_kw = dict(fx=718.856 / 2, fy=718.856 / 2, cx=607.1928 / 2, cy=185.2157 / 2,
                  width=620, height=188)
    cam, jcam = CameraConfig(**cam_kw), JCamera(**cam_kw)
    world = SyntheticWorld(camera=cam, n_frames=chip_smoke.FRAMES + 1, seed=11, half_w=18.0)
    frames = [world.render(i) for i in range(world.n_frames)]
    L = np.stack([f[0] for f in frames])
    R = np.stack([f[1] for f in frames])
    for name, overrides in (("default", {}), ("reference_frontend", chip_smoke.REFERENCE_FRONTEND),
                            ("orb_stereo", chip_smoke.ORB_STEREO)):
        t, j = preset_odometry(), j_preset()
        tcfg = t.replace(camera=cam, frontend=dataclasses.replace(t.frontend, **overrides))
        jcfg = dataclasses.replace(j, camera=jcam,
                                   frontend=dataclasses.replace(j.frontend, **overrides))
        row = {"frontend": name, "size": f"{cam.width}x{cam.height}", "frames": world.n_frames}
        for pkg, run in (("jax", lambda: j_run_offline(jcfg, L, R)),
                         ("port", lambda: pipeline.run_offline(tcfg, L, R, device="cpu"))):
            t0 = time.perf_counter()
            res = run()
            row.update({f"{pkg}_ate_m": metrics.ate_rmse(res.trajectory, world.poses),
                        f"{pkg}_keyframes": 1 + int(res.is_keyframe.sum()),
                        f"{pkg}_all_tracked": bool(res.tracking_ok.all()),
                        f"{pkg}_s": time.perf_counter() - t0})
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
