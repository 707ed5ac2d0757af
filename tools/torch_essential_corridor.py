#!/usr/bin/env python3
"""The essential matrix on the bench corridor's frames 0 -> 1, on a host
CPU, through both packages.

    JAX_PLATFORMS=cpu python3 tools/torch_essential_corridor.py [--keys 10]

Tracks ``chip_smoke.py``'s grid (``preset_odometry()``: 768 slots) from
corridor frame 0 to frame 1 at 1241x376 with the port's LK, then runs the
JAX package's ``monocular_triangulate`` with ``PRNGKey(k)`` for each key
and the port's solve (``_essential_from_sets``) on the same minimal sets.
Prints one JSON line per key: each package's inliers, rotation error
against ground truth (degrees) and |t . t_gt|, and the inliers of the
ground-truth essential matrix at the same 1 px threshold.  Forward motion
down a corridor leaves E poorly conditioned: this is the spread that
``chip_smoke.py`` phase essential holds the LK-track run to.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--keys", type=int, default=10)
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    import chip_smoke
    from ros_stereo_slam_tpu.ops import essential as jess
    from ros_stereo_slam_tpu.ops import ransac as jransac
    from ros_stereo_slam_tpu.utils.camera import Pinhole as JPinhole
    from ros_stereo_slam_tpu_torch.config import CameraConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld
    from ros_stereo_slam_tpu_torch.ops import essential

    cam = CameraConfig()
    world = SyntheticWorld(camera=cam, n_frames=chip_smoke.FRAMES + 1, seed=11, half_w=18.0)
    pts1, pts2, m = (x.numpy() for x in chip_smoke.corridor_tracks(
        torch, world.render(0)[0], world.render(1)[0], cam, "cpu"))
    T21 = np.linalg.inv(world.poses[1]) @ world.poses[0]
    t_gt = T21[:3, 3] / np.linalg.norm(T21[:3, 3])
    pin, jpin = chip_smoke.pinhole(cam), JPinhole(
        fx=jnp.float32(cam.fx), fy=jnp.float32(cam.fy), cx=jnp.float32(cam.cx),
        cy=jnp.float32(cam.cy))

    def rot_err(R):
        return float(np.degrees(np.arccos(np.clip((np.trace(T21[:3, :3].T @ R) - 1) / 2,
                                                  -1, 1))))

    tx = np.array([[0, -T21[2, 3], T21[1, 3]], [T21[2, 3], 0, -T21[0, 3]],
                   [-T21[1, 3], T21[0, 3], 0]])
    E = tx @ T21[:3, :3]
    x1 = np.stack([(pts1[:, 0] - cam.cx) / cam.fx, (pts1[:, 1] - cam.cy) / cam.fy,
                   np.ones(len(m))], 1)
    x2 = np.stack([(pts2[:, 0] - cam.cx) / cam.fx, (pts2[:, 1] - cam.cy) / cam.fy,
                   np.ones(len(m))], 1)
    Fx1, Ftx2 = x1 @ E.T, x2 @ E
    err = np.sum(x2 * Fx1, 1) ** 2 / (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2 + Ftx2[:, 0] ** 2
                                      + Ftx2[:, 1] ** 2)
    gt_inliers = int(((err < (1.0 / cam.fx) ** 2) & m).sum())
    for k in range(args.keys):
        key = jax.random.PRNGKey(k)
        jer, jrp = jess.monocular_triangulate(key, jpin, jnp.asarray(pts1), jnp.asarray(pts2),
                                              jnp.asarray(m), 1.0, 256)
        idx = np.array(jransac._sample_minimal_sets(key, jnp.asarray(m), 256, 8))
        t = [torch.from_numpy(x) for x in (pts1, pts2, m)]
        er = essential._essential_from_sets(torch.from_numpy(idx), pin, *t, 1.0)
        rp = essential.recover_pose(er.E, pin, *t[:2], er.inliers)
        print(json.dumps({
            "key": k, "valid": int(m.sum()), "gt_inliers": gt_inliers,
            "jax_inliers": int(jer.n_inliers), "jax_rot_deg": rot_err(np.asarray(jrp.R)),
            "jax_t_dot": abs(float(np.asarray(jrp.t) @ t_gt)),
            "port_inliers": int(er.n_inliers), "port_rot_deg": rot_err(rp.R.numpy()),
            "port_t_dot": abs(float(rp.t.double().numpy() @ t_gt))}), flush=True)


if __name__ == "__main__":
    main()
