"""``models/slam_scan.py::run_offline_slam``: the scan posture of full SLAM
over a recorded drive (frame loop, then the closures' epilogue)."""

import numpy as np

from slambench.drivers import Session


class Driver:
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
