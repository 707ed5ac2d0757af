"""``models/pipeline.py::run_offline``: odometry over a recorded drive."""

import numpy as np

from slambench.drivers import Session


class Driver:
    def __init__(self, cfg, voc, device):
        self.cfg, self.device = cfg, device

    def session(self, left, right) -> Session:
        from ros_stereo_slam_tpu_torch.models import pipeline

        res = pipeline.run_offline(self.cfg, left, right, device=self.device)
        return Session(res.trajectory, np.concatenate([[True], res.tracking_ok]))
