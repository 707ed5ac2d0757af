"""Small records for the per-layer readers' own test cases (a reader's
``EXAMPLE``), and the record with nothing to read, on which every reader
gives None."""

from __future__ import annotations

import numpy as np

MS = 1_000_000  # ns


def record() -> dict:
    """A traced session of 100 ms over two frames.  The device: 4 kernels
    (two of K1, with their bounds), busy 30 ms.  The program's spans:
    ``driver.session`` 1-99 ms holding ``step.frame`` 2-30 (a ``host_read``
    10-12 in it) and 50-70, ``detect.frame`` 30-40 and ``epilogue`` 75-95
    (a ``host_read`` 80-84 in it); a ``step.frame`` outside the session
    (a warm-up's) is no layer of it."""
    from ros_stereo_slam_tpu_torch.utils.profiling import Span

    busy = np.array([[10, 20], [40, 50], [70, 80]], np.int64) * MS
    kernels = [("lk_level_kernel<4, 2>", 10 * MS, 5 * MS), ("lk_level_kernel<4, 2>", 15 * MS, 5 * MS),
               ("elementwise", 40 * MS, 10 * MS), ("reduce", 70 * MS, 10 * MS)]
    t = {"window_ns": (0, 100 * MS), "window_s": 0.1, "kernels": kernels, "copies": 1,
         "busy": busy, "busy_s": 0.03,
         "host_ops": [("aten::mul", 20 * MS, 15 * MS), ("cudaLaunchKernel", 25 * MS, 2 * MS)]}
    spans = [Span(name, a * MS, b * MS, i, parent, {}) for name, a, b, i, parent in (
        ("host_read", 10, 12, 2, 1), ("step.frame", 2, 30, 1, 0), ("detect.frame", 30, 40, 3, 0),
        ("step.frame", 50, 70, 4, 0), ("host_read", 80, 84, 6, 5), ("epilogue", 75, 95, 5, 0),
        ("driver.session", 1, 99, 0, None), ("step.frame", 200, 300, 7, None))]
    t["spans"] = spans
    work = [{"bound_s": 0.0005}, {"bound_s": 0.0005}]
    return {"trace": t, "spans": spans, "frames": 2, "k1_work": work}


def empty() -> dict:
    """A traced record with nothing in it: no frame, kernel, span or work."""
    t = {"window_ns": (0, 0), "window_s": 0.0, "kernels": [], "copies": 0,
         "busy": np.zeros((0, 2), np.int64), "busy_s": 0.0, "host_ops": [], "spans": []}
    return {"trace": t, "spans": [], "frames": 0, "k1_work": []}
