"""The traced window: a ``torch.profiler`` capture of one session, reduced
to what the per-layer metrics read.

The capture covers the window's first session and records device
activity only (kernels, copies, sets, and the CUDA runtime calls that
launched them): recording every host op as well slows the launch-bound
host path about tenfold.  The span the benchmark opens itself
(``slambench.session``) is taken on the host's clock (``time.time_ns``),
the clock the profiler gives its events in.  The record holds:

- ``window_ns``: the session span; ``window_s``: its length;
- ``kernels``: (name, start, duration) of every device kernel in it
  (memory copies and sets excluded, as ``tools/torch_kernel_count.py``
  counts), ``copies``: how many copies and sets there were;
- ``busy``: the union of all device activity, as merged intervals;
- ``host_ops``: the host-side events (runtime calls), for the idle gaps'
  attribution;
- ``spans``: the program's own spans inside the session span
  (``ros_stereo_slam_tpu_torch/utils/profiling.py``: ``Span`` tuples with
  their ids, parents and attributes), which record while the capture is
  active; a count the program takes at a boundary reaches the readers as
  a span attribute.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

SESSION_SPAN = "slambench.session"
NAME_LEN = 120  # characters of a kernel or op name kept in the breakdown
INNER_STEPS = 64


class Capture:
    def __init__(self):
        self.prof = None
        self.spans: list = []  # (name, start ns, end ns) on the host's clock

    def start(self) -> None:
        """Start recording: the device's activity (the host's ops where no
        card is present, as in the CPU tests)."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        self.spans = []
        act = ProfilerActivity.CUDA if torch.cuda.is_available() else ProfilerActivity.CPU
        self.prof = profile(activities=[act])
        self.prof.__enter__()

    def stop(self) -> dict:
        from ros_stereo_slam_tpu_torch.utils import profiling

        self.prof.__exit__(None, None, None)
        rec = reduce(self.prof.profiler.kineto_results.events(), self.spans)
        self.prof = None
        rec["spans"] = profiling.spans(*rec["window_ns"])
        return rec

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))


def merge(intervals: np.ndarray) -> np.ndarray:
    """(n, 2) [start, end) intervals -> their union, sorted and disjoint."""
    if len(intervals) == 0:
        return np.zeros((0, 2), np.int64)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.append(np.nonzero(new)[0][1:] - 1, len(iv) - 1)
    return np.stack([starts, ends[last]], 1)


def covered(union: np.ndarray, lo: int, hi: int) -> int:
    """Nanoseconds of [lo, hi) that the merged intervals cover."""
    if hi <= lo or len(union) == 0:
        return 0
    s, e = np.clip(union[:, 0], lo, hi), np.clip(union[:, 1], lo, hi)
    return int((e - s).sum())


def reduce(events, spans) -> dict:
    """Kineto events and the benchmark's spans -> the record the metric
    readers take."""
    from torch.autograd import DeviceType

    kernels, copies, dev_iv, host_ops = [], 0, [], []
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        if e.is_user_annotation() or name.startswith("slambench."):
            continue
        if e.device_type() == DeviceType.CUDA:
            dev_iv.append((start, start + dur))
            if name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels.append((name, start, dur))
        else:
            host_ops.append((name, start, dur))
    windows = [(s, e) for n, s, e in spans if n == SESSION_SPAN]
    if not windows:
        raise RuntimeError(f"no {SESSION_SPAN} span in the capture")
    window = windows[0]
    busy = merge(np.asarray(dev_iv, np.int64).reshape(-1, 2))
    return {"window_ns": window, "window_s": (window[1] - window[0]) * 1e-9,
            "kernels": kernels, "copies": copies, "busy": busy,
            "busy_s": covered(busy, *window) * 1e-9, "host_ops": host_ops}


def device_ops(rec: dict, top: int = 10) -> list:
    """[[kernel name, seconds]] of the device kernels that took most time."""
    tot: dict = {}
    for name, _, dur in rec["kernels"]:
        tot[name] = tot.get(name, 0) + dur
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:NAME_LEN], d * 1e-9] for n, d in best]


def idle_gaps(rec: dict, top: int = 10) -> list:
    """[[host event, seconds]]: the device's idle time inside the window,
    each gap charged to the innermost host-side event (a runtime call)
    running at its middle ("host: no runtime call" where none was: Python
    and PyTorch's dispatch), summed by name, the largest first."""
    lo, hi = rec["window_ns"]
    busy = rec["busy"]
    edges = np.concatenate([[lo], np.clip(busy.ravel(), lo, hi), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    if len(gaps) == 0:
        return []
    ops = sorted(rec["host_ops"], key=lambda o: o[1])
    starts = np.array([o[1] for o in ops], np.int64)
    ends = np.array([o[1] + o[2] for o in ops], np.int64)
    tot: dict = {}
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        j = int(np.searchsorted(starts, mid, side="right")) - 1
        name = "host: no runtime call"
        # the innermost op holding `mid` is the latest-starting one that
        # does; look back over at most INNER_STEPS ops
        for jj in range(j, max(j - INNER_STEPS, -1), -1):
            if ends[jj] > mid:
                name = ops[jj][0]
                break
        tot[name] = tot.get(name, 0) + int(g1 - g0)
    best = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:NAME_LEN], d * 1e-9] for n, d in best]
