"""Tracing / profiling utilities.

Port of ``ros_stereo_slam_tpu/utils/profiling.py``: :class:`StageTimer`
and :class:`FpsMeter` are verbatim; :func:`trace` wraps ``torch.profiler``
where the reference wraps ``jax.profiler``.  The reference C++ system's
only instrumentation is one chrono FPS counter around the frame body
(``reference/src/VisualSLAM.cpp:50-52,184-189``).  Here:

- :class:`StageTimer` — named wall-clock stage accumulators with JSONL
  dump (per-frame or per-run);
- :class:`FpsMeter` — exponential moving frames/s (the Pangolin menu's
  live FPS, ``src/GLrender.cpp:291``);
- :func:`trace` — context manager around a ``torch.profiler`` capture of
  the host and, where a card is present, the device, exported as a
  Chrome trace (open it in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from dataclasses import dataclass, field


class StageTimer:
    """Accumulates wall-clock per named stage; remembers call counts."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: {
                "total_s": round(self.totals[name], 4),
                "calls": self.counts[name],
                "mean_ms": round(1e3 * self.totals[name] / max(self.counts[name], 1), 3),
            }
            for name in sorted(self.totals)
        }

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@dataclass
class FpsMeter:
    alpha: float = 0.1
    fps: float = field(default=0.0, init=False)
    _last: float | None = field(default=None, init=False)

    def tick(self) -> float:
        now = time.perf_counter()
        if self._last is not None:
            inst = 1.0 / max(now - self._last, 1e-9)
            self.fps = inst if self.fps == 0.0 else (
                self.alpha * inst + (1 - self.alpha) * self.fps
            )
        self._last = now
        return self.fps


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block into
    ``{log_dir}/trace.json`` (Chrome trace format).  Records CUDA activity
    when a card is present; the profile object is yielded, so a caller can
    also read ``key_averages()``."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
