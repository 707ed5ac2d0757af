"""Tracing / profiling utilities.

Port of ``ros_stereo_slam_tpu/utils/profiling.py``: :class:`FpsMeter` is
verbatim; :func:`trace` wraps ``torch.profiler`` where the reference wraps
``jax.profiler``; the spans replace the reference's ``StageTimer``.  The
reference C++ system's only instrumentation is one chrono FPS counter
around the frame body (``reference/src/VisualSLAM.cpp:50-52,184-189``).
Here:

- :func:`span` — the program's spans: named intervals of host time at
  its layer boundaries (drivers, frame step, detection, epilogue, the
  host's reads of the device), each with its parent span and a few
  attributes (the frame id, counts taken at that boundary).  Times come
  from ``time.time_ns()``, the clock ``torch.profiler`` stamps its
  events with, so the device activity of a capture lines up with the
  span that issued it.  A span never synchronises the device: its length
  is host time, issuing work plus any blocking read inside it.
- Spans record only while a ``torch.profiler`` capture is active in the
  process or inside :func:`tracing`.  Otherwise :func:`span` costs one
  flag check and returns a shared no-op context (no clock read).
- Recorded spans go to a bounded buffer that keeps the newest
  :data:`CAPACITY` and counts what it drops (:func:`spans`,
  :func:`dropped`); :func:`summary` keeps calls, total and self time per
  name over every span recorded since :func:`reset`, dropped ones
  included; :func:`dump` writes it as JSON (the CLIs' ``stages.json``).
- :class:`FpsMeter` — exponential moving frames/s (the Pangolin menu's
  live FPS, ``src/GLrender.cpp:291``);
- :func:`trace` — context manager around a ``torch.profiler`` capture of
  the host and, where a card is present, the device, exported as a
  Chrome trace with the program's spans in it (open it in Perfetto or
  ``chrome://tracing``).

Spans belong to the thread that opens them; the drivers open them from
one thread.
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import NamedTuple

from torch.autograd import profiler as _autograd_profiler

CAPACITY = 1 << 16  # spans the buffer keeps


class Span(NamedTuple):
    """One recorded span; `parent` is the enclosing span's `id` (None at
    the top)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    attrs: dict


_tracing = 0  # depth of open tracing() blocks
_open: list = []  # the open spans, innermost last
_buffer: deque = deque(maxlen=CAPACITY)
_recorded = 0
_next_id = 0
_totals: dict = {}  # name -> [calls, total ns, self ns]


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "start", "child")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        global _next_id
        self.id = _next_id
        _next_id += 1
        self.parent = _open[-1] if _open else None
        self.child = 0
        _open.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        global _recorded
        end = time.time_ns()
        _open.pop()  # `with` blocks exit innermost first
        dur = end - self.start
        parent = self.parent
        if parent is not None:
            parent.child += dur
        tot = _totals.get(self.name)
        if tot is None:
            tot = _totals[self.name] = [0, 0, 0]
        tot[0] += 1
        tot[1] += dur
        tot[2] += dur - self.child
        _buffer.append(Span(self.name, self.start, end, self.id,
                            None if parent is None else parent.id, self.attrs))
        _recorded += 1
        return False

    def set(self, **attrs) -> None:
        """Add attributes to the span."""
        self.attrs.update(attrs)


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


def span(name: str, **attrs):
    """A context manager that records `name` with `attrs` around its block
    (while spans record; else the shared no-op).  ``as sp`` gives
    ``sp.set(**attrs)`` for counts known only inside the block."""
    if _tracing or _autograd_profiler._is_profiler_enabled:
        return _Open(name, attrs)
    return _OFF


def annotate(**attrs) -> None:
    """Add `attrs` to the innermost open span (nothing when none is open)."""
    if _open:
        _open[-1].attrs.update(attrs)


@contextlib.contextmanager
def tracing():
    """Record spans inside the block, with or without a profiler capture."""
    global _tracing
    _tracing += 1
    try:
        yield
    finally:
        _tracing -= 1


def spans(lo_ns: int | None = None, hi_ns: int | None = None) -> list[Span]:
    """The buffered spans that lie inside [lo_ns, hi_ns], in the order they
    ended."""
    lo = -1 if lo_ns is None else lo_ns
    hi = float("inf") if hi_ns is None else hi_ns
    return [s for s in _buffer if s.start_ns >= lo and s.end_ns <= hi]


def dropped() -> int:
    """Spans recorded since :func:`reset` that the buffer no longer holds."""
    return _recorded - len(_buffer)


def summary() -> dict:
    """{name: {total_s, calls, mean_ms, self_ms}} over every span recorded
    since :func:`reset`; self time leaves out the spans directly inside."""
    return {
        name: {
            "total_s": round(tot * 1e-9, 4),
            "calls": calls,
            "mean_ms": round(tot * 1e-6 / calls, 3),
            "self_ms": round(own * 1e-6, 3),
        }
        for name, (calls, tot, own) in sorted(_totals.items())
    }


LAYERS = ("step.frame", "detect.frame", "epilogue")  # directly under driver.session


def per_frame(recorded: list[Span], frames: int) -> dict:
    """Host ms a frame of one driver session's spans (`recorded`, as
    :func:`spans` gives them for its window): ``driver.session``, each of
    :data:`LAYERS` that was recorded, ``driver.self`` (the session less
    the layers directly under it: staging, the stats read, Python between
    frames) and ``host_read`` (blocked on the device; it overlaps the
    others).  The layers and ``driver.self`` add up to the session.  {}
    where no session span was recorded."""
    top = [s for s in recorded if s.name == "driver.session"]
    if not top or not frames:
        return {}
    ids = {s.id for s in top}
    total: dict = {}
    for s in recorded:
        if s.name in ("driver.session", "host_read") or (s.name in LAYERS and s.parent in ids):
            total[s.name] = total.get(s.name, 0) + s.end_ns - s.start_ns
    total["driver.self"] = total["driver.session"] - sum(total.get(n, 0) for n in LAYERS)
    return {name: ns * 1e-6 / frames for name, ns in total.items()}


def dump(path: str) -> None:
    with open(path, "w") as f:
        json.dump(summary(), f, indent=2)


def reset(capacity: int | None = None) -> None:
    """Forget every recorded span; `capacity` resizes the buffer."""
    global _buffer, _recorded
    _buffer = deque(maxlen=capacity or _buffer.maxlen)
    _recorded = 0
    _totals.clear()


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


def _chrome_events(recorded: list[Span], base_ns: int = 0) -> list[dict]:
    """Spans as Chrome trace events ("X", microseconds from `base_ns`), on
    one track of their own above the profiler's."""
    return [{"ph": "X", "cat": "program_span", "name": s.name, "pid": "program spans",
             "tid": 0, "ts": (s.start_ns - base_ns) / 1e3,
             "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {k: v if isinstance(v, (int, float, str, bool)) else str(v)
                      for k, v in s.attrs.items()}}
            for s in recorded]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the block into
    ``{log_dir}/trace.json`` (Chrome trace format), with the program's
    spans of the block on the trace's time base.  Records CUDA activity
    when a card is present; the profile object is yielded, so a caller can
    also read ``key_averages()``."""
    import os

    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        lo = time.time_ns()
        yield prof
        hi = time.time_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"].extend(_chrome_events(spans(lo, hi), data.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(data, f)
