"""Host time a frame by layer, from the program's spans of a traced session.

A frozen copy of ``ros_stereo_slam_tpu_torch/utils/profiling.py``'s
``per_frame`` and ``LAYERS``, so that the arithmetic of the span metrics
stays the benchmark's; the spans themselves are the program's
(``trace.Capture`` puts them in the record as ``spans``).
"""

from __future__ import annotations

LAYERS = ("step.frame", "detect.frame", "epilogue")  # directly under driver.session


def per_frame(recorded: list, frames: int) -> dict:
    """Host ms a frame of one driver session's spans: ``driver.session``,
    each of :data:`LAYERS` that was recorded, ``driver.self`` (the session
    less the layers directly under it: staging, the stats read, Python
    between frames) and ``host_read`` (blocked on the device; it overlaps
    the others).  The layers and ``driver.self`` add up to the session.
    {} where no session span was recorded."""
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


def layer_ms(rec: dict, name: str) -> float | None:
    """`name`'s host ms a frame over the record's spans (:func:`per_frame`),
    or None where the record has no such span."""
    return per_frame(rec.get("spans") or [], rec.get("frames") or 0).get(name)
