"""Host ms a frame of the traced session in bundle adjustment: every
``step.ba`` span (``models/step.py::_ba_refine``: the window's ring
update and each lane's ``ba_solve``, with its ``ba.linearize``,
``ba.reduce``, ``ba.factor`` and ``ba.accept`` spans inside), summed by
name.  ``step.ba`` lies under ``step.frame``, so it is counted wherever
it is nested, and only inside the ``driver.session`` spans."""

from slambench import example

MS = example.MS


def EXAMPLE():
    """The shared record with a ``step.ba`` of 12 ms in the first
    ``step.frame`` and one of 6 ms in the second, and one in a warm-up's
    frame outside the session."""
    from ros_stereo_slam_tpu_torch.utils.profiling import Span

    rec = example.record()
    spans = rec["spans"] + [Span(name, a * MS, b * MS, i, parent, {}) for name, a, b, i, parent in (
        ("ba.factor", 14, 20, 11, 10), ("step.ba", 13, 25, 10, 1), ("step.ba", 55, 61, 12, 4),
        ("step.ba", 210, 290, 13, 7))]
    rec["spans"] = rec["trace"]["spans"] = spans
    return rec


EXPECTED = 9.0  # 12 + 6 ms of step.ba in the session, over 2 frames


def read(rec):
    recorded, frames = rec.get("spans") or [], rec.get("frames") or 0
    sessions = [(s.start_ns, s.end_ns) for s in recorded if s.name == "driver.session"]
    ba = [s for s in recorded if s.name == "step.ba"
          and any(lo <= s.start_ns and s.end_ns <= hi for lo, hi in sessions)]
    if not ba or not frames:
        return None
    return sum(s.end_ns - s.start_ns for s in ba) * 1e-6 / frames
