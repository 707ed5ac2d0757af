"""The share of the any-lane branches' work run for lanes that did not ask:
over the traced session's ``step.rescue`` and ``step.keyframe`` spans of
more than one lane (``models/step.py``: a branch runs for every lane when
any lane asks, and carries ``lanes`` and ``asked``),
100 * sum(lanes - asked) / sum(lanes).  None where no such span was
recorded (a single-lane driver, or a program whose spans lack the counts)."""

from slambench import example

BRANCHES = ("step.rescue", "step.keyframe")


def EXAMPLE():
    """The shared record with a two-lane rescue asked by one lane, a
    two-lane keyframe branch asked by both, and a single-lane rescue (no
    lane rides along there: not counted)."""
    from ros_stereo_slam_tpu_torch.utils.profiling import Span

    ms = example.MS
    rec = example.record()
    spans = rec["spans"] + [Span(name, a * ms, b * ms, i, 1, attrs) for name, a, b, i, attrs in (
        ("step.rescue", 13, 18, 11, {"lanes": 2, "asked": 1}),
        ("step.keyframe", 20, 26, 12, {"lanes": 2, "asked": 2}),
        ("step.rescue", 26, 28, 13, {"lanes": 1, "asked": 1}))]
    rec["spans"] = rec["trace"]["spans"] = spans
    return rec


EXPECTED = 25.0  # 1 lane-slot of 4 ran for a lane that did not ask


def read(rec):
    lanes = asked = 0
    for s in rec.get("spans") or []:
        if s.name in BRANCHES and s.attrs.get("lanes", 1) > 1 and "asked" in s.attrs:
            lanes += s.attrs["lanes"]
            asked += s.attrs["asked"]
    return 100.0 * (lanes - asked) / lanes if lanes else None
