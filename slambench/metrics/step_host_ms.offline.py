"""Host ms a frame of the traced session in the frame step: the
``step.frame`` spans directly under ``driver.session`` (frame 0's
``init_carry`` and every step of ``models/step.py``: LK and the temporal
gate, PnP-RANSAC, the rescue, keyframes, BA), summed as
``slambench/spans.py::per_frame`` sums them."""

from slambench import example, spans

EXAMPLE = example.record
EXPECTED = 24.0  # 28 + 20 ms of step.frame in the session, over 2 frames


def read(rec):
    return spans.layer_ms(rec, "step.frame")
