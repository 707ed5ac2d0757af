"""Host ms a frame of the traced session in the driver itself: the
``driver.session`` span less the ``step.frame``, ``detect.frame`` and
``epilogue`` spans directly under it (staging, the stats read, Python
between frames), as ``slambench/spans.py::per_frame`` works it out."""

from slambench import example, spans

EXAMPLE = example.record
EXPECTED = 10.0  # the 98 ms session less 48 + 10 + 20 ms of layers, over 2 frames


def read(rec):
    return spans.layer_ms(rec, "driver.self")
