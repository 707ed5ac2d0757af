"""Host ms a frame of the traced session in loop detection: the
``detect.frame`` spans directly under ``driver.session`` (ORB + K2, K3
and the sparse BoW, the query and the insert; frame 0's included),
summed as ``slambench/spans.py::per_frame`` sums them."""

from slambench import example, spans

EXAMPLE = example.record
EXPECTED = 5.0  # 10 ms of detect.frame, over 2 frames


def read(rec):
    return spans.layer_ms(rec, "detect.frame")
