"""Host ms a frame of the traced session in the SLAM epilogue: the
``epilogue`` span directly under ``driver.session`` (the closures'
gates, the geometric check, the loop edges, the pose graph and the
rewrite of the poses), as ``slambench/spans.py::per_frame`` sums it."""

from slambench import example, spans

EXAMPLE = example.record
EXPECTED = 10.0  # 20 ms of epilogue, over 2 frames


def read(rec):
    return spans.layer_ms(rec, "epilogue")
