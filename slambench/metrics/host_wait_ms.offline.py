"""Host ms a frame of the traced session blocked on the device: the
program's ``host_read`` spans at any depth (the rescue and keyframe
reads, the stats reads, the epilogue's), summed as
``slambench/spans.py::per_frame`` sums them; it overlaps the layers."""

from slambench import example, spans

EXAMPLE = example.record
EXPECTED = 3.0  # 2 + 4 ms of host_read, over 2 frames


def read(rec):
    return spans.layer_ms(rec, "host_read")
