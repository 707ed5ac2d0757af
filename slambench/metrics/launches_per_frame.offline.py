"""Device kernels per frame of the traced session (memory copies and sets
excluded, as ``tools/torch_kernel_count.py`` counts them): the frame
step's launches (``models/step.py``), which bound a launch-bound fps."""

from slambench import example

EXAMPLE = example.record
EXPECTED = 2.0  # 4 kernels over 2 frames


def read(rec):
    frames = rec["frames"]
    return len(rec["trace"]["kernels"]) / frames if frames else None
