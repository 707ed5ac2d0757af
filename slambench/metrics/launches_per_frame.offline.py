"""Device kernels per frame of the traced session (memory copies and sets
excluded, as ``tools/torch_kernel_count.py`` counts them): the frame
step's launches (``models/step.py``), which bound a launch-bound fps."""


def read(rec):
    frames = rec["frames"]
    return len(rec["trace"]["kernels"]) / frames if frames else None
