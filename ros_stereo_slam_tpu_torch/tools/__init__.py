"""The command-line entry points, run with ``python -m``:

- ``ros_stereo_slam_tpu_torch.tools.run_kitti``     — SLAM on a KITTI sequence
- ``ros_stereo_slam_tpu_torch.tools.run_synthetic`` — SLAM on the synthetic world
- ``ros_stereo_slam_tpu_torch.tools.build_vocab``   — train an ORB vocabulary
- ``ros_stereo_slam_tpu_torch.tools.stereo_depth``  — the dense-disparity node
- ``ros_stereo_slam_tpu_torch.tools.endurance_run`` — the reference-scale
  endurance run (4,096 frames through the scan, chunked and streaming
  postures)

Each has the reference tool's flags, with ``--device`` (default ``cuda``)
in place of ``--platform``, and a ``main(argv=None)`` that returns the
exit code.  Without a card, ``--device cuda`` exits with code 2 and a
message; pass ``--device cpu`` to run on the host, e.g. the endurance run
at a tiny size (~1 min)::

    python -m ros_stereo_slam_tpu_torch.tools.endurance_run --device cpu \
        --frames 16 --lap 32 --radius 5 --scale 4 --out runs/endurance_cpu
"""

from __future__ import annotations

import sys


def device_of(name: str):
    """The torch device `name` names, or None (after a message on stderr)
    when it asks for a card this host does not have."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print(f"ERROR: --device {name}: torch.cuda.is_available() is false on this host "
              "(pass --device cpu to run on the CPU)", file=sys.stderr)
        return None
    return dev
