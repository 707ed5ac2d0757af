"""Stereo SLAM in PyTorch + CUDA: the port of ``ros_stereo_slam_tpu``.

The JAX package beside this one is the reference; every module here keeps
its counterpart's path and public names so the two are easy to hold side
by side.  This package imports ``torch`` and never ``jax``.

Subpackages
-----------
- ``utils``   : Lie groups (SO3/SE3), pinhole camera, trajectory metrics,
                PLY export, checkpoints.
- ``data``    : synthetic ground-truth sequence generator.
- ``ops``     : LK, ORB and the vocabulary descent (each a plain version +
                a hand-written CUDA kernel), FAST, ANMS, PnP, F-matrix
                RANSAC, triangulation, SOR, pyramids, sampling, linalg.
- ``models``  : SLAM state, the per-frame step, the odometry drivers, the
                vocabulary, loop closure, pose graph, windowed bundle
                adjustment, the full-SLAM drivers (scan, frame by frame,
                chunked online).
- ``parallel``: the multi-device paths over ``torch.distributed``: the
                mesh and its collectives, landmark-sharded BA, edge- and
                chain-sharded PGO, the sharded keyframe map, a dry run.
- ``kernels`` : builds ``csrc/*.cu`` with ``nvcc`` at first use.
"""

__version__ = "0.1.0"

import torch as _torch

# Geometry demands true f32 contractions (pixel-scale PnP normal equations,
# Sampson scoring): the JAX package forces "highest" matmul precision for
# the same reason.  cuDNN convolutions default to TF32 on Ampere and later,
# so both switches are set, not only the matmul one.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from ros_stereo_slam_tpu_torch import config as config  # noqa: F401, E402
