"""ORB orientation and rotated-BRIEF bits through the hand-written CUDA kernel.

``csrc/orb_desc.cu`` (kernel K2) replaces the TPU kernel
``ros_stereo_slam_tpu/ops/orb_pallas.py::_orb_desc_kernel`` (entry point
``orb_descriptors``).  :func:`orb_descriptors` has the contract of
:func:`orb._descriptors_plain`:

- CUDA tensors launch the kernel (built at first use by
  :mod:`ros_stereo_slam_tpu_torch.kernels.build`);
- CPU tensors take the plain version, :func:`orb._descriptors_plain`;
- anything else raises.  There is no fallback from the kernel.

The kernel samples at absolute image positions with ``bilinear_at``'s
border clamp, as the plain version does; it does not carry over the TPU
kernel's tile clamp (fault F3 of the JAX package, ROADMAP queue 3).  It
takes cos and sin from the normalized moments instead of
cos(atan2(m01, m10)), so bits whose two samples nearly tie can differ
from the plain version's (expect >= 99.5 % agreement, ROADMAP H8).
"""

from __future__ import annotations

import ctypes

import torch

from ros_stereo_slam_tpu_torch.ops import orb

# Kernel launches made by orb_descriptors in this process (only where the
# kernel itself is launched).
LAUNCHES = 0


def _bind():
    from ros_stereo_slam_tpu_torch.kernels import build

    lib = build.load("orb_desc")
    fn = lib.orb_desc_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, i, i, p, i, p, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(img: torch.Tensor, pts: torch.Tensor) -> None:
    if pts.device != img.device:
        raise ValueError(f"pts is on {pts.device}, img on {img.device}")
    for name, t in (("img", img), ("pts", pts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if img.dim() != 2 or img.shape[0] < 2 or img.shape[1] < 2:
        raise ValueError(f"img must be (H, W) with H, W >= 2: {tuple(img.shape)}")
    if pts.dim() != 2 or pts.shape[1] != 2:
        raise ValueError(f"pts must be (N, 2): {tuple(pts.shape)}")


def orb_descriptors(img: torch.Tensor, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) corners on an (H, W) image -> ((N, 256) +-1 signs, (N, 2) moments)."""
    global LAUNCHES
    if img.device.type == "cpu":
        return orb._descriptors_plain(img, pts)
    if img.device.type != "cuda":
        raise ValueError(f"orb_cuda.orb_descriptors: unsupported device {img.device}")
    _check(img, pts)
    n = pts.shape[0]
    H, W = img.shape
    sign = torch.empty((n, orb.N_BITS), dtype=torch.float32, device=img.device)
    moments = torch.empty((n, 2), dtype=torch.float32, device=img.device)
    if n == 0:  # nothing to launch
        return sign, moments
    cent, pat_p, pat_q = orb._consts(img.device)
    fn = _bind()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(img.data_ptr(), H, W, pts.data_ptr(), n, cent.data_ptr(), cent.shape[0],
                 pat_p.data_ptr(), pat_q.data_ptr(), sign.data_ptr(), moments.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"orb_desc_f32 launch failed: cudaError {err}")
    LAUNCHES += 1
    return sign, moments
