"""ORB orientation and rotated-BRIEF bits through the hand-written CUDA kernel.

``csrc/orb_desc.cu`` (kernel K2) replaces the TPU kernel
``ros_stereo_slam_tpu/ops/orb_pallas.py::_orb_desc_kernel``: its entry
point ``orb_desc_f32`` replaces ``orb_descriptors`` (one lane) and
``orb_desc_batch_f32`` replaces ``orb_descriptors_batch`` (B lanes in one
launch, lanes on the grid's second axis).  :func:`orb_descriptors` has the
contract of :func:`orb._descriptors_plain` and
:func:`orb_descriptors_batch` that of :func:`orb_descriptors_batch_plain`,
a loop of :func:`orb._descriptors_plain` over lanes:

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

# Kernel launches made in this process by orb_descriptors (LAUNCHES) and
# by orb_descriptors_batch (BATCH_LAUNCHES), counted only where the kernel
# itself is launched.
LAUNCHES = 0
BATCH_LAUNCHES = 0


def _bind(batch: bool = False):
    from ros_stereo_slam_tpu_torch.kernels import build

    lib = build.load("orb_desc")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.orb_desc_batch_f32 if batch else lib.orb_desc_f32
    lanes = [i] if batch else []
    fn.argtypes = [p, *lanes, i, i, p, i, p, i, p, p, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(img: torch.Tensor, pts: torch.Tensor, lanes: int = 0) -> None:
    """Device, type, contiguity and shapes; `lanes` > 0 asks for a (B, H, W)
    image stack and (B, N, 2) corners with B = lanes, else (H, W), (N, 2)."""
    if pts.device != img.device:
        raise ValueError(f"pts is on {pts.device}, img on {img.device}")
    for name, t in (("img", img), ("pts", pts)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = (lanes,) if lanes else ()
    if (img.dim() != 2 + len(lead) or img.shape[:-2] != lead
            or img.shape[-2] < 2 or img.shape[-1] < 2):
        raise ValueError(f"img must be {'(B, H, W)' if lanes else '(H, W)'} with H, W >= 2: "
                         f"{tuple(img.shape)}")
    if pts.dim() != 2 + len(lead) or pts.shape[:-2] != lead or pts.shape[-1] != 2:
        raise ValueError(f"pts must be {'(B, N, 2)' if lanes else '(N, 2)'}: "
                         f"{tuple(pts.shape)}")


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


def orb_descriptors_batch_plain(imgs: torch.Tensor,
                                pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the lane kernel: :func:`orb._descriptors_plain` on
    each lane of a (B, H, W) stack and (B, N, 2) corners, stacked."""
    outs = [orb._descriptors_plain(imgs[b], pts[b]) for b in range(imgs.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def orb_descriptors_batch(imgs: torch.Tensor,
                          pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, N, 2) corners on a (B, H, W) stack in one launch -> ((B, N, 256)
    +-1 signs, (B, N, 2) moments)."""
    global BATCH_LAUNCHES
    if imgs.device.type == "cpu":
        return orb_descriptors_batch_plain(imgs, pts)
    if imgs.device.type != "cuda":
        raise ValueError(f"orb_cuda.orb_descriptors_batch: unsupported device {imgs.device}")
    if imgs.dim() != 3:
        raise ValueError(f"imgs must be (B, H, W): {tuple(imgs.shape)}")
    B = imgs.shape[0]
    _check(imgs, pts, lanes=B)
    n = pts.shape[1]
    H, W = imgs.shape[1:]
    sign = torch.empty((B, n, orb.N_BITS), dtype=torch.float32, device=imgs.device)
    moments = torch.empty((B, n, 2), dtype=torch.float32, device=imgs.device)
    if n == 0 or B == 0:  # nothing to launch
        return sign, moments
    if B > 65535:
        raise ValueError(f"{B} lanes > 65535 (the grid's second axis)")
    cent, pat_p, pat_q = orb._consts(imgs.device)
    fn = _bind(batch=True)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(imgs.data_ptr(), B, H, W, pts.data_ptr(), n, cent.data_ptr(), cent.shape[0],
                 pat_p.data_ptr(), pat_q.data_ptr(), sign.data_ptr(), moments.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"orb_desc_batch_f32 launch failed: cudaError {err}")
    BATCH_LAUNCHES += 1
    return sign, moments
