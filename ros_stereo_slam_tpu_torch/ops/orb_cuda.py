"""ORB orientation and rotated-BRIEF bits through the hand-written CUDA kernel.

``csrc/orb_desc.cu`` (kernel K2) replaces the TPU kernel
``ros_stereo_slam_tpu/ops/orb_pallas.py::_orb_desc_kernel`` and its lane
form ``orb_descriptors_batch``: its one entry point ``orb_desc_f32`` takes
B lanes in one launch (lanes on the grid's second axis).
:func:`level_describe` launches it on one image (one lane) or a stack,
with the epilogue of ORB's level description folded in: given each
corner's validity it also returns the packed words and writes zero signs
for invalid corners; its contract is that of
:func:`orb._level_describe_plain`.

- CUDA tensors launch the kernel (built at first use by
  :mod:`ros_stereo_slam_tpu_torch.kernels.build`);
- CPU tensors take the plain version, :func:`orb._level_describe_plain`
  over :func:`orb._descriptors_plain`;
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

# Kernel launches made in this process on one (H, W) image (LAUNCHES) and
# on a (B, H, W) stack (BATCH_LAUNCHES), counted only where the kernel
# itself is launched.
LAUNCHES = 0
BATCH_LAUNCHES = 0

_MAX_LANES = 65535  # the grid's second axis

# Entry point name -> its bound ctypes function (bound once per process).
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from ros_stereo_slam_tpu_torch.kernels import build

        fn = getattr(build.load("orb_desc"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, i, p, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(img: torch.Tensor, pts: torch.Tensor, valid) -> None:
    """Device, type, contiguity and shapes: a (B, H, W) stack, (B, N, 2)
    corners and (B, N) bool flags; `valid` may be None."""
    if pts.device != img.device:
        raise ValueError(f"pts is on {pts.device}, img on {img.device}")
    if img.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError(f"img and pts must be float32, got {img.dtype}, {pts.dtype}")
    if not (img.is_contiguous() and pts.is_contiguous()):
        raise ValueError("img and pts must be contiguous")
    if img.dim() != 3 or img.shape[-2] < 2 or img.shape[-1] < 2:
        raise ValueError(f"img must be (B, H, W) with H, W >= 2: {tuple(img.shape)}")
    if pts.dim() != 3 or pts.shape[0] != img.shape[0] or pts.shape[-1] != 2:
        raise ValueError(f"pts must be (B, N, 2): {tuple(pts.shape)}")
    if img.shape[0] > _MAX_LANES:
        raise ValueError(f"{img.shape[0]} lanes > {_MAX_LANES} (the grid's second axis)")
    if valid is not None and (valid.dtype != torch.bool or valid.shape != pts.shape[:-1]
                              or valid.device != img.device or not valid.is_contiguous()):
        raise ValueError(f"valid must be a contiguous bool {tuple(pts.shape[:-1])} on "
                         f"{img.device}: {valid.dtype} {tuple(valid.shape)} on {valid.device}")


def _outputs(pts: torch.Tensor):
    """(signs (..., 256) f32, moments (..., 2) f32, packed words (..., 8)
    int32) for `pts`' rows, views of one allocation."""
    lead = pts.shape[:-1]
    m = lead.numel()
    buf = torch.empty(((orb.N_BITS + 2 + 8) * m,), dtype=torch.float32, device=pts.device)
    return (buf[:orb.N_BITS * m].view(*lead, orb.N_BITS),
            buf[orb.N_BITS * m:(orb.N_BITS + 2) * m].view(*lead, 2),
            buf[(orb.N_BITS + 2) * m:].view(torch.int32).view(*lead, 8))


def _launcher(img: torch.Tensor, pts: torch.Tensor, valid, outs):
    """A zero-argument callable that launches the kernel once into `outs` on
    the current stream and returns its cudaError."""
    fn = _fn("orb_desc_f32")
    cent, pat_p, pat_q = orb._consts(img.device)
    B, H, W = img.shape
    args = (img.data_ptr(), B, H, W, pts.data_ptr(),
            None if valid is None else valid.data_ptr(), pts.shape[-2], cent.data_ptr(),
            cent.shape[0], pat_p.data_ptr(), pat_q.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(),
            torch.cuda.current_stream(img.device).cuda_stream)

    def launch() -> int:
        return fn(*args)

    launch.outputs = outs  # kept alive with the callable
    return launch


def _run(img: torch.Tensor, pts: torch.Tensor, valid):
    """Check, allocate, launch once on (B, H, W) lanes: ((signs, moments,
    words), launched)."""
    _check(img, pts, valid)
    outs = _outputs(pts)
    if pts.numel() == 0:  # no corners (or no lanes): nothing to launch
        return outs, False
    launch = _launcher(img, pts, valid, outs)
    if img.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(img.device):
            err = launch()
    if err != 0:
        raise RuntimeError(f"orb_desc launch failed: cudaError {err}")
    return outs, True


def level_describe(img: torch.Tensor, pts: torch.Tensor,
                   valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch for a level's descriptors and their epilogue: (N, 2) corners
    with (N,) bool `valid` on an (H, W) image, or (B, N, 2) and (B, N) on a
    (B, H, W) stack -> ((..., 256) signs, +-1 and 0 where not valid, (..., 2)
    moments, (..., 8) int32 packed bits, 0 where not valid)."""
    global LAUNCHES, BATCH_LAUNCHES
    if img.device.type == "cpu":
        return orb._level_describe_plain(img, pts, valid)
    if img.device.type != "cuda":
        raise ValueError(f"orb_cuda.level_describe: unsupported device {img.device}")
    if img.dim() == 3:
        outs, launched = _run(img, pts, valid)
        BATCH_LAUNCHES += launched
        return outs
    outs, launched = _run(img[None], pts[None], valid[None])
    LAUNCHES += launched
    return tuple(t[0] for t in outs)


def bare_launch(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor | None = None):
    """A zero-argument callable that launches the kernel once on outputs
    allocated here (an (H, W) image as one lane, or a (B, H, W) stack) and
    returns its cudaError: the kernel alone, without the wrapper's checks
    and allocation, for timing.  It counts no launch."""
    if img.dim() == 2:
        img, pts, valid = (None if t is None else t[None] for t in (img, pts, valid))
    _check(img, pts, valid)
    return _launcher(img, pts, valid, _outputs(pts))
