"""ORB orientation and rotated-BRIEF bits through the hand-written CUDA kernel.

``csrc/orb_desc.cu`` (kernel K2) replaces the TPU kernel
``ros_stereo_slam_tpu/ops/orb_pallas.py::_orb_desc_kernel``: its entry
point ``orb_desc_f32`` replaces ``orb_descriptors`` (one lane) and
``orb_desc_batch_f32`` replaces ``orb_descriptors_batch`` (B lanes in one
launch, lanes on the grid's second axis).  :func:`orb_descriptors` has the
contract of :func:`orb._descriptors_plain` and
:func:`orb_descriptors_batch` that of :func:`orb_descriptors_batch_plain`,
a loop of :func:`orb._descriptors_plain` over lanes.  :func:`level_describe`
is the same launch with the epilogue of ``orb._level_features`` folded in:
given each corner's validity it also returns the packed words and writes
zero signs for invalid corners; its contract is that of
:func:`orb._level_describe_plain`.

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

# Kernel launches made in this process on one image (LAUNCHES) and on a
# (B, H, W) stack (BATCH_LAUNCHES), counted only where the kernel itself is
# launched.
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
        lanes = [i] if name == "orb_desc_batch_f32" else []
        fn.argtypes = [p, *lanes, i, i, p, p, i, p, i, p, p, p, p, p, p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(img: torch.Tensor, pts: torch.Tensor, valid, lanes: bool) -> None:
    """Device, type, contiguity and shapes: a (B, H, W) stack, (B, N, 2)
    corners and (B, N) bool flags with `lanes`, else (H, W), (N, 2), (N,);
    `valid` may be None."""
    if pts.device != img.device:
        raise ValueError(f"pts is on {pts.device}, img on {img.device}")
    if img.dtype != torch.float32 or pts.dtype != torch.float32:
        raise TypeError(f"img and pts must be float32, got {img.dtype}, {pts.dtype}")
    if not (img.is_contiguous() and pts.is_contiguous()):
        raise ValueError("img and pts must be contiguous")
    nd = 3 if lanes else 2
    if img.dim() != nd or img.shape[-2] < 2 or img.shape[-1] < 2:
        raise ValueError(f"img must be {'(B, H, W)' if lanes else '(H, W)'} with H, W >= 2: "
                         f"{tuple(img.shape)}")
    if pts.dim() != nd or pts.shape[:-2] != img.shape[:-2] or pts.shape[-1] != 2:
        raise ValueError(f"pts must be {'(B, N, 2)' if lanes else '(N, 2)'}: "
                         f"{tuple(pts.shape)}")
    if lanes and img.shape[0] > _MAX_LANES:
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
    the current stream (the batched entry point for a (B, H, W) stack) and
    returns its cudaError."""
    fn = _fn("orb_desc_batch_f32" if img.dim() == 3 else "orb_desc_f32")
    cent, pat_p, pat_q = orb._consts(img.device)
    H, W = img.shape[-2:]
    args = (img.data_ptr(), *img.shape[:-2], H, W, pts.data_ptr(),
            None if valid is None else valid.data_ptr(), pts.shape[-2], cent.data_ptr(),
            cent.shape[0], pat_p.data_ptr(), pat_q.data_ptr(), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(),
            torch.cuda.current_stream(img.device).cuda_stream)

    def launch() -> int:
        return fn(*args)

    launch.outputs = outs  # kept alive with the callable
    return launch


def _run(img: torch.Tensor, pts: torch.Tensor, valid, lanes: bool):
    """Check, allocate, launch once and count it: (signs, moments, words)."""
    global LAUNCHES, BATCH_LAUNCHES
    _check(img, pts, valid, lanes)
    outs = _outputs(pts)
    if pts.numel() == 0:  # no corners (or no lanes): nothing to launch
        return outs
    launch = _launcher(img, pts, valid, outs)
    if img.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(img.device):
            err = launch()
    if err != 0:
        raise RuntimeError(f"orb_desc launch failed: cudaError {err}")
    if lanes:
        BATCH_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return outs


def _route(name: str, img: torch.Tensor) -> bool:
    """True for a CUDA tensor (the kernel), False for a CPU tensor (the plain
    version); anything else raises."""
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"orb_cuda.{name}: unsupported device {img.device}")
    return img.device.type == "cuda"


def orb_descriptors(img: torch.Tensor, pts: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, 2) corners on an (H, W) image -> ((N, 256) +-1 signs, (N, 2) moments)."""
    if not _route("orb_descriptors", img):
        return orb._descriptors_plain(img, pts)
    return _run(img, pts, None, lanes=False)[:2]


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
    if not _route("orb_descriptors_batch", imgs):
        return orb_descriptors_batch_plain(imgs, pts)
    return _run(imgs, pts, None, lanes=True)[:2]


def level_describe(img: torch.Tensor, pts: torch.Tensor,
                   valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch for a level's descriptors and their epilogue: (N, 2) corners
    with (N,) bool `valid` on an (H, W) image, or (B, N, 2) and (B, N) on a
    (B, H, W) stack -> ((..., 256) signs, +-1 and 0 where not valid, (..., 2)
    moments, (..., 8) int32 packed bits, 0 where not valid)."""
    if not _route("level_describe", img):
        return orb._level_describe_plain(img, pts, valid)
    return _run(img, pts, valid, lanes=img.dim() == 3)


def bare_launch(img: torch.Tensor, pts: torch.Tensor, valid: torch.Tensor | None = None):
    """A zero-argument callable that launches the kernel once on outputs
    allocated here (the batched entry point for a (B, H, W) stack, else the
    single-lane one) and returns its cudaError: the kernel alone, without
    the wrapper's checks and allocation, for timing.  It counts no launch."""
    _check(img, pts, valid, lanes=img.dim() == 3)
    return _launcher(img, pts, valid, _outputs(pts))
