"""One LK pyramid level through the hand-written CUDA kernel.

``csrc/lk_level.cu`` replaces the TPU kernel
``ros_stereo_slam_tpu/ops/lk_pallas.py::_lk_level_kernel``: its entry
point ``lk_level_f32`` replaces ``track_level`` (one lane) and
``lk_level_batch_f32`` replaces ``track_level_batch`` (B lanes in one
launch, lanes on the grid's second axis).  :func:`track_level` has the
contract of :func:`lk._track_level` and :func:`track_level_batch` that of
:func:`track_level_batch_plain`, a loop of :func:`lk._track_level` over
lanes:

- CUDA tensors launch the kernel (built at first use by
  :mod:`ros_stereo_slam_tpu_torch.kernels.build`);
- CPU tensors take the plain version, :func:`lk._track_level`;
- anything else raises.  There is no fallback from the kernel.

Near image borders the two routes differ by design, as the reference's two
routes do: the kernel clamps each tile start and takes the fraction
against the clamped start, and differentiates the sampled template, while
the plain version samples pre-filtered gradient images through
``dynamic_slice`` clamping.  Away from borders they agree.
"""

from __future__ import annotations

import ctypes

import torch

from ros_stereo_slam_tpu_torch.ops import lk

# Kernel launches made in this process by track_level (LAUNCHES) and by
# track_level_batch (BATCH_LAUNCHES), counted only where the kernel itself
# is launched.
LAUNCHES = 0
BATCH_LAUNCHES = 0

_MAX_WINDOW = 32


def _bind(batch: bool = False):
    from ros_stereo_slam_tpu_torch.kernels import build

    lib = build.load("lk_level")
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = lib.lk_level_batch_f32 if batch else lib.lk_level_f32
    lanes = [i] if batch else []
    fn.argtypes = [p, p, *lanes, i, i, p, p, i, i, i, ctypes.c_float, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(ref_img, cur_img, ref_pts, guesses, params: lk.LKParams, lanes: int = 0) -> None:
    """Device, type, contiguity and shapes; `lanes` > 0 asks for (B, H, W)
    images and (B, N, 2) points with B = lanes, else (H, W) and (N, 2)."""
    dev = ref_img.device
    for name, t in (("ref_img", ref_img), ("cur_img", cur_img),
                    ("ref_pts", ref_pts), ("guesses", guesses)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ref_img on {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    lead = (lanes,) if lanes else ()
    form = "(B, H, W)" if lanes else "(H, W)"
    if (ref_img.dim() != 2 + len(lead) or ref_img.shape[:-2] != lead
            or cur_img.shape != ref_img.shape):
        raise ValueError(
            f"images must be equal {form}: {tuple(ref_img.shape)} vs "
            f"{tuple(cur_img.shape)}"
        )
    n = ref_pts.shape[-2] if ref_pts.dim() >= 2 else -1
    if ref_pts.shape != (*lead, n, 2) or guesses.shape != (*lead, n, 2):
        raise ValueError(
            f"ref_pts and guesses must be {'(B, N, 2)' if lanes else '(N, 2)'}: "
            f"{tuple(ref_pts.shape)}, {tuple(guesses.shape)}"
        )
    S = params.window
    H, W = ref_img.shape[-2:]
    if not 1 <= S <= _MAX_WINDOW:
        raise ValueError(f"window {S} outside [1, {_MAX_WINDOW}]")
    if H < S + 3 or W < S + 3:
        raise ValueError(f"image {H}x{W} smaller than window + 3 = {S + 3}")
    lk.check_params(params)


def track_level(
    ref_img: torch.Tensor,
    cur_img: torch.Tensor,
    ref_pts: torch.Tensor,
    guesses: torch.Tensor,
    params: lk.LKParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine (N, 2) `guesses` on one level; returns (new_guesses, resid, ok)."""
    global LAUNCHES
    if ref_img.device.type == "cpu":
        return lk._track_level(ref_img, cur_img, ref_pts, guesses, params)
    if ref_img.device.type != "cuda":
        raise ValueError(f"lk_cuda.track_level: unsupported device {ref_img.device}")
    _check(ref_img, cur_img, ref_pts, guesses, params)
    n = ref_pts.shape[0]
    H, W = ref_img.shape
    out_pts = torch.empty((n, 2), dtype=torch.float32, device=ref_img.device)
    out_meta = torch.empty((n, 2), dtype=torch.float32, device=ref_img.device)
    if n == 0:  # nothing to launch
        return out_pts, out_meta[:, 1], out_meta[:, 0] > params.min_eig
    fn = _bind()
    with torch.cuda.device(ref_img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ref_img.data_ptr(), cur_img.data_ptr(), H, W,
                 ref_pts.data_ptr(), guesses.data_ptr(), n, params.window,
                 params.iters, float(params.eps), out_pts.data_ptr(),
                 out_meta.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lk_level_f32 launch failed: cudaError {err}")
    LAUNCHES += 1
    ok = out_meta[:, 0] > params.min_eig
    return torch.where(ok[:, None], out_pts, guesses), out_meta[:, 1], ok


def track_level_batch_plain(
    ref_imgs: torch.Tensor,
    cur_imgs: torch.Tensor,
    ref_pts: torch.Tensor,
    guesses: torch.Tensor,
    params: lk.LKParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the lane kernel: :func:`lk._track_level` on each
    lane of (B, H, W) images and (B, N, 2) points, stacked."""
    outs = [lk._track_level(ref_imgs[b], cur_imgs[b], ref_pts[b], guesses[b], params)
            for b in range(ref_imgs.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def track_level_batch(
    ref_imgs: torch.Tensor,
    cur_imgs: torch.Tensor,
    ref_pts: torch.Tensor,
    guesses: torch.Tensor,
    params: lk.LKParams,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine (B, N, 2) `guesses` on one level of B image pairs (B, H, W) in
    one launch; returns ((B, N, 2) new guesses, (B, N) resid, (B, N) ok)."""
    global BATCH_LAUNCHES
    if ref_imgs.device.type == "cpu":
        return track_level_batch_plain(ref_imgs, cur_imgs, ref_pts, guesses, params)
    if ref_imgs.device.type != "cuda":
        raise ValueError(f"lk_cuda.track_level_batch: unsupported device {ref_imgs.device}")
    if ref_imgs.dim() != 3:
        raise ValueError(f"ref_imgs must be (B, H, W): {tuple(ref_imgs.shape)}")
    B = ref_imgs.shape[0]
    _check(ref_imgs, cur_imgs, ref_pts, guesses, params, lanes=B)
    n = ref_pts.shape[1]
    H, W = ref_imgs.shape[1:]
    out_pts = torch.empty((B, n, 2), dtype=torch.float32, device=ref_imgs.device)
    out_meta = torch.empty((B, n, 2), dtype=torch.float32, device=ref_imgs.device)
    if n == 0 or B == 0:  # nothing to launch
        return out_pts, out_meta[..., 1], out_meta[..., 0] > params.min_eig
    if B > 65535:
        raise ValueError(f"{B} lanes > 65535 (the grid's second axis)")
    fn = _bind(batch=True)
    with torch.cuda.device(ref_imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(ref_imgs.data_ptr(), cur_imgs.data_ptr(), B, H, W, ref_pts.data_ptr(),
                 guesses.data_ptr(), n, params.window, params.iters, float(params.eps),
                 out_pts.data_ptr(), out_meta.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"lk_level_batch_f32 launch failed: cudaError {err}")
    BATCH_LAUNCHES += 1
    ok = out_meta[..., 0] > params.min_eig
    return torch.where(ok[..., None], out_pts, guesses), out_meta[..., 1], ok
