"""One LK pyramid level through the hand-written CUDA kernel.

``csrc/lk_level.cu`` replaces the TPU kernel
``ros_stereo_slam_tpu/ops/lk_pallas.py::_lk_level_kernel``: its one entry
point ``lk_level_f32`` takes B lanes in one launch (lanes on the grid's
second axis), and replaces both ``track_level`` (one lane) and
``track_level_batch``.  :func:`track_level` passes its (H, W) pair as one
lane and has the contract of :func:`lk._track_level`;
:func:`track_level_batch` has that of :func:`track_level_batch_plain`, a
loop of :func:`lk._track_level` over lanes:

- CUDA tensors launch the kernel (built at first use by
  :mod:`ros_stereo_slam_tpu_torch.kernels.build`), one launch per call:
  the ``min_eig`` gate and the "a point that fails it keeps its guess"
  select run inside the kernel;
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

# Kernel launches made in this process by track_level (LAUNCHES, one lane)
# and by track_level_batch (BATCH_LAUNCHES), counted only where the kernel
# itself is launched.
LAUNCHES = 0
BATCH_LAUNCHES = 0

_MAX_WINDOW = 32
_MAX_LANES = 65535  # the grid's second axis

# Entry point name -> its bound ctypes function (bound once per process).
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        from ros_stereo_slam_tpu_torch.kernels import build

        fn = getattr(build.load("lk_level"), name)
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = {
            "lk_level_f32": [p, p, i, i, i, p, p, i, i, i, i, f, f, p, p, p, p],
            "empty_launch": [p],
        }[name]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return fn


def _check(ref_img, cur_img, ref_pts, guesses, params: lk.LKParams) -> None:
    """Device, type, contiguity and shapes: (B, H, W) images and (B, N, 2)
    points."""
    dev = ref_img.device
    for name, t in (("cur_img", cur_img), ("ref_pts", ref_pts), ("guesses", guesses)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, ref_img on {dev}")
    if not (ref_img.dtype == cur_img.dtype == ref_pts.dtype == guesses.dtype == torch.float32):
        raise TypeError("images and points must be float32, got "
                        f"{[t.dtype for t in (ref_img, cur_img, ref_pts, guesses)]}")
    if not (ref_img.is_contiguous() and cur_img.is_contiguous() and ref_pts.is_contiguous()
            and guesses.is_contiguous()):
        raise ValueError("images and points must be contiguous")
    if ref_img.dim() != 3 or cur_img.shape != ref_img.shape:
        raise ValueError(
            f"images must be equal (B, H, W): {tuple(ref_img.shape)} vs {tuple(cur_img.shape)}")
    if (ref_pts.dim() != 3 or ref_pts.shape[-1] != 2 or guesses.shape != ref_pts.shape
            or ref_pts.shape[0] != ref_img.shape[0]):
        raise ValueError(
            f"ref_pts and guesses must be (B, N, 2): {tuple(ref_pts.shape)}, "
            f"{tuple(guesses.shape)}")
    S = params.window
    H, W = ref_img.shape[-2:]
    if not 1 <= S <= _MAX_WINDOW:
        raise ValueError(f"window {S} outside [1, {_MAX_WINDOW}]")
    if H < S + 3 or W < S + 3:
        raise ValueError(f"image {H}x{W} smaller than window + 3 = {S + 3}")
    if ref_img.shape[0] > _MAX_LANES:
        raise ValueError(f"{ref_img.shape[0]} lanes > {_MAX_LANES} (the grid's second axis)")
    lk.check_params(params)


def _outputs(ref_pts: torch.Tensor):
    """(points, resid, ok) for `ref_pts`' rows, views of one allocation: the
    float32 points, the float32 residuals, then the flags as bytes."""
    lead = ref_pts.shape[:-1]
    m = lead.numel()
    buf = torch.empty((13 * m,), dtype=torch.uint8, device=ref_pts.device)
    return (buf[:8 * m].view(torch.float32).view(*lead, 2),
            buf[8 * m:12 * m].view(torch.float32).view(lead),
            buf[12 * m:].view(torch.bool).view(lead))


def _launcher(ref_img, cur_img, ref_pts, guesses, params: lk.LKParams, outs):
    """A zero-argument callable that launches the kernel once into `outs` on
    the current stream and returns its cudaError."""
    fn = _fn("lk_level_f32")
    B, H, W = ref_img.shape
    args = (ref_img.data_ptr(), cur_img.data_ptr(), B, H, W,
            ref_pts.data_ptr(), guesses.data_ptr(), ref_pts.shape[-2], params.window,
            params.iters, params.walk_iters, float(params.eps), float(params.min_eig), outs[0].data_ptr(),
            outs[1].data_ptr(), outs[2].data_ptr(),
            torch.cuda.current_stream(ref_img.device).cuda_stream)

    def launch() -> int:
        return fn(*args)

    launch.outputs = outs  # kept alive with the callable
    return launch


def _run(ref_img, cur_img, ref_pts, guesses, params: lk.LKParams):
    """Check, allocate, launch once on (B, H, W) lanes: ((points, resid,
    ok), launched)."""
    _check(ref_img, cur_img, ref_pts, guesses, params)
    outs = _outputs(ref_pts)
    if ref_pts.numel() == 0:  # no points (or no lanes): nothing to launch
        return outs, False
    launch = _launcher(ref_img, cur_img, ref_pts, guesses, params, outs)
    if ref_img.device.index == torch.cuda.current_device():
        err = launch()
    else:
        with torch.cuda.device(ref_img.device):
            err = launch()
    if err != 0:
        raise RuntimeError(f"lk_level launch failed: cudaError {err}")
    return outs, True


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
    outs, launched = _run(ref_img[None], cur_img[None], ref_pts[None], guesses[None], params)
    LAUNCHES += launched
    return tuple(t[0] for t in outs)


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
    outs, launched = _run(ref_imgs, cur_imgs, ref_pts, guesses, params)
    BATCH_LAUNCHES += launched
    return outs


def bare_launch(ref_img, cur_img, ref_pts, guesses, params: lk.LKParams):
    """A zero-argument callable that launches the kernel once on outputs
    allocated here ((H, W) images as one lane, or (B, H, W) lanes) and
    returns its cudaError: the kernel alone, without the wrapper's checks
    and allocation, for timing.  It counts no launch."""
    if ref_img.dim() == 2:
        ref_img, cur_img, ref_pts, guesses = (t[None] for t in (ref_img, cur_img, ref_pts,
                                                                 guesses))
    _check(ref_img, cur_img, ref_pts, guesses, params)
    return _launcher(ref_img, cur_img, ref_pts, guesses, params, _outputs(ref_pts))


def empty_launch():
    """A zero-argument callable that launches the source's empty kernel (one
    thread, no work) on the current stream: the launch floor of this card
    and its runtime, timed the way :func:`bare_launch` callables are."""
    fn = _fn("empty_launch")
    stream = torch.cuda.current_stream().cuda_stream
    return lambda: fn(stream)
