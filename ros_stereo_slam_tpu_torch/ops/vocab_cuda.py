"""The deep levels of the vocabulary descent through the hand-written CUDA kernel.

``csrc/vocab_descend.cu`` (kernel K3) replaces the TPU kernel
``ros_stereo_slam_tpu/ops/vocab_pallas.py::_deep_descend_kernel`` (entry
point ``deep_descend``).  :func:`deep_descend` has the contract of
:func:`vocab._deep_descend_plain`, the gather route of ``vocab._descend``:

- CUDA tensors launch the kernel (built at first use by
  :mod:`ros_stereo_slam_tpu_torch.kernels.build`);
- CPU tensors take the plain version;
- anything else raises.  There is no fallback from the kernel.

Both are exact (integer dots, first-max ties), so their word ids are
bit-identical.  The tables are read as they are: nothing is padded or
packed, in or out of the frame loop.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches made by deep_descend in this process (only where the
# kernel itself is launched).
LAUNCHES = 0

_MAX_LEVELS = 8


def _bind():
    from ros_stereo_slam_tpu_torch.kernels import build

    lib = build.load("vocab_descend")
    fn = lib.vocab_descend_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, ctypes.POINTER(p), ctypes.POINTER(i), i, i, p, p]
    fn.restype = ctypes.c_int
    return fn


def _check(q: torch.Tensor, node: torch.Tensor, tables, k: int) -> None:
    dev = q.device
    if q.dtype != torch.float32 or q.dim() != 2 or q.shape[1] != 256:
        raise ValueError(f"q must be (N, 256) float32, got {tuple(q.shape)} {q.dtype}")
    if node.shape != (q.shape[0],):
        raise ValueError(f"node must be (N,), got {tuple(node.shape)}")
    if not 1 <= len(tables) <= _MAX_LEVELS:
        raise ValueError(f"{len(tables)} deep levels; the kernel takes 1..{_MAX_LEVELS}")
    if k < 1:
        raise ValueError(f"branching factor k={k}")
    for t in tables:
        if t.device != dev:
            raise ValueError(f"a table is on {t.device}, q on {dev}")
        if t.dtype != torch.int8 or t.dim() != 2 or t.shape[1] != 256:
            raise ValueError(f"tables must be (G, 256) int8, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 8:
            raise ValueError("tables must be contiguous and 8-byte aligned")
        if t.shape[0] >= 2**31:
            raise ValueError(f"table of {t.shape[0]} rows exceeds int32 node ids")


def bare_launch(q: torch.Tensor, node: torch.Tensor, tables, k: int):
    """A zero-argument callable that launches the kernel once on an output
    allocated here and returns its cudaError: the kernel alone, without the
    wrapper's checks, conversions and allocations, for timing.  `q` must be
    contiguous float32 and 16-byte aligned.  It counts no launch."""
    tables = tuple(tables)
    _check(q, node, tables, k)
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("q must be contiguous and 16-byte aligned")
    node32 = node.to(torch.int32).contiguous()
    out = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    rows = (ctypes.c_int * len(tables))(*(t.shape[0] for t in tables))
    args = (q.data_ptr(), node32.data_ptr(), q.shape[0], ptrs, rows, len(tables), k,
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    fn = _bind()

    def launch() -> int:
        return fn(*args)

    launch.outputs = (out, node32, tables)  # kept alive with the callable
    return launch


def deep_descend(q: torch.Tensor, node: torch.Tensor, tables, k: int) -> torch.Tensor:
    """Descend (N,) entry `node` ids through the deep `tables`; (N,) int64 out.

    q (N, 256) float32 sign vectors (invalid rows all zero); tables[l]
    (k^(l0+l+1), 256) int8, row g = node g.
    """
    global LAUNCHES
    if q.device.type == "cpu":
        from ros_stereo_slam_tpu_torch.models import vocab

        return vocab._deep_descend_plain(q, node, tables, k)
    if q.device.type != "cuda":
        raise ValueError(f"vocab_cuda.deep_descend: unsupported device {q.device}")
    q = q.to(torch.float32).contiguous()
    if q.data_ptr() % 16:  # the kernel reads q as float4
        q = q.clone()
    tables = tuple(tables)
    _check(q, node, tables, k)
    n = q.shape[0]
    out = torch.empty((n,), dtype=torch.int32, device=q.device)
    if n == 0:
        return out.to(torch.int64)
    node32 = node.to(torch.int32).contiguous()
    ptrs = (ctypes.c_void_p * len(tables))(*(t.data_ptr() for t in tables))
    rows = (ctypes.c_int * len(tables))(*(t.shape[0] for t in tables))
    fn = _bind()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), node32.data_ptr(), n, ptrs, rows, len(tables), k,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"vocab_descend_f32 launch failed: cudaError {err}")
    LAUNCHES += 1
    return out.to(torch.int64)
