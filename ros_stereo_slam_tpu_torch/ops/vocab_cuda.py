"""The vocabulary descent through the hand-written CUDA kernel.

``csrc/vocab_descend.cu`` (kernel K3) replaces the TPU kernel
``ros_stereo_slam_tpu/ops/vocab_pallas.py::_deep_descend_kernel`` (entry
point ``deep_descend``) and the dense levels before it: the whole descent,
from the root, in one launch, over the bit-packed tree of
:func:`.vocab.pack_centers` and ORB's packed descriptor words.
:func:`descend` has the contract of :func:`.vocab._descend_packed_plain`:

- CUDA tensors launch the kernel (built at first use by
  :mod:`ros_stereo_slam_tpu_torch.kernels.build`);
- CPU tensors take the plain version;
- anything else raises.  There is no fallback from the kernel.

Both are exact (integer Hamming distances, first-min ties), so their word
ids are bit-identical.
"""

from __future__ import annotations

import ctypes

import torch

# Kernel launches made by descend in this process (only where the kernel
# itself is launched).
LAUNCHES = 0

_MAX_LEVELS = 8
_MAX_K = (1 << 22) - 1  # the sibling index field of the kernel's min key
_FN = None


def _bind():
    global _FN
    if _FN is None:
        from ros_stereo_slam_tpu_torch.kernels import build

        fn = build.load("vocab_descend").vocab_descend_packed
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, p, ctypes.POINTER(i), i, i, p, p]
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


def _check(q_bits: torch.Tensor, valid: torch.Tensor, tree, k: int, n_levels: int) -> None:
    if q_bits.dtype != torch.int32 or q_bits.dim() != 2 or q_bits.shape[1] != 8:
        raise ValueError(f"q_bits must be (N, 8) int32, got {tuple(q_bits.shape)} {q_bits.dtype}")
    if valid.dtype != torch.bool or valid.shape != (q_bits.shape[0],):
        raise ValueError(f"valid must be (N,) bool, got {tuple(valid.shape)} {valid.dtype}")
    if not 1 <= n_levels <= min(tree.levels, _MAX_LEVELS):
        raise ValueError(f"n_levels={n_levels}: the tree has {tree.levels} levels and the "
                         f"kernel takes 1..{_MAX_LEVELS}")
    if not 1 <= k <= _MAX_K:
        raise ValueError(f"branching factor k={k}")
    for l in range(n_levels):
        rows = tree.offsets[l + 1] - tree.offsets[l]
        if rows != k ** (l + 1):
            raise ValueError(f"tree level {l} has {rows} rows, not k^{l + 1} = {k ** (l + 1)}")
    w = tree.words
    if w.dtype != torch.int32 or w.dim() != 2 or w.shape[1] != 8 or w.shape[0] < tree.offsets[-1]:
        raise ValueError(f"tree words must be (R, 8) int32 with R >= {tree.offsets[-1]}, got "
                         f"{tuple(w.shape)} {w.dtype}")
    if tree.offsets[-1] >= 2**31:
        raise ValueError(f"a tree of {tree.offsets[-1]} rows exceeds int32 row offsets")
    for name, t in (("valid", valid), ("tree", w)):
        if t.device != q_bits.device:
            raise ValueError(f"{name} is on {t.device}, q_bits on {q_bits.device}")


def _kernel_args(q_bits, valid, tree, k: int, n_levels: int, out: torch.Tensor) -> tuple:
    """The C entry point's arguments; the tensors must be contiguous and the
    words 16-byte aligned (the kernel reads rows as 16-byte vectors)."""
    for name, t in (("q_bits", q_bits), ("tree words", tree.words)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    offsets = (ctypes.c_int * (n_levels + 1))(*tree.offsets[:n_levels + 1])
    return (q_bits.data_ptr(), valid.data_ptr(), q_bits.shape[0], tree.words.data_ptr(),
            offsets, n_levels, k, out.data_ptr(), torch.cuda.current_stream().cuda_stream)


def bare_launch(q_bits: torch.Tensor, valid: torch.Tensor, tree, k: int, n_levels: int):
    """A zero-argument callable that launches the kernel once on an output
    allocated here and returns its cudaError: the kernel alone, without the
    wrapper's checks and allocation, for timing.  It counts no launch."""
    _check(q_bits, valid, tree, k, n_levels)
    out = torch.empty((q_bits.shape[0],), dtype=torch.int64, device=q_bits.device)
    args = _kernel_args(q_bits, valid, tree, k, n_levels, out)
    fn = _bind()

    def launch() -> int:
        return fn(*args)

    launch.outputs = (out, q_bits, valid, tree)  # kept alive with the callable
    return launch


def descend(q_bits: torch.Tensor, valid: torch.Tensor, tree, k: int,
            n_levels: int) -> torch.Tensor:
    """(N, 8) packed descriptor words and (N,) validity -> (N,) int64 node
    ids at level `n_levels` of `tree` (a :class:`.vocab.PackedTree`);
    invalid rows take child 0 at every level."""
    global LAUNCHES
    if q_bits.device.type == "cpu":
        from ros_stereo_slam_tpu_torch.models import vocab

        return vocab._descend_packed_plain(q_bits, valid, tree, k, n_levels)
    if q_bits.device.type != "cuda":
        raise ValueError(f"vocab_cuda.descend: unsupported device {q_bits.device}")
    _check(q_bits, valid, tree, k, n_levels)
    q_bits = q_bits.contiguous()
    if q_bits.data_ptr() % 16:
        q_bits = q_bits.clone()
    out = torch.empty((q_bits.shape[0],), dtype=torch.int64, device=q_bits.device)
    if q_bits.shape[0] == 0:
        return out
    with torch.cuda.device(q_bits.device):
        err = _bind()(*_kernel_args(q_bits, valid.contiguous(), tree, k, n_levels, out))
    if err != 0:
        raise RuntimeError(f"vocab_descend_packed launch failed: cudaError {err}")
    LAUNCHES += 1
    return out
