"""Prefetching frame loader over the repository's native C++ library.

Port of ``ros_stereo_slam_tpu/data/loader.py``.  ``native/dataloader.cc``
(a libpng decoder and a worker-thread pool with a bounded look-ahead
window) is compiled at first use with

    g++ -O2 -std=c++17 -fPIC -shared native/dataloader.cc \
        -o build/native/libslamloader-<hash>.so -lpng -lz -lpthread

into ``build/native/`` at the repository root (git-ignored; ``native/``
itself gets no build output), keyed by a hash of the source.  Where the
build fails (no compiler, no libpng headers) :func:`native_available` is
false, the reason is kept in :data:`UNAVAILABLE`, and
:class:`PrefetchLoader` decodes with the port's numpy decoder
(:mod:`.png`) instead.

The native decoder scales by ``v * (1.0f / 255)``, the numpy one by
``v / 255``: the two differ in the last bit for 126 of the 256 values, and
both round-trip to the same uint8 under ``clip(f * 255).astype(uint8)``.

The library copies a decoded frame into the caller's buffer before the
caller can check its size, so a frame larger than the expected geometry
would overrun the buffer (ROADMAP F4).  :meth:`PrefetchLoader.get` reads
the frame's size from its PNG header first and raises on a mismatch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from ros_stereo_slam_tpu_torch.data import png

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dataloader.cc"
BUILD_DIR = _ROOT / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")
LD_FLAGS = ("-lpng", "-lz", "-lpthread")
_lib = None
# why the native library is unavailable ("" until a build was tried)
UNAVAILABLE = ""


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS + LD_FLAGS).encode())
    return BUILD_DIR / f"libslamloader-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> str:
    """Compile the loader into `out`; returns "" or why it failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [os.environ.get("CXX", "g++"), *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        return f"{cmd[0]} did not run ({e})"
    if proc.returncode != 0:
        first = (proc.stderr.strip().splitlines() or [""])[0]
        return f"{cmd[0]} exit {proc.returncode}: {first}"
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return ""


def _ensure_lib():
    global _lib, UNAVAILABLE
    if _lib is not None or UNAVAILABLE:
        return _lib
    out = library_path()
    if not out.exists():
        UNAVAILABLE = _build(out)
        if UNAVAILABLE:
            return None
    try:
        lib = ctypes.CDLL(str(out))
    except OSError as e:  # built elsewhere: libpng missing on this host
        UNAVAILABLE = f"{out.name} does not load ({e})"
        return None
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.loader_get.restype = ctypes.c_int
    lib.loader_get.argtypes = [
        ctypes.c_void_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the native loader builds and loads on this host."""
    return _ensure_lib() is not None


@dataclass
class PrefetchLoader:
    """Ordered prefetching reader for a list of PNG paths."""

    paths: list
    width: int
    height: int
    n_threads: int = 4
    lookahead: int = 8

    def __post_init__(self):
        self._lib = _ensure_lib()
        self._handle = None
        if self._lib is not None:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths]
            )
            self._handle = self._lib.loader_create(
                arr, len(self.paths), self.n_threads, self.lookahead
            )
        self._buf = np.empty((self.height, self.width), dtype=np.float32)

    @property
    def route(self) -> str:
        """``native`` (libpng threads) or ``numpy`` (:mod:`.png`)."""
        return "native" if self._handle is not None else "numpy"

    def __len__(self) -> int:
        return len(self.paths)

    def get(self, idx: int) -> np.ndarray:
        if self._handle is not None:
            size = png.image_size(self.paths[idx])
            if size is not None and size != (self.width, self.height):
                raise ValueError(f"frame {idx} is {size[1]}x{size[0]}, "
                                 f"expected {self.height}x{self.width}")
            w = ctypes.c_int()
            h = ctypes.c_int()
            rc = self._lib.loader_get(
                self._handle, idx,
                self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                ctypes.byref(w), ctypes.byref(h),
            )
            if rc == 0:
                if (h.value, w.value) != self._buf.shape:
                    raise ValueError(
                        f"frame {idx} is {h.value}x{w.value}, "
                        f"expected {self.height}x{self.width}"
                    )
                return self._buf.copy()
            raise IOError(f"native decode failed for {self.paths[idx]} (rc={rc})")
        from ros_stereo_slam_tpu_torch.data.kitti import _decode_png_gray

        return _decode_png_gray(self.paths[idx])

    def close(self):
        if self._handle is not None and self._lib is not None:
            self._lib.loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
