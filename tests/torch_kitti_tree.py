"""Helpers for the I/O and CLI tests: a PNG encoder independent of the
decoder under test (every row filter, 8/16-bit samples, any colour type,
optional interlace flag) and a KITTI-layout tree writer.  Imports no JAX."""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _predict(f: int, left: int, up: int, ul: int) -> int:
    if f == 0:
        return 0
    if f == 1:
        return left
    if f == 2:
        return up
    if f == 3:
        return (left + up) // 2
    p = left + up - ul
    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
    return left if pa <= pb and pa <= pc else (up if pb <= pc else ul)


def png_bytes(img: np.ndarray, filters=(0,), ctype: int | None = None,
              interlace: int = 0) -> bytes:
    """(H, W) or (H, W, C) uint8/uint16 -> PNG bytes; row r uses filter
    ``filters[r % len(filters)]``, byte by byte in plain Python."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if ctype is None:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    depth = 16 if img.dtype == np.uint16 else 8
    rows = (img.astype(">u2") if depth == 16 else img.astype(np.uint8)).reshape(h, -1)
    rows = [bytearray(r.tobytes()) for r in rows]
    bpp = len(rows[0]) // w
    out = bytearray()
    prev = bytearray(len(rows[0]))
    for r, cur in enumerate(rows):
        f = filters[r % len(filters)]
        out.append(f)
        for i, x in enumerate(cur):
            left = cur[i - bpp] if i >= bpp else 0
            ul = prev[i - bpp] if i >= bpp else 0
            out.append((x - _predict(f, left, prev[i], ul)) & 255)
        prev = cur
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)
    return _SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(bytes(out))) + \
        _chunk(b"IEND", b"")


def write_png(path: str, img: np.ndarray, filters=(0,)) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img, filters))


def to_u8(frames: np.ndarray) -> np.ndarray:
    """[0, 1] float frames -> uint8, rounded."""
    return np.clip(np.asarray(frames) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def write_tree(root: str, seq: str, lefts: np.ndarray, rights: np.ndarray,
               rgbs: np.ndarray | None = None, poses: np.ndarray | None = None,
               filters=(0,)) -> None:
    """uint8 (F, H, W) gray pairs, optional (F, H, W, 3) uint8 colour frames
    and (F, 4, 4) poses -> ``{root}/sequences/{seq}/image_{0,1,2}/%06d.png``
    and ``{root}/poses/{seq}.txt``.  Rows are written with a fast vector
    encoder for None/Sub/Up filters."""
    base = os.path.join(root, "sequences", seq)
    dirs = ["image_0", "image_1"] + (["image_2"] if rgbs is not None else [])
    for d in dirs:
        os.makedirs(os.path.join(base, d), exist_ok=True)
    for i in range(len(lefts)):
        _write_fast(os.path.join(base, "image_0", f"{i:06d}.png"), lefts[i], filters)
        _write_fast(os.path.join(base, "image_1", f"{i:06d}.png"), rights[i], filters)
        if rgbs is not None:
            _write_fast(os.path.join(base, "image_2", f"{i:06d}.png"), rgbs[i], filters)
    if poses is not None:
        os.makedirs(os.path.join(root, "poses"), exist_ok=True)
        np.savetxt(os.path.join(root, "poses", f"{seq}.txt"),
                   np.asarray(poses)[:, :3, :4].reshape(len(poses), 12), fmt="%.9g")


def _write_fast(path: str, img: np.ndarray, filters) -> None:
    """uint8 image with None (0), Sub (1) or Up (2) row filters, vectorized."""
    img = np.asarray(img, np.uint8)
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    cur = img.reshape(h, w * ch).astype(np.int64)
    up = np.vstack([np.zeros((1, w * ch), np.int64), cur[:-1]])
    left = np.hstack([np.zeros((h, ch), np.int64), cur[:, :-ch]])
    ft = np.asarray([filters[r % len(filters)] for r in range(h)])
    if not set(ft.tolist()) <= {0, 1, 2}:
        raise ValueError("the fast writer takes filters 0, 1, 2")
    pred = np.where(ft[:, None] == 1, left, np.where(ft[:, None] == 2, up, 0))
    body = np.hstack([ft[:, None], (cur - pred) & 255]).astype(np.uint8).tobytes()
    ctype = {1: 0, 3: 2}[ch]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(body, 1))
                + _chunk(b"IEND", b""))
