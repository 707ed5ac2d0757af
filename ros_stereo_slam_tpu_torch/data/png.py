"""PNG decoding with ``zlib`` and numpy (no imaging library).

The reference's frame loader decodes through PIL (``data/kitti.py`` of
the JAX package); the port reads the same files without one.  It decodes
non-interlaced PNGs of 8- or 16-bit samples in the gray, gray+alpha, RGB
and RGBA colour types, with any of the five row filters, and converts
them as PIL's ``convert("L")`` / ``convert("RGB")`` do:

- 16-bit gray saturates at 255 (PIL opens it as ``I;16`` and clips);
  16-bit gray+alpha, RGB and RGBA keep each sample's high byte;
- gray from colour is ``(19595 R + 38470 G + 7471 B + 0x8000) >> 16``
  (ITU-R 601 luma in 16-bit fixed point, rounded);
- alpha is dropped.

Palette, interlaced and sub-byte PNGs raise :class:`PngError`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class PngError(ValueError):
    """A file this decoder cannot read (or that is not a valid PNG)."""


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise PngError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(body) != n or zlib.crc32(kind + body) != crc:
            raise PngError(f"{path}: chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise PngError(f"{path}: no IEND chunk")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, ft: np.ndarray, bpp: int) -> np.ndarray:
    """(H, W * bpp) filtered bytes and (H,) filter types -> (H, W * bpp) uint8."""
    if ft.max(initial=0) > 4:
        raise PngError(f"row filter type {int(ft.max())} does not exist")
    h, rowlen = raw.shape
    w = rowlen // bpp
    out = np.zeros((h, w, bpp), np.int64)
    raw = raw.reshape(h, w, bpp).astype(np.int64)
    if not np.isin(ft, (3, 4)).any():
        # None, Sub and Up: a row at a time, each row one vector operation
        prev = np.zeros((w, bpp), np.int64)
        for r in range(h):
            if ft[r] == 0:
                out[r] = raw[r]
            elif ft[r] == 1:
                out[r] = np.cumsum(raw[r], axis=0) & 255
            else:
                out[r] = (raw[r] + prev) & 255
            prev = out[r]
        return out.reshape(h, rowlen).astype(np.uint8)
    # Average and Paeth read the decoded left neighbour: sweep the
    # anti-diagonals r + x = d, whose pixels depend only on earlier ones
    # (left and up on d - 1, up-left on d - 2), every filter at once.
    pad = np.zeros((h + 1, w + 1, bpp), np.int64)  # row 0 / column 0: the zero border
    ftc = ft.astype(np.int64)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a, b, c = pad[r + 1, x], pad[r, x + 1], pad[r, x]
        f = ftc[r][:, None]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        pad[r + 1, x + 1] = (raw[r, x] + pred) & 255
    return pad[1:, 1:].reshape(h, rowlen).astype(np.uint8)


def image_size(path: str) -> tuple[int, int] | None:
    """(width, height) from a PNG's IHDR chunk; None where the file cannot
    be read or does not start with one."""
    try:
        with open(path, "rb") as f:
            head = f.read(24)
    except OSError:
        return None
    if len(head) < 24 or head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        return None
    return struct.unpack(">II", head[16:24])


def decode(path: str) -> tuple[np.ndarray, int]:
    """Decode a PNG file to its samples: ((H, W, C) uint8 or uint16, colour type)."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PngError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise PngError(f"{path}: colour type {ctype} (palette or unknown) is not supported")
    if depth not in (8, 16):
        raise PngError(f"{path}: bit depth {depth} is not supported (8 or 16 only)")
    if interlace:
        raise PngError(f"{path}: interlaced PNGs are not supported")
    ch = _CHANNELS[ctype]
    bpp = ch * depth // 8
    try:
        flat = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as e:
        raise PngError(f"{path}: image data does not inflate ({e})") from e
    if flat.size != h * (1 + w * bpp):
        raise PngError(f"{path}: {flat.size} bytes of image data, expected {h * (1 + w * bpp)}")
    rows = flat.reshape(h, 1 + w * bpp)
    px = _unfilter(rows[:, 1:], rows[:, 0], bpp).reshape(h, w, ch * depth // 8)
    if depth == 16:
        px = (px[..., 0::2].astype(np.uint16) << 8) | px[..., 1::2]
        return px.reshape(h, w, ch), ctype
    return px.reshape(h, w, ch), ctype


def _to_uint8(px: np.ndarray, ctype: int) -> np.ndarray:
    """Samples -> 8 bits as PIL opens them: 16-bit gray saturates, the
    other 16-bit types keep the high byte."""
    if px.dtype == np.uint8:
        return px
    if ctype == 0:
        return np.minimum(px, 255).astype(np.uint8)
    return (px >> 8).astype(np.uint8)


def read_gray_u8(path: str) -> np.ndarray:
    """(H, W) uint8, as PIL's ``Image.open(path).convert("L")``."""
    px, ctype = decode(path)
    px = _to_uint8(px, ctype).astype(np.int64)
    if ctype in (0, 4):
        return px[..., 0].astype(np.uint8)
    lum = (px[..., 0] * 19595 + px[..., 1] * 38470 + px[..., 2] * 7471 + 0x8000) >> 16
    return lum.astype(np.uint8)


def read_rgb_u8(path: str) -> np.ndarray:
    """(H, W, 3) uint8, as PIL's ``Image.open(path).convert("RGB")``."""
    px, ctype = decode(path)
    px = _to_uint8(px, ctype)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])

