"""Binary PLY point-cloud export.

Replaces the reference's PCL ``io::savePLYFileBinary`` map dump
(``reference/src/rosFuncs.cpp:63-67`` — ``map.ply`` on shutdown).
Host-side IO; numpy structured array -> binary_little_endian PLY.
"""

from __future__ import annotations

import numpy as np


def save_ply(path: str, points: np.ndarray, colors: np.ndarray | None = None) -> int:
    """Write (N, 3) float points (+ optional (N, 3) colors in [0,1] or
    uint8) as a binary PLY.  Returns the number of points written."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    has_color = colors is not None
    if has_color:
        colors = np.asarray(colors)
        if colors.dtype != np.uint8:
            colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    header += [f"property float {ax}" for ax in "xyz"]
    if has_color:
        header += [f"property uchar {ch}" for ch in ("red", "green", "blue")]
    header += ["end_header", ""]

    if has_color:
        dt = np.dtype(
            [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
             ("red", "u1"), ("green", "u1"), ("blue", "u1")]
        )
        rec = np.empty(n, dtype=dt)
        rec["x"], rec["y"], rec["z"] = points.T
        rec["red"], rec["green"], rec["blue"] = colors.T
    else:
        dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec = np.empty(n, dtype=dt)
        rec["x"], rec["y"], rec["z"] = points.T

    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        rec.tofile(f)
    return n


def load_ply(path: str) -> tuple[np.ndarray, np.ndarray | None]:
    """Minimal reader for files written by :func:`save_ply` (tests)."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            header += f.readline()
        lines = header.decode("ascii").splitlines()
        n = int(next(ln for ln in lines if ln.startswith("element vertex")).split()[-1])
        has_color = any("uchar red" in ln for ln in lines)
        if has_color:
            dt = np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("red", "u1"), ("green", "u1"), ("blue", "u1")]
            )
        else:
            dt = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4")])
        rec = np.fromfile(f, dtype=dt, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=1)
    if has_color:
        cols = np.stack([rec["red"], rec["green"], rec["blue"]], axis=1)
        return pts, cols
    return pts, None
