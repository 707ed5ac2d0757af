"""Debug visualization dumps (reference C16/C17/C20 equivalents).

The reference renders live with Pangolin (``src/GLrender.cpp``) and OpenCV
windows (``drawDepthCMap`` ``src/triangulation.cpp:4-71``, ``drawDeltas``
``include/monoUtils.h:160-177``, trajectory canvas PNGs
``src/VisualSLAM.cpp:197,211``).  TPU hosts are headless: the equivalents
here write PNGs / matplotlib figures offline.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def draw_depth_cmap(
    img: np.ndarray, pts: np.ndarray, depths: np.ndarray, mask: np.ndarray,
    path: str, z_range=(1.0, 30.0),
):
    """Depth-colored feature overlay (reference ``drawDepthCMap``:
    jet-colormapped boxes for features with z in (1, 30))."""
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img, cmap="gray", vmin=0, vmax=1)
    m = mask & (depths > z_range[0]) & (depths < z_range[1])
    sc = ax.scatter(
        pts[m, 0], pts[m, 1], c=depths[m], cmap="jet", s=14, marker="s",
        vmin=z_range[0], vmax=z_range[1],
    )
    fig.colorbar(sc, ax=ax, label="depth [m]")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def draw_deltas(
    img: np.ndarray, ref_pts: np.ndarray, cur_pts: np.ndarray, mask: np.ndarray,
    path: str,
):
    """LK flow arrows (reference ``drawDeltas``)."""
    fig, ax = plt.subplots(figsize=(12, 4))
    ax.imshow(img, cmap="gray", vmin=0, vmax=1)
    d = cur_pts - ref_pts
    ax.quiver(
        ref_pts[mask, 0], ref_pts[mask, 1], d[mask, 0], d[mask, 1],
        angles="xy", scale_units="xy", scale=1, color="lime", width=0.002,
    )
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)


def draw_trajectory(
    est_poses: np.ndarray, path: str,
    gt_poses: np.ndarray | None = None,
    keyframe_idx: list | None = None,
    loop_events: list | None = None,
):
    """Top-down (x-z) trajectory plot (reference trajectory canvas +
    the GT overlay of ``dump.cpp:447-454``)."""
    fig, ax = plt.subplots(figsize=(8, 8))
    ax.plot(est_poses[:, 0, 3], est_poses[:, 2, 3], "r-", lw=1.2, label="estimate")
    if gt_poses is not None:
        n = min(len(gt_poses), len(est_poses))
        ax.plot(gt_poses[:n, 0, 3], gt_poses[:n, 2, 3], "k--", lw=1.0, label="ground truth")
    if keyframe_idx:
        kf = est_poses[np.asarray(keyframe_idx)]
        ax.plot(kf[:, 0, 3], kf[:, 2, 3], "b.", ms=4, label="keyframes")
    if loop_events:
        for ev in loop_events:
            # LoopEvent objects (streaming driver) or (q, m, n_inl)
            # tuples (scan/chunked drivers)
            q, m = (ev.query, ev.match) if hasattr(ev, "query") else ev[:2]
            if q < len(est_poses) and m < len(est_poses):
                ax.plot(
                    [est_poses[q, 0, 3], est_poses[m, 0, 3]],
                    [est_poses[q, 2, 3], est_poses[m, 2, 3]],
                    "g-", lw=2.0, alpha=0.7,
                )
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_error_curve(est_poses: np.ndarray, gt_poses: np.ndarray, path: str):
    """Per-frame position error curve (the reference's plotter.py
    squared-error animation, as a static figure)."""
    n = min(len(est_poses), len(gt_poses))
    err = np.linalg.norm(est_poses[:n, :3, 3] - gt_poses[:n, :3, 3], axis=1)
    fig, ax = plt.subplots(figsize=(9, 3))
    ax.plot(err, lw=1.0)
    ax.set_xlabel("frame")
    ax.set_ylabel("position error [m]")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def draw_disparity(disp: np.ndarray, path: str, max_disp: float | None = None):
    """Jet-colormapped disparity image (reference ``imshow`` of the
    normalized SGBM output, ``src/StereoCV.cpp:256-257``)."""
    fig, ax = plt.subplots(figsize=(12, 4))
    shown = np.where(disp >= 0, disp, np.nan)
    im = ax.imshow(shown, cmap="jet", vmax=max_disp)
    fig.colorbar(im, ax=ax, label="disparity [px]")
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=100)
    plt.close(fig)
