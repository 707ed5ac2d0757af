"""KITTI odometry dataset loader.

Port of ``ros_stereo_slam_tpu/data/kitti.py``: the same layout, camera
table, probe and sequence class.  The reference decodes PNGs with PIL or
torchvision; the port decodes them with its own ``zlib`` + numpy decoder
(:mod:`.png`), whose output equals PIL's ``convert("L")`` /
``convert("RGB")`` bit for bit.  As in the reference, the left/right gray
frames come from the native prefetching loader (:mod:`.loader`) when it
builds on this host; :attr:`KittiSequence.route` says which route read
them.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ros_stereo_slam_tpu_torch.config import CameraConfig
from ros_stereo_slam_tpu_torch.data import png


def _decode_png_gray(path: str) -> np.ndarray:
    """Decode a PNG to float32 grayscale in [0, 1]."""
    return png.read_gray_u8(path).astype(np.float32) / 255.0


def _decode_png_rgb(path: str) -> np.ndarray:
    """Decode a PNG to float32 RGB (H, W, 3) in [0, 1]."""
    return png.read_rgb_u8(path).astype(np.float32) / 255.0


# KITTI odometry calibration per sequence group (P0 grayscale left cam).
_KITTI_CALIB = {
    # seqs 00-02: 1241x376
    "00": dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, w=1241, h=376, baseline=0.5371657),
    "08": dict(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104, w=1241, h=376, baseline=0.5372),
    "13": dict(fx=707.0912, fy=707.0912, cx=601.8873, cy=183.1104, w=1226, h=370, baseline=0.5372),
}


def camera_for_sequence(seq: str) -> CameraConfig:
    c = _KITTI_CALIB.get(seq, _KITTI_CALIB["00"])
    return CameraConfig(
        fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
        baseline=c["baseline"], width=c["w"], height=c["h"],
    )


@dataclass
class KittiSequence:
    """Iterates (left, right) float32 image pairs for a KITTI sequence.

    Expects the standard layout ``{root}/sequences/{seq}/image_0/%06d.png``
    (left) and ``image_1`` (right); GT poses at ``{root}/poses/{seq}.txt``.
    """

    root: str
    seq: str = "00"

    def __post_init__(self):
        self.dir_l = os.path.join(self.root, "sequences", self.seq, "image_0")
        self.dir_r = os.path.join(self.root, "sequences", self.seq, "image_1")
        # image_2 = left COLOR camera (RGB map path; the reference samples
        # per-point colors via getColors, monoUtils.h:180-193)
        self.dir_rgb = os.path.join(self.root, "sequences", self.seq, "image_2")
        self.pose_file = os.path.join(self.root, "poses", f"{self.seq}.txt")
        self.camera = camera_for_sequence(self.seq)
        self._loaders = None

    @property
    def available(self) -> bool:
        return os.path.isdir(self.dir_l) and os.path.isdir(self.dir_r)

    @property
    def rgb_available(self) -> bool:
        return os.path.isdir(self.dir_rgb)

    @property
    def route(self) -> str:
        """How :meth:`frame` reads the gray pairs: ``native`` (the libpng
        prefetching loader) or ``numpy`` (:mod:`.png`)."""
        if self._loaders is None:
            self._init_loaders()
        return "native" if self._loaders else "numpy"

    def frame_rgb(self, i: int) -> np.ndarray:
        """(H, W, 3) float32 RGB of the left color camera (image_2);
        grayscale replicated when the color folder is absent."""
        if self.rgb_available:
            return _decode_png_rgb(os.path.join(self.dir_rgb, f"{i:06d}.png"))
        g = _decode_png_gray(os.path.join(self.dir_l, f"{i:06d}.png"))
        return np.stack([g, g, g], axis=-1)

    def __len__(self) -> int:
        if not self.available:
            return 0
        return len([f for f in os.listdir(self.dir_l) if f.endswith(".png")])

    def frame(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        if self._loaders is None:
            self._init_loaders()
        if self._loaders:
            return self._loaders[0].get(i), self._loaders[1].get(i)
        left = _decode_png_gray(os.path.join(self.dir_l, f"{i:06d}.png"))
        right = _decode_png_gray(os.path.join(self.dir_r, f"{i:06d}.png"))
        return left, right

    def _init_loaders(self):
        """Use the native prefetching loader when the library builds."""
        from ros_stereo_slam_tpu_torch.data.loader import PrefetchLoader, native_available

        self._loaders = ()
        if not native_available() or not self.available:
            return
        n = len(self)
        lp = [os.path.join(self.dir_l, f"{i:06d}.png") for i in range(n)]
        rp = [os.path.join(self.dir_r, f"{i:06d}.png") for i in range(n)]
        c = self.camera
        self._loaders = (
            PrefetchLoader(lp, c.width, c.height),
            PrefetchLoader(rp, c.width, c.height),
        )

    def gt_poses(self) -> np.ndarray | None:
        """(N, 4, 4) ground-truth world-from-cam poses, or None."""
        if not os.path.isfile(self.pose_file):
            return None
        rows = np.loadtxt(self.pose_file).reshape(-1, 3, 4)
        n = rows.shape[0]
        out = np.tile(np.eye(4), (n, 1, 1))
        out[:, :3, :] = rows
        return out


def find_kitti_root() -> str | None:
    """Probe common locations for a KITTI odometry tree: ``$KITTI_ROOT``,
    ``/data/kitti``, ``~/kitti`` (the reference also probes a fixed
    ``data/kitti`` in one account's home; the port leaves it out)."""
    for cand in (
        os.environ.get("KITTI_ROOT", ""),
        "/data/kitti",
        os.path.expanduser("~/kitti"),
    ):
        if cand and os.path.isdir(os.path.join(cand, "sequences")):
            return cand
    return None
