"""Synthetic stereo sequence generator with exact ground truth.

The reference is only ever exercised on KITTI image folders read from disk
(``reference/src/rosFuncs.cpp:48-71``).  For hermetic tests and
benchmarks (no dataset in the image), we render a procedural 3D world under
a known trajectory:

- A textured "world" of random 3D landmark boxes plus a smooth procedural
  intensity field, rendered with the same pinhole model the pipeline uses.
- Ground-truth poses, depths and point correspondences are exact, giving
  oracle values for triangulation / PnP / ATE tests (SURVEY.md §4).

Rendering is plain numpy (host-side, like dataset IO) — it stands in for
the disk loader, not for the compute path.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ros_stereo_slam_tpu_torch.config import CameraConfig


def _smooth_noise_2d(shape, rng, octaves=4, base_period=64):
    """Multi-octave value noise -> textured intensity field in [0, 1]."""
    h, w = shape
    out = np.zeros(shape, dtype=np.float32)
    amp = 1.0
    total = 0.0
    for o in range(octaves):
        period = max(base_period >> o, 4)
        gh, gw = h // period + 2, w // period + 2
        grid = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.arange(h, dtype=np.float32) / period
        xs = np.arange(w, dtype=np.float32) / period
        y0 = np.floor(ys).astype(np.int32)
        x0 = np.floor(xs).astype(np.int32)
        ty = (ys - y0)[:, None]
        tx = (xs - x0)[None, :]
        # smoothstep
        ty = ty * ty * (3 - 2 * ty)
        tx = tx * tx * (3 - 2 * tx)
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        val = (
            g00 * (1 - ty) * (1 - tx)
            + g01 * (1 - ty) * tx
            + g10 * ty * (1 - tx)
            + g11 * ty * tx
        )
        out += amp * val
        total += amp
        amp *= 0.5
    out /= total
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


@dataclass
class SyntheticWorld:
    """A STATIC textured corridor ray-cast under a known trajectory.

    Side walls, floor, ceiling and a far end wall (all world-fixed) give
    realistic depth structure (2 m .. 260 m) and LK/stereo parallax, with
    exact analytic depth at every pixel.
    """

    camera: CameraConfig
    n_frames: int = 64
    seed: int = 0
    # trajectory: forward motion with gentle yaw — KITTI-like
    speed: float = 0.8  # meters / frame
    yaw_rate: float = 0.004  # radians / frame
    tex_size: int = 512
    custom_poses: np.ndarray | None = None  # optional (N, 4, 4) override
    poses: np.ndarray = field(init=False)  # (N, 4, 4) world-from-cam

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.rng = rng
        # World textures: one big background plane far away + floor-ish noise.
        self.tex_far = _smooth_noise_2d((self.tex_size, self.tex_size), rng, octaves=5, base_period=96)
        self.tex_near = _smooth_noise_2d((self.tex_size, self.tex_size), rng, octaves=6, base_period=24)
        if self.custom_poses is not None:
            self.poses = np.asarray(self.custom_poses, dtype=np.float64)
            self.n_frames = self.poses.shape[0]
        else:
            self.poses = self._make_trajectory()

    def _make_trajectory(self) -> np.ndarray:
        # Zero-mean heading weave: yaw increment ~ cos(w i) integrates to a
        # bounded heading oscillation (±11.6 deg at the defaults), so the
        # lateral excursion stays within ~±13 m of the corridor axis for
        # ANY sequence length.  (An earlier monotonic-drift trajectory
        # walked into the x = ±half_w side wall near frame 105, collapsing
        # scene depth — every tracker, ours and the reference re-execution
        # alike, failed there and ATE measured luck, not quality.)
        poses = np.zeros((self.n_frames, 4, 4), dtype=np.float64)
        T = np.eye(4)
        for i in range(self.n_frames):
            poses[i] = T
            yaw = 1.5 * self.yaw_rate * np.cos(i * 0.03)
            c, s = np.cos(yaw), np.sin(yaw)
            dR = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
            dt = np.array([0.0, 0.0, self.speed])
            dT = np.eye(4)
            dT[:3, :3] = dR
            dT[:3, 3] = dt
            T = T @ dT
        return poses

    # -- rendering ---------------------------------------------------------

    def render(self, frame: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Render (left, right, depth_left) for a frame.

        Returns float32 images in [0, 1], shape (H, W), plus the exact
        per-pixel depth of the left image (for oracle checks).
        """
        cam = self.camera
        H, W = cam.height, cam.width
        T_wc = self.poses[frame]
        left = self._render_view(T_wc, return_depth=True)
        # Right camera: offset by +baseline along camera x axis.
        T_right = T_wc.copy()
        T_right[:3, 3] = T_wc[:3, 3] + T_wc[:3, :3] @ np.array([cam.baseline, 0, 0])
        right = self._render_view(T_right, return_depth=False)
        return left[0], right, left[1]

    # Static corridor geometry (world frame, z = forward at frame 0):
    # side walls at x = +/-half_w, floor at y = +floor_y, ceiling at
    # y = -ceil_y, end wall at z = end_z.  STATIC is essential: an earlier
    # design anchored the wall "40 m ahead of the camera", which made the
    # multi-frame geometry inconsistent (zero optical flow under forward
    # motion) — caught by end-to-end PnP verification.
    half_w: float = 7.0
    floor_y: float = 1.6
    ceil_y: float = 4.0
    end_z: float = 260.0

    def _render_view(self, T_wc: np.ndarray, return_depth: bool,
                     return_hue: bool = False):
        """Ray-cast the static textured corridor for one camera pose."""
        cam = self.camera
        H, W = cam.height, cam.width
        us, vs = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
        # Camera rays in world frame.
        dirs_cam = np.stack(
            [(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy, np.ones_like(us)], axis=-1
        )
        R = T_wc[:3, :3]
        t = T_wc[:3, 3]
        dirs_w = dirs_cam @ R.T  # (H, W, 3)

        big = 1e9
        lam = np.full((H, W), big)
        for axis, bound in (
            (0, self.half_w),
            (0, -self.half_w),
            (1, self.floor_y),
            (1, -self.ceil_y),
            (2, self.end_z),
        ):
            d = dirs_w[..., axis]
            cand = (bound - t[axis]) / np.where(np.abs(d) > 1e-9, d, 1e-9)
            cand = np.where((cand > 0.1) & (np.abs(d) > 1e-9), cand, big)
            lam = np.minimum(lam, cand)
        lam = np.clip(lam, 0.1, self.end_z * 4)
        p = t[None, None, :] + lam[..., None] * dirs_w
        depth = lam  # camera-frame z (dirs_cam z == 1)

        # Pseudo-volumetric texture: oblique projections of world position so
        # every plane orientation gets non-degenerate texture, two scales.
        u1 = p[..., 0] * 11.0 + p[..., 2] * 17.0 + p[..., 1] * 3.0
        v1 = p[..., 1] * 13.0 + p[..., 2] * 7.0 + p[..., 0] * 2.0
        img = _bilinear(self.tex_far, v1 % self.tex_size, u1 % self.tex_size)
        u2 = p[..., 0] * 41.0 + p[..., 2] * 53.0
        v2 = p[..., 1] * 47.0 + p[..., 2] * 29.0 + p[..., 0] * 5.0
        img = 0.65 * img + 0.35 * _bilinear(self.tex_near, v2 % self.tex_size, u2 % self.tex_size)
        img = img.astype(np.float32)
        if return_hue:
            # slowly-varying world-position hue (for the RGB render)
            u3 = p[..., 0] * 1.7 + p[..., 2] * 2.3
            v3 = p[..., 1] * 1.9 + p[..., 2] * 1.3
            hue = _bilinear(
                self.tex_far, v3 % self.tex_size, u3 % self.tex_size
            ).astype(np.float32)
            return img, hue
        if return_depth:
            return img, depth.astype(np.float32)
        return img

    def render_rgb(self, frame: int) -> np.ndarray:
        """Render the LEFT view in color, (H, W, 3) float32 in [0, 1].

        The world's color is a smooth hue field over world position
        modulating the same intensity texture the grayscale render uses —
        geometry-consistent color for the RGB map path (the reference
        samples per-point RGB via ``getColors``,
        ``reference/include/monoUtils.h:180-193``).
        """
        gray, hue = self._render_view(
            self.poses[frame], return_depth=False, return_hue=True
        )
        # cheap HSV-ish palette: three phase-shifted cosines of the hue
        ph = 2.0 * np.pi * hue
        r = gray * (0.65 + 0.35 * np.cos(ph))
        g = gray * (0.65 + 0.35 * np.cos(ph - 2.0943951))
        b = gray * (0.65 + 0.35 * np.cos(ph + 2.0943951))
        return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(
            np.float32
        )

    def visible_world_points(self, frame: int, n: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Sample n world surface points visible in `frame`'s left image.

        Returns (pts_world (n,3), uv_left (n,2)) exact correspondences —
        used as PnP / triangulation oracles.
        """
        cam = self.camera
        rng = np.random.default_rng(seed + 13 * frame)
        us = rng.uniform(40, cam.width - 40, n)
        vs = rng.uniform(40, cam.height - 40, n)
        _, depth = self._render_view(self.poses[frame], return_depth=True)
        d = _bilinear(depth, vs, us)
        dirs_cam = np.stack(
            [(us - cam.cx) / cam.fx, (vs - cam.cy) / cam.fy, np.ones_like(us)], axis=-1
        )
        pts_cam = dirs_cam * d[:, None]
        T = self.poses[frame]
        pts_world = pts_cam @ T[:3, :3].T + T[:3, 3]
        return pts_world.astype(np.float32), np.stack([us, vs], axis=1).astype(np.float32)


def _bilinear(img: np.ndarray, y: np.ndarray, x: np.ndarray) -> np.ndarray:
    h, w = img.shape
    x0 = np.clip(np.floor(x).astype(np.int64), 0, w - 2)
    y0 = np.clip(np.floor(y).astype(np.int64), 0, h - 2)
    tx = np.clip(x - x0, 0.0, 1.0)
    ty = np.clip(y - y0, 0.0, 1.0)
    return (
        img[y0, x0] * (1 - ty) * (1 - tx)
        + img[y0, x0 + 1] * (1 - ty) * tx
        + img[y0 + 1, x0] * ty * (1 - tx)
        + img[y0 + 1, x0 + 1] * ty * tx
    )


def small_world(
    n_frames: int = 16, seed: int = 0, scale: int = 2,
    custom_poses: np.ndarray | None = None,
) -> SyntheticWorld:
    """A reduced-resolution world for fast unit tests."""
    cam = CameraConfig(
        fx=718.856 / scale,
        fy=718.856 / scale,
        cx=607.1928 / scale,
        cy=185.2157 / scale,
        width=1241 // scale,
        height=376 // scale,
    )
    return SyntheticWorld(
        camera=cam, n_frames=n_frames, seed=seed, custom_poses=custom_poses
    )


def jitter_poses(
    poses: np.ndarray,
    rng: np.random.Generator,
    trans_m: float = 0.1,
    rot_deg: float = 1.0,
    waves: int = 3,
) -> np.ndarray:
    """Perturb each pose by a SMOOTH random SE(3) offset (right-multiplied,
    i.e. in the camera frame) of RMS magnitude ~`trans_m` / `rot_deg`.

    Revisit benchmarks/endurance runs use this so a repeated lap is NOT
    pixel-identical to the first (the appearance/viewpoint-change regime
    the reference's BoW retrieval exists to survive,
    ``reference/include/TemplatedLoopDetector.h:697-861``).

    The offset varies as a low-frequency periodic signal along the lap
    (a few random Fourier components per translation/rotation axis, so
    the perturbation is also continuous across the lap wrap): every
    revisit frame sees a ~`trans_m`/`rot_deg` viewpoint change vs the
    original lap, while CONSECUTIVE frames stay physically trackable.
    White-noise per-pose jitter (the first implementation) injects a
    ±2*`trans_m` velocity discontinuity between every pair of frames —
    a vibration regime no brightness-constancy tracker (OpenCV's LK
    included) survives, and not the viewpoint-change regime this exists
    to create.
    """
    out = np.array(poses, dtype=np.float64, copy=True)
    n = out.shape[0]
    t = np.arange(n) / max(n, 1)  # [0, 1) lap phase

    def smooth(scale: float) -> np.ndarray:
        """(n, 3) periodic smooth noise with RMS VECTOR NORM == scale
        (normalizing per-component would overshoot the promised offset
        magnitude by sqrt(3))."""
        sig = np.zeros((n, 3))
        for c in range(3):
            for k in range(1, waves + 1):
                amp = rng.normal(0.0, 1.0)
                phase = rng.uniform(0.0, 2.0 * np.pi)
                sig[:, c] += amp * np.sin(2.0 * np.pi * k * t + phase)
        rms = np.sqrt(np.mean(np.sum(sig**2, axis=1)))
        return sig / max(rms, 1e-9) * scale

    dts = smooth(trans_m)
    rvs = smooth(np.deg2rad(rot_deg))
    for i in range(n):
        rv = rvs[i]
        th = np.linalg.norm(rv)
        ax = rv / max(th, 1e-12)
        K = np.array([
            [0, -ax[2], ax[1]],
            [ax[2], 0, -ax[0]],
            [-ax[1], ax[0], 0],
        ])
        dR = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        dT = np.eye(4)
        dT[:3, :3] = dR
        dT[:3, 3] = dts[i]
        out[i] = out[i] @ dT
    return out


def loop_trajectory(
    n_frames: int,
    radius: float = 2.5,
    overlap: int = 6,
    revisit_offset: float = 0.0,
) -> np.ndarray:
    """A closed circular path inside the corridor (for loop-closure tests).

    The camera flies tangentially around a circle of `radius`, completing a
    full revolution in n_frames - overlap steps, then re-traversing the
    first `overlap` poses — exactly when ``revisit_offset`` is 0 (a true
    revisit, where the reference's identity loop closure is correct), or
    laterally displaced by that many meters (same view, different pose —
    the case a measured PnP loop edge handles and an identity edge gets
    wrong).
    """
    steps = n_frames - overlap
    poses = np.zeros((n_frames, 4, 4))
    for i in range(n_frames):
        th = 2 * np.pi * (i % steps) / steps
        c, s = np.cos(th), np.sin(th)
        # Position on the circle (in the corridor's x-z plane), heading
        # tangential (+z at th=0).
        t = np.array([radius * (1 - c), 0.0, radius * s])
        R = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
        poses[i] = np.eye(4)
        poses[i, :3, :3] = R
        poses[i, :3, 3] = t
        if i >= steps:
            poses[i, :3, 3] += R @ np.array([revisit_offset, 0.0, 0.0])
    return poses
