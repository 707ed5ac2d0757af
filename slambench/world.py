"""Stereo frames and ground truth for a traffic mix, made from a run's seed.

A frozen copy of the port's synthetic world (``data/synthetic.py``:
``SyntheticWorld``, ``_smooth_noise_2d``, ``jitter_poses``), of the bench
corridor (``bench.py::_render_world``: ``half_w`` 18 m) and of the
jittered two-lap revisit world (``chip_smoke.py::_revisit_plan``, i.e.
``bench.py --world revisit --jitter``).  A mix's ``world`` object names
the recipe and its sizes (frames, lap, step, jitter, brightness range,
noise level); the run's ``--seed`` draws, through :func:`draw`, the scene
(textures), the plan (lap jitter and brightness), the sensor noise, the
program's own seed and the sample of kernel calls the check compares.
Every seed gets the same sizes.  Textures, poses and brightness are
drawn on the host with numpy in the recipes' order; the ray casting and
the noise run on the device (float64 rays), a batch of views at a time,
and the frames are quantized to uint8 as KITTI's PNGs are.
"""

from __future__ import annotations

import numpy as np
import torch

# Corridor geometry of SyntheticWorld (world frame, z forward at frame 0).
FLOOR_Y, CEIL_Y = 1.6, 4.0
TEX_SIZE = 512
RENDER_BATCH = 8  # views ray-cast per device call


SEEDS = ("scene", "plan", "noise", "program", "sample")


def draw(seed: int) -> dict:
    """Independent 32-bit seeds, one per name in :data:`SEEDS`, from a
    run's `--seed` (any non-negative integer, 64 bits and more)."""
    state = np.random.SeedSequence(int(seed)).generate_state(len(SEEDS))
    return {name: int(s) for name, s in zip(SEEDS, state)}


def smooth_noise_2d(shape, rng, octaves=4, base_period=64):
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
        ty = ty * ty * (3 - 2 * ty)
        tx = tx * tx * (3 - 2 * tx)
        g00 = grid[y0][:, x0]
        g01 = grid[y0][:, x0 + 1]
        g10 = grid[y0 + 1][:, x0]
        g11 = grid[y0 + 1][:, x0 + 1]
        val = (g00 * (1 - ty) * (1 - tx) + g01 * (1 - ty) * tx
               + g10 * ty * (1 - tx) + g11 * ty * tx)
        out += amp * val
        total += amp
        amp *= 0.5
    out /= total
    out -= out.min()
    out /= max(out.max(), 1e-6)
    return out


def textures(world_seed: int) -> tuple[np.ndarray, np.ndarray]:
    """SyntheticWorld's far and near textures for `world_seed`."""
    rng = np.random.default_rng(world_seed)
    far = smooth_noise_2d((TEX_SIZE, TEX_SIZE), rng, octaves=5, base_period=96)
    near = smooth_noise_2d((TEX_SIZE, TEX_SIZE), rng, octaves=6, base_period=24)
    return far, near


def corridor_poses(n: int, speed: float = 0.8, yaw_rate: float = 0.004) -> np.ndarray:
    """SyntheticWorld's default trajectory: forward motion with a bounded
    heading weave; (n, 4, 4) world-from-camera."""
    poses = np.zeros((n, 4, 4), dtype=np.float64)
    T = np.eye(4)
    for i in range(n):
        poses[i] = T
        yaw = 1.5 * yaw_rate * np.cos(i * 0.03)
        c, s = np.cos(yaw), np.sin(yaw)
        dT = np.eye(4)
        dT[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        dT[:3, 3] = np.array([0.0, 0.0, speed])
        T = T @ dT
    return poses


def jitter_poses(poses, rng, trans_m=0.1, rot_deg=1.0, waves=3) -> np.ndarray:
    """A smooth random SE(3) offset of RMS size `trans_m` / `rot_deg` on
    each pose, right-multiplied, periodic over the lap."""
    out = np.array(poses, dtype=np.float64, copy=True)
    n = out.shape[0]
    t = np.arange(n) / max(n, 1)

    def smooth(scale):
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
        K = np.array([[0, -ax[2], ax[1]], [ax[2], 0, -ax[0]], [-ax[1], ax[0], 0]])
        dT = np.eye(4)
        dT[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)
        dT[:3, 3] = dts[i]
        out[i] = out[i] @ dT
    return out


def lap_poses(lap: int, step_m: float) -> np.ndarray:
    """One lap of a circle in the x-z plane, tangential heading, `step_m`
    a frame: (lap, 4, 4)."""
    r = lap * step_m / (2.0 * np.pi)
    out = np.zeros((lap, 4, 4))
    for i in range(lap):
        th = 2 * np.pi * i / lap
        c, sn = np.cos(th), np.sin(th)
        out[i] = np.eye(4)
        out[i, :3, :3] = np.array([[c, 0.0, sn], [0.0, 1.0, 0.0], [-sn, 0.0, c]])
        out[i, :3, 3] = np.array([r * (1 - c), 0.0, r * sn])
    return out


class Scene:
    """One static textured corridor: textures on the device and its walls."""

    def __init__(self, world_seed: int, half_w: float, end_z: float, device):
        far, near = textures(world_seed)
        self.tex_far = torch.from_numpy(far).to(device)
        self.tex_near = torch.from_numpy(near).to(device)
        self.half_w, self.end_z = float(half_w), float(end_z)
        self.device = device

    def views(self, T_wc: np.ndarray, cam: dict) -> torch.Tensor:
        """Ray-cast (B, 4, 4) world-from-camera poses: (B, H, W) float32 in
        [0, 1] on the device, as SyntheticWorld._render_view."""
        dev, f64 = self.device, torch.float64
        H, W = int(cam["height"]), int(cam["width"])
        T = torch.as_tensor(np.asarray(T_wc), dtype=f64, device=dev)
        vs, us = torch.meshgrid(torch.arange(H, dtype=f64, device=dev),
                                torch.arange(W, dtype=f64, device=dev), indexing="ij")
        dirs_cam = torch.stack([(us - cam["cx"]) / cam["fx"], (vs - cam["cy"]) / cam["fy"],
                                torch.ones_like(us)], dim=-1)
        R, t = T[:, :3, :3], T[:, :3, 3]
        dirs_w = torch.einsum("hwj,bij->bhwi", dirs_cam, R)
        big = 1e9
        lam = torch.full(dirs_w.shape[:-1], big, dtype=f64, device=dev)
        for axis, bound in ((0, self.half_w), (0, -self.half_w), (1, FLOOR_Y), (1, -CEIL_Y),
                            (2, self.end_z)):
            d = dirs_w[..., axis]
            ok = d.abs() > 1e-9
            cand = (bound - t[:, axis, None, None]) / torch.where(ok, d, 1e-9)
            lam = torch.minimum(lam, torch.where((cand > 0.1) & ok, cand, big))
        lam = torch.clamp(lam, 0.1, self.end_z * 4)
        p = t[:, None, None, :] + lam[..., None] * dirs_w
        px, py, pz = p[..., 0], p[..., 1], p[..., 2]
        u1 = px * 11.0 + pz * 17.0 + py * 3.0
        v1 = py * 13.0 + pz * 7.0 + px * 2.0
        img = _bilinear(self.tex_far, torch.remainder(v1, TEX_SIZE), torch.remainder(u1, TEX_SIZE))
        u2 = px * 41.0 + pz * 53.0
        v2 = py * 47.0 + pz * 29.0 + px * 5.0
        img = 0.65 * img + 0.35 * _bilinear(self.tex_near, torch.remainder(v2, TEX_SIZE),
                                            torch.remainder(u2, TEX_SIZE))
        return img.to(torch.float32)


def _bilinear(img: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    h, w = img.shape
    x0 = torch.clamp(torch.floor(x).long(), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).long(), 0, h - 2)
    tx = torch.clamp(x - x0, 0.0, 1.0)
    ty = torch.clamp(y - y0, 0.0, 1.0)
    flat = img.reshape(-1).to(torch.float64)
    i00 = y0 * w + x0
    return (flat[i00] * (1 - ty) * (1 - tx) + flat[i00 + 1] * (1 - ty) * tx
            + flat[i00 + w] * ty * (1 - tx) + flat[i00 + w + 1] * ty * tx)


def right_poses(T_wc: np.ndarray, baseline: float) -> np.ndarray:
    """The right camera: `baseline` along each pose's camera x axis."""
    out = np.array(T_wc, copy=True)
    out[:, :3, 3] = T_wc[:, :3, 3] + T_wc[:, :3, 0] * baseline
    return out


def quantize(img: torch.Tensor) -> torch.Tensor:
    """[0, 1] float -> uint8, rounded, as an 8-bit PNG stores it."""
    return torch.floor(torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


class Frames:
    """A session's frames: (F, H, W) uint8 left and right stacks on the
    device and (F, 4, 4) float64 ground-truth world-from-camera poses."""

    def __init__(self, left: torch.Tensor, right: torch.Tensor, gt: np.ndarray):
        self.left, self.right, self.gt = left, right, gt

    def __len__(self) -> int:
        return int(self.left.shape[0])


def _render_segments(segments, cam: dict, device, noise_seed: int) -> Frames:
    """`segments`: (Scene, (n, 4, 4) poses, per-frame (brightness, noise
    sigma) or None) in frame order -> Frames.  The sensor noise is drawn
    on the device from `noise_seed`, one field per frame, shared by the
    left and right views as the recipes share it."""
    gen = torch.Generator(device=device).manual_seed(int(noise_seed))
    H, W = int(cam["height"]), int(cam["width"])
    lefts, rights, gts = [], [], []
    for scene, poses, post in segments:
        rp = right_poses(poses, cam["baseline"])
        for s in range(0, len(poses), RENDER_BATCH):
            sl = slice(s, s + RENDER_BATCH)
            L, R = scene.views(poses[sl], cam), scene.views(rp[sl], cam)
            for j, pp in enumerate(post[sl]):
                if pp is not None:  # photometric jitter: brightness and sensor noise
                    b, sigma = pp
                    n = sigma * torch.randn((H, W), generator=gen, device=device)
                    L[j] = torch.clamp(L[j] * b + n, 0, 1)
                    R[j] = torch.clamp(R[j] * b + n, 0, 1)
            lefts.append(quantize(L))
            rights.append(quantize(R))
        gts.append(poses)
    return Frames(torch.cat(lefts), torch.cat(rights), np.concatenate(gts))


def corridor(w: dict, cam: dict, device, seeds: dict) -> Frames:
    """The bench corridor: frames 0 .. w["frames"] - 1 of SyntheticWorld's
    default trajectory through the scene of ``seeds["scene"]``, with
    sensor noise of ``w["noise_sigma"]`` drawn from ``seeds["noise"]``."""
    return corridor_frames(w, seeds["scene"], cam, device, seeds["noise"])


def corridor_frames(w: dict, world_seed: int, cam: dict, device, noise_seed: int = 0) -> Frames:
    """The corridor with textures from `world_seed`."""
    n = int(w["frames"])
    poses = corridor_poses(n, w["speed_m"], w["yaw_rate"])
    scene = Scene(world_seed, w["half_w"], w["end_z"], device)
    sigma = float(w.get("noise_sigma", 0.0))
    post = [(1.0, sigma) if sigma > 0 else None] * n
    return _render_segments([(scene, poses, post)], cam, device, noise_seed)


def revisit_plan(w: dict, plan_seed: int):
    """The jittered revisit world's laps: [(poses, [(brightness, noise
    sigma) or None per frame])]; the jitter and the per-lap brightness are
    drawn from one generator in the bench's order."""
    lap, n_total = int(w["lap"]), int(w["frames"])
    base = lap_poses(lap, w["step_m"])
    rng = np.random.default_rng(plan_seed)
    laps, done = [], 0
    for lap_i in range(-(-n_total // lap)):
        poses_l = (base if lap_i == 0 else
                   jitter_poses(base, rng, trans_m=w["jitter_trans_m"],
                                rot_deg=w["jitter_rot_deg"]))
        b = rng.uniform(*w["brightness"]) if lap_i > 0 else 1.0
        m = min(lap, n_total - done)
        laps.append((poses_l[:m], [None if lap_i == 0 else (b, w["noise_sigma"])] * m))
        done += m
    return laps


def revisit(w: dict, cam: dict, device, seeds: dict) -> Frames:
    """The jittered two-lap revisit world of ``seeds["plan"]`` (jitter,
    brightness) and ``seeds["scene"]`` (textures): lap 1 plain, later
    laps with smoothly jittered poses, a per-lap brightness and per-frame
    sensor noise drawn from ``seeds["noise"]``."""
    return revisit_frames(w, seeds["plan"], seeds["scene"], cam, device, seeds["noise"])


def revisit_frames(w: dict, plan_seed: int, world_seed: int, cam: dict, device,
                   noise_seed: int = 0) -> Frames:
    """The revisit world with the plan from `plan_seed`, textures from
    `world_seed`."""
    lap = int(w["lap"])
    r = lap * w["step_m"] / (2.0 * np.pi)
    scene = Scene(world_seed, max(3.0 * r, 18.0), max(6.0 * r, 260.0), device)
    laps = revisit_plan(w, plan_seed)
    return _render_segments([(scene, poses, post) for poses, post in laps], cam, device,
                            noise_seed)


RECIPES = {"corridor": corridor, "revisit": revisit}


def make_frames(w: dict, cam: dict, device, seeds: dict) -> Frames:
    """A mix's `world` object and a run's seeds (:func:`draw`) -> the
    session's frames."""
    if w["recipe"] not in RECIPES:
        raise ValueError(f"unknown world recipe {w['recipe']!r}; known: {sorted(RECIPES)}")
    return RECIPES[w["recipe"]](w, cam, device, seeds)
