"""The RGB map path (config 2, ``preset_mapping()``): the port against the
JAX package and against the source frames.

World and configuration of tests/test_rgb_map.py (small_world(6, seed=4),
grid step 16, 768 slots).  Colours do not feed back into tracking, so a
run with RGB frames must give the gray run's trajectory and map points
bit for bit.  Bounds:

- ``init_carry(left_rgb=...)`` (``_bootstrap_track``'s colours) against
  the JAX package's, float32 and uint8 frames: within 1e-6 (the same
  bilinear arithmetic; uint8 is scaled per corner here and per frame in
  JAX, which is the same value);
- keyframe 0's colours against a float64 numpy bilinear sample of RGB
  frame 0 at the grid points: within 1e-5 (tests/test_rgb_map.py: 1e-4);
- uint8 against float32 RGB frames: within 3/255 (tests/test_rgb_map.py);
- the PLY's colours against the map's: within one 8-bit step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.config import FrontendConfig as JFrontend
from ros_stereo_slam_tpu.config import preset_mapping as j_preset_mapping
from ros_stereo_slam_tpu.data.synthetic import small_world
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu_torch.config import (
    FrontendConfig, LoopClosureConfig, preset_loop_closure, preset_mapping,
)
from ros_stereo_slam_tpu_torch.models import pipeline, slam, slam_chunked, step
from ros_stereo_slam_tpu_torch.models.vocab import Vocabulary
from ros_stereo_slam_tpu_torch.utils import ply

N_FRAMES = 6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rgb_runs():
    world = small_world(n_frames=N_FRAMES, seed=4)
    frames = [world.render(i) for i in range(N_FRAMES)]
    L = np.stack([f[0] for f in frames])
    R = np.stack([f[1] for f in frames])
    RGB = np.stack([world.render_rgb(i) for i in range(N_FRAMES)]).astype(np.float32)
    RGB8 = (RGB * 255.0 + 0.5).astype(np.uint8)
    cfg = preset_mapping().replace(camera=world.camera,
                                   frontend=FrontendConfig(grid_step=16, max_points=768))
    runs = {name: pipeline.run_offline(cfg, L, R, device="cpu", rgb_seq=rgb)
            for name, rgb in (("gray", None), ("f32", RGB), ("u8", RGB8))}
    return world, L, R, RGB, RGB8, cfg, runs


def _bilinear_np(img: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Float64 bilinear samples of (H, W, C) at (N, 2) (x, y) points, clamped
    as the reference clamps them."""
    h, w = img.shape[:2]
    x = np.clip(pts[:, 0].astype(np.float64), 0.0, w - 1.001)
    y = np.clip(pts[:, 1].astype(np.float64), 0.0, h - 1.001)
    x0, y0 = np.floor(x).astype(int), np.floor(y).astype(int)
    fx, fy = (x - x0)[:, None], (y - y0)[:, None]
    im = img.astype(np.float64)
    return ((1 - fy) * ((1 - fx) * im[y0, x0] + fx * im[y0, x0 + 1])
            + fy * ((1 - fx) * im[y0 + 1, x0] + fx * im[y0 + 1, x0 + 1]))


@pytest.mark.parametrize("dtype", ["f32", "u8"])
def test_bootstrap_colours_match_jax(rgb_runs, dtype):
    world, L, R, RGB, RGB8, cfg, _ = rgb_runs
    rgb = RGB[0] if dtype == "f32" else RGB8[0]
    jcfg = j_preset_mapping().replace(camera=world.camera,
                                      frontend=JFrontend(grid_step=16, max_points=768))
    gp, gm = jpipe._grid_for(jcfg)
    jc = jax.device_get(jstep.init_carry(jnp.asarray(L[0]), jnp.asarray(R[0]), gp, gm,
                                         jax.random.PRNGKey(0), jcfg,
                                         left_rgb=jnp.asarray(rgb)))
    gpt, gmt = pipeline._grid_for(cfg, "cpu")
    own = step.init_carry(torch.from_numpy(L[0]), torch.from_numpy(R[0]), gpt, gmt, 0, cfg,
                          torch.from_numpy(rgb))
    np.testing.assert_allclose(own.track.colors.numpy(), jc.track.colors, rtol=0, atol=1e-6)
    np.testing.assert_allclose(own.keyframes.colors[0].numpy(), jc.keyframes.colors[0],
                               rtol=0, atol=1e-6)
    assert np.abs(jc.track.colors[:, 0] - jc.track.colors[:, 2]).mean() > 0.02


def test_gray_fallback_stays_monochrome(rgb_runs):
    *_, runs = rgb_runs
    _, cols = pipeline.map_points_of(runs["gray"].keyframes)
    assert len(cols) > 200
    np.testing.assert_array_equal(cols[:, 0], cols[:, 1])
    np.testing.assert_array_equal(cols[:, 0], cols[:, 2])


def test_rgb_changes_only_the_colours(rgb_runs):
    *_, runs = rgb_runs
    gray = runs["gray"]
    for name in ("f32", "u8"):
        res = runs[name]
        np.testing.assert_array_equal(res.trajectory, gray.trajectory)
        np.testing.assert_array_equal(res.is_keyframe, gray.is_keyframe)
        for field in ("poses", "points", "point_mask", "valid", "frame_idx"):
            assert torch.equal(getattr(res.keyframes, field), getattr(gray.keyframes, field))
        assert not torch.equal(res.keyframes.colors, gray.keyframes.colors)


def test_keyframe_colours_match_the_source(rgb_runs):
    """Mirror of tests/test_rgb_map.py: the map is chromatic, its colours lie
    in [0, 1], keyframe 0 holds bilinear samples of RGB frame 0, and uint8
    frames give the float32 colours within quantization."""
    _, _, _, RGB, _, cfg, runs = rgb_runs
    pts, cols = pipeline.map_points_of(runs["f32"].keyframes)
    assert pts.shape[0] > 200
    assert np.abs(cols[:, 0] - cols[:, 2]).mean() > 0.02
    assert (cols >= 0).all() and (cols <= 1).all()
    kf = runs["f32"].keyframes
    m0 = kf.point_mask[0].numpy()
    want = _bilinear_np(RGB[0], pipeline._grid_for(cfg, "cpu")[0].numpy())
    np.testing.assert_allclose(kf.colors[0].numpy()[m0], want[m0], rtol=0, atol=1e-5)
    _, c8 = pipeline.map_points_of(runs["u8"].keyframes)
    assert c8.shape == cols.shape
    np.testing.assert_allclose(c8, cols, rtol=0, atol=3.0 / 255.0)


def test_map_ply_round_trip(rgb_runs, tmp_path):
    *_, runs = rgb_runs
    pts, cols = pipeline.map_points_of(runs["u8"].keyframes)
    path = str(tmp_path / "map.ply")
    assert ply.save_ply(path, pts, cols) == len(pts) > 200
    back, back_cols = ply.load_ply(path)
    np.testing.assert_array_equal(back, pts.astype(np.float32))
    np.testing.assert_allclose(back_cols / 255.0, cols, rtol=0, atol=1.0 / 255.0 + 1e-6)


def test_online_drivers_colour_their_keyframes(rgb_runs):
    """StereoSLAM(left_rgb=) and run_online_slam(rgb_seq=) colour their
    keyframes as run_offline does: the same step, so the same store, bit
    for bit (no closure in 6 frames: the detector skips frames within
    ``dislocal``)."""
    _, L, R, RGB, RGB8, cfg, runs = rgb_runs
    want = runs["u8"].keyframes
    s = slam.StereoSLAM(cfg, device="cpu")
    s.initialize(L[0], R[0], left_rgb=RGB8[0])
    for i in range(1, N_FRAMES):
        s.process_frame(L[i], R[i], left_rgb=RGB8[i])
    for x, y in zip(s.keyframes, want):
        assert torch.equal(x, y)
    lcfg = preset_loop_closure().replace(
        camera=cfg.camera, frontend=cfg.frontend,
        loop=LoopClosureConfig(orb_features=64, db_capacity=16))
    voc = Vocabulary(k=2, levels=1, centers=[torch.ones((2, 256), dtype=torch.int8)],
                     idf=torch.ones(2))
    res = slam_chunked.run_online_slam(lcfg, voc, L, R, chunk=4, device="cpu", rgb_seq=RGB8)
    assert not res.loop_events and res.n_chunks == 2
    for x, y in zip(res.keyframes, want):
        assert torch.equal(x, y)
