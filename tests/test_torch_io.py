"""The port's I/O layer against the JAX package's.

- The port's PNG decoder (``data/png.py``, zlib + numpy) against the JAX
  package's PIL decoders ``kitti._decode_png_gray`` / ``_decode_png_rgb``:
  bitwise, on 8- and 16-bit gray, gray+alpha, RGB and RGBA, on every row
  filter, and on files PIL writes itself.  Palette, interlaced, sub-byte
  and corrupt files raise ``PngError``.
- ``KittiSequence`` over a KITTI-layout tree against the JAX package's:
  frames (both route choices: the native loader where it builds, the
  decoder otherwise), ``frame_rgb`` with and without ``image_2``, ``len``,
  ``gt_poses``, ``camera_for_sequence`` and ``find_kitti_root``: exact.
- ``PrefetchLoader`` against the JAX package's (the same native source):
  exact; skipped only where g++ or libpng is missing.
- ``RunOutputs`` fed the same ``FrameInfo`` rows and run: ``metrics.jsonl``,
  ``trajectory.txt``, ``trajectory.csv``, ``summary.json``, ``map.ply`` and
  ``map.html`` byte-equal to the JAX package's.
- ``ScanRun`` on a scan result converted from a JAX ``ScanSlamResult``:
  ``frame_infos`` and ``keyframe_frames`` equal; ``save_graph``'s g2o has the
  same vertices and edges, numbers within 1e-6 (float32 chain products).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import torch_kitti_tree as tree_mod
from ros_stereo_slam_tpu.config import PipelineConfig as JPipelineConfig
from ros_stereo_slam_tpu.data import kitti as jkitti
from ros_stereo_slam_tpu.data import loader as jloader
from ros_stereo_slam_tpu.models import pipeline as jpipe
from ros_stereo_slam_tpu.models import slam_scan as jscan
from ros_stereo_slam_tpu.models import state as jstate
from ros_stereo_slam_tpu.utils import outputs as jout
from ros_stereo_slam_tpu_torch.config import PipelineConfig
from ros_stereo_slam_tpu_torch.data import kitti, loader, png
from ros_stereo_slam_tpu_torch.models import convert, pipeline, slam_scan, state
from ros_stereo_slam_tpu_torch.utils import outputs, profiling

FILTER_SETS = [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(rng, depth: int, ch: int, shape=(9, 11)) -> np.ndarray:
    hi = 256 if depth == 8 else 65536
    img = rng.integers(0, hi, shape + (ch,)).astype(np.uint8 if depth == 8 else np.uint16)
    if depth == 16:  # 16-bit gray saturates at 255: put values on both sides of it
        img[0, :4, 0] = [0, 254, 255, 256]
    return img


@pytest.mark.parametrize("depth", [8, 16])
@pytest.mark.parametrize("ch", [1, 2, 3, 4], ids=["gray", "gray_alpha", "rgb", "rgba"])
def test_png_decoder_matches_pil_bitwise(tmp_path, depth, ch):
    rng = np.random.default_rng(10 * depth + ch)
    for filters in FILTER_SETS:
        img = _samples(rng, depth, ch)
        p = str(tmp_path / f"f{''.join(map(str, filters))}.png")
        tree_mod.write_png(p, img, filters)
        g, rgb = kitti._decode_png_gray(p), kitti._decode_png_rgb(p)
        jg, jrgb = jkitti._decode_png_gray(p), jkitti._decode_png_rgb(p)
        assert g.dtype == jg.dtype == np.float32 and rgb.dtype == jrgb.dtype
        np.testing.assert_array_equal(g, jg, err_msg=f"filters {filters}")
        np.testing.assert_array_equal(rgb, jrgb, err_msg=f"filters {filters}")


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA", "LA"])
def test_png_decoder_reads_pil_written_files(tmp_path, mode):
    """PIL chooses its own row filters and compression."""
    rng = np.random.default_rng(3)
    shape = (37, 53) if mode == "L" else (37, 53, len(mode))
    img = Image.fromarray(rng.integers(0, 256, shape).astype(np.uint8), mode=mode)
    p = str(tmp_path / "pil.png")
    img.save(p)
    np.testing.assert_array_equal(kitti._decode_png_gray(p), jkitti._decode_png_gray(p))
    np.testing.assert_array_equal(kitti._decode_png_rgb(p), jkitti._decode_png_rgb(p))


def test_png_decoder_full_size_paeth_frame(tmp_path):
    """A 1241x376 frame with every row Paeth: the anti-diagonal sweep."""
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (376, 1241)).astype(np.uint8)
    p = str(tmp_path / "paeth.png")
    Image.fromarray(img).save(p)  # PIL's filters for the layout check below
    np.testing.assert_array_equal(png.read_gray_u8(p), img)
    with open(p, "wb") as f:  # then every row Paeth, through the sweep
        f.write(tree_mod.png_bytes(img[:40, :300], (4,)))
    np.testing.assert_array_equal(png.read_gray_u8(p), img[:40, :300])


def _unsupported(tmp_path, kind: str) -> str:
    p = str(tmp_path / f"{kind}.png")
    rng = np.random.default_rng(5)
    if kind == "palette":
        Image.fromarray(rng.integers(0, 256, (8, 8)).astype(np.uint8)).convert("P").save(p)
    elif kind == "one_bit":
        Image.fromarray(rng.integers(0, 2, (8, 8)).astype(bool)).save(p)
    elif kind == "interlaced":
        with open(p, "wb") as f:
            f.write(tree_mod.png_bytes(rng.integers(0, 256, (8, 8)).astype(np.uint8),
                                       interlace=1))
    elif kind == "not_png":
        with open(p, "wb") as f:
            f.write(b"GIF89a" + bytes(40))
    else:  # a flipped byte in the image data fails the chunk's CRC
        data = bytearray(tree_mod.png_bytes(rng.integers(0, 256, (8, 8)).astype(np.uint8)))
        data[45] ^= 0xFF
        with open(p, "wb") as f:
            f.write(bytes(data))
    return p


@pytest.mark.parametrize("kind", ["palette", "one_bit", "interlaced", "not_png", "bad_crc"])
def test_png_decoder_refuses_unsupported_files(tmp_path, kind):
    p = _unsupported(tmp_path, kind)
    with pytest.raises(png.PngError):
        kitti._decode_png_gray(p)
    with pytest.raises(png.PngError):
        kitti._decode_png_rgb(p)


# -- KittiSequence ---------------------------------------------------------


@pytest.fixture(scope="module")
def kitti_root(tmp_path_factory):
    """Sequence 00: 4 frames of 48x64 gray pairs, colour frames and poses;
    sequence 05: 3 gray-only frames and no poses file."""
    root = str(tmp_path_factory.mktemp("kitti"))
    rng = np.random.default_rng(7)
    lefts = rng.integers(0, 256, (4, 48, 64)).astype(np.uint8)
    rights = rng.integers(0, 256, (4, 48, 64)).astype(np.uint8)
    rgbs = rng.integers(0, 256, (4, 48, 64, 3)).astype(np.uint8)
    poses = np.tile(np.eye(4), (4, 1, 1))
    poses[:, 2, 3] = np.arange(4) * 0.8
    poses[:, 0, 3] = rng.normal(size=4)
    tree_mod.write_tree(root, "00", lefts, rights, rgbs, poses, filters=(0, 1, 2))
    tree_mod.write_tree(root, "05", lefts[:3], rights[:3])
    return root, lefts, rights, rgbs, poses


def _pair(root: str, seq: str):
    t, j = kitti.KittiSequence(root, seq), jkitti.KittiSequence(root, seq)
    # the tree's frames are 48x64: the native loader checks them against
    # the camera's geometry, so give both sequences that geometry
    t.camera = dataclasses.replace(t.camera, width=64, height=48)
    j.camera = dataclasses.replace(j.camera, width=64, height=48)
    return t, j


def test_kitti_sequence_matches_jax(kitti_root):
    root, lefts, rights, rgbs, poses = kitti_root
    t, j = _pair(root, "00")
    assert len(t) == len(j) == 4 and t.available and t.rgb_available
    print(f"route: {t.route}")
    for i in range(4):
        (tl, tr), (jl, jr) = t.frame(i), j.frame(i)
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(t.frame_rgb(i), j.frame_rgb(i))
        np.testing.assert_array_equal(t.frame_rgb(i), rgbs[i].astype(np.float32) / 255.0)
    np.testing.assert_array_equal(t.gt_poses(), j.gt_poses())
    np.testing.assert_allclose(t.gt_poses(), poses, atol=1e-8)


def test_kitti_sequence_decoder_route_is_uint8_over_255(kitti_root):
    """With the native loader out of the way the frames are uint8 / 255
    bitwise, as the JAX package's PIL decoder gives them."""
    root, lefts, rights, _, _ = kitti_root
    t, _ = _pair(root, "00")
    t._loaders = ()
    assert t.route == "numpy"
    for i in range(4):
        tl, tr = t.frame(i)
        np.testing.assert_array_equal(tl, lefts[i].astype(np.float32) / 255.0)
        np.testing.assert_array_equal(tr, jkitti._decode_png_gray(
            os.path.join(root, "sequences", "00", "image_1", f"{i:06d}.png")))


def test_kitti_sequence_without_colour_or_poses(kitti_root, tmp_path):
    root = kitti_root[0]
    t, j = _pair(root, "05")
    assert len(t) == len(j) == 3 and not t.rgb_available and not j.rgb_available
    for i in range(3):
        np.testing.assert_array_equal(t.frame_rgb(i), j.frame_rgb(i))
    assert t.gt_poses() is None and j.gt_poses() is None
    missing = kitti.KittiSequence(str(tmp_path), "00")
    assert not missing.available and len(missing) == 0 == len(jkitti.KittiSequence(
        str(tmp_path), "00"))


@pytest.mark.parametrize("seq", ["00", "08", "13", "42"])
def test_camera_for_sequence_matches_jax(seq):
    assert (dataclasses.asdict(kitti.camera_for_sequence(seq))
            == dataclasses.asdict(jkitti.camera_for_sequence(seq)))


def test_find_kitti_root_reads_env(kitti_root, monkeypatch, tmp_path):
    monkeypatch.setenv("KITTI_ROOT", kitti_root[0])
    assert kitti.find_kitti_root() == jkitti.find_kitti_root() == kitti_root[0]
    monkeypatch.setenv("KITTI_ROOT", str(tmp_path))  # no sequences/ under it
    monkeypatch.setenv("HOME", str(tmp_path))
    assert kitti.find_kitti_root() in (None, "/data/kitti")


# -- PrefetchLoader ------------------------------------------------------------


def _need_native():
    if not loader.native_available():
        pytest.skip(f"native loader does not build here: {loader.UNAVAILABLE}")
    if not jloader.native_available():
        pytest.skip("the JAX package's native loader is unavailable")


def test_prefetch_loader_matches_jax(kitti_root):
    _need_native()
    root = kitti_root[0]
    paths = [os.path.join(root, "sequences", "00", "image_0", f"{i:06d}.png") for i in range(4)]
    t = loader.PrefetchLoader(paths, 64, 48, n_threads=2, lookahead=2)
    j = jloader.PrefetchLoader(paths, 64, 48, n_threads=2, lookahead=2)
    assert t.route == "native"
    for i in (2, 0, 3, 1):
        np.testing.assert_array_equal(t.get(i), j.get(i))
    t.close()
    j.close()


def test_prefetch_loader_errors(kitti_root):
    """A missing file raises IOError, as in the JAX package.  A frame of
    another geometry raises ValueError BEFORE the library copies it: the
    library would write the whole 64x48 frame into a 32x48 buffer first
    (ROADMAP F4: the JAX package's loader does, and crashes)."""
    _need_native()
    t = loader.PrefetchLoader(["/nonexistent/x.png"], 64, 48)
    with pytest.raises(IOError):
        t.get(0)
    t.close()
    paths = [os.path.join(kitti_root[0], "sequences", "00", "image_0", "000000.png")]
    t = loader.PrefetchLoader(paths, 32, 48)  # narrower than the frame
    with pytest.raises(ValueError, match="is 48x64, expected 48x32"):
        t.get(0)
    t.close()


def test_prefetch_loader_numpy_route(kitti_root, monkeypatch):
    """Where the library does not build, the loader decodes with the
    numpy decoder and says so."""
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "UNAVAILABLE", "no libpng (test)")
    root = kitti_root[0]
    paths = [os.path.join(root, "sequences", "00", "image_1", f"{i:06d}.png") for i in range(4)]
    t = loader.PrefetchLoader(paths, 64, 48)
    assert t.route == "numpy" and not loader.native_available()
    for i in range(4):
        np.testing.assert_array_equal(t.get(i), jkitti._decode_png_gray(paths[i]))


# -- RunOutputs and ScanRun --------------------------------------------------


class _Run:
    """A finished run as RunOutputs.finalize reads it (numpy only)."""

    def __init__(self, traj, pts, cols, kf, events):
        self.traj, self.pts, self.cols = traj, pts, cols
        self.keyframe_frames, self.loop_events = kf, events

    def trajectory_array(self):
        return self.traj

    def map_points(self):
        return self.pts, self.cols


def _trajectory(rng, F: int) -> np.ndarray:
    T = np.tile(np.eye(4, dtype=np.float32), (F, 1, 1))
    T[:, 2, 3] = np.cumsum(rng.uniform(0.7, 0.9, F)) - 0.8
    T[:, 0, 3] = np.cumsum(rng.normal(0, 0.05, F))
    th = np.cumsum(rng.normal(0, 0.01, F))
    T[:, 0, 0] = T[:, 2, 2] = np.cos(th)
    T[:, 0, 2], T[:, 2, 0] = np.sin(th), -np.sin(th)
    return T.astype(np.float32)


def test_run_outputs_match_jax_bytewise(tmp_path):
    rng = np.random.default_rng(11)
    F = 9
    traj = _trajectory(rng, F)
    gt = traj.astype(np.float64) + rng.normal(0, 0.02, traj.shape) * (np.arange(4) == 3)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    cols = rng.random((50, 3)).astype(np.float32)
    run = _Run(traj, pts, cols, [0, 3, 6], [(8, 1, 120)])
    dirs = {}
    for name, mod, info_cls in (("port", outputs, pipeline.FrameInfo),
                                ("jax", jout, jpipe.FrameInfo)):
        out = mod.RunOutputs(str(tmp_path / name))
        for f in range(F):
            out.log_frame(info_cls(frame=f, T_wc=traj[f], n_tracked=int(100 + f),
                                   n_inliers=int(90 + f), is_keyframe=f % 3 == 0,
                                   tracking_ok=True, used_retry=f == 4),
                          {"fps": 12.5} if f else None)
        summary = out.finalize(run, gt_poses=gt)
        dirs[name] = (out.out_dir, summary)
    assert dirs["port"][1] == dirs["jax"][1]
    for fname in ("metrics.jsonl", "trajectory.txt", "trajectory.csv", "summary.json",
                  "map.ply", "map.html"):
        with open(os.path.join(dirs["port"][0], fname), "rb") as a, \
                open(os.path.join(dirs["jax"][0], fname), "rb") as b:
            assert a.read() == b.read(), fname
    for fname in ("trajectory.png", "error_curve.png"):
        assert os.path.getsize(os.path.join(dirs["port"][0], fname)) > 0


def test_run_outputs_without_plots(tmp_path):
    rng = np.random.default_rng(12)
    traj = _trajectory(rng, 5)
    out = outputs.RunOutputs(str(tmp_path / "np"))
    summary = out.finalize(_Run(traj, np.zeros((0, 3), np.float32), None, [0], []),
                           gt_poses=traj.astype(np.float64), plots=False)
    assert summary["frames"] == 5 and summary["ate_rmse"] < 1e-6
    assert not any(f.endswith(".png") for f in os.listdir(out.out_dir))
    assert pose_rows_equal(out.out_dir, traj)


def pose_rows_equal(d: str, traj: np.ndarray) -> bool:
    with open(os.path.join(d, "trajectory.txt")) as f:
        rows = np.array([[float(v) for v in line.split()] for line in f], np.float32)
    return bool(np.array_equal(rows.reshape(-1, 3, 4), traj[:, :3, :4]))


def _jax_scan_result(rng, F: int = 12):
    """A JAX ScanSlamResult (numpy fields, no JAX run) with a loop edge."""
    import jax.numpy as jnp

    traj_odo = _trajectory(rng, F)
    traj = traj_odo.copy()
    traj[:, :3, 3] += rng.normal(0, 0.01, (F, 3)).astype(np.float32)
    kf = jstate.KeyframeStore.empty(6, 8)
    kf = kf._replace(frame_idx=jnp.asarray([0, 3, 7, 9, 0, 0], jnp.int32),
                     valid=jnp.asarray([True, True, True, True, False, False]),
                     points=jnp.asarray(rng.normal(size=(6, 8, 3)), jnp.float32),
                     point_mask=jnp.asarray(rng.random((6, 8)) < 0.7),
                     count=jnp.asarray(4, jnp.int32))
    Z = np.linalg.inv(traj_odo[10]) @ traj_odo[2]
    return jscan.ScanSlamResult(
        trajectory=traj, trajectory_odo=traj_odo, loop_events=[(10, 2, 140)],
        n_inliers=rng.integers(50, 300, F - 1), is_keyframe=rng.random(F - 1) < 0.3,
        tracking_ok=np.ones(F - 1, bool), keyframes=kf,
        loop_edges=[(10, 2, Z.astype(np.float32)), (11, 4, np.eye(4))])


def _port_scan_result(res):
    kf = state.KeyframeStore(*(convert._t(np.asarray(getattr(res.keyframes, f)), "cpu")
                               for f in state.KeyframeStore._fields))
    return slam_scan.ScanSlamResult(
        trajectory=res.trajectory, trajectory_odo=res.trajectory_odo,
        loop_events=res.loop_events, n_inliers=res.n_inliers, is_keyframe=res.is_keyframe,
        tracking_ok=res.tracking_ok, keyframes=kf, loop_edges=res.loop_edges)


def _g2o(path: str):
    with open(path) as f:
        lines = [line.split() for line in f]
    return [(x[0], [int(v) for v in x[1:3 if x[0].startswith("EDGE") else 2]]) for x in lines], \
        [np.array(x[3 if x[0].startswith("EDGE") else 2:], np.float64) for x in lines]


def test_scan_run_matches_jax(tmp_path):
    rng = np.random.default_rng(13)
    jres = _jax_scan_result(rng)
    jrun = jout.ScanRun(jres, JPipelineConfig())
    trun = outputs.ScanRun(_port_scan_result(jres), PipelineConfig())
    assert trun.keyframe_frames == jrun.keyframe_frames == [0, 3, 7, 9]
    assert trun.loop_events == jrun.loop_events
    for a, b in zip(trun.frame_infos(), jrun.frame_infos(), strict=True):
        assert a.__dict__.keys() == b.__dict__.keys()
        for k in a.__dict__:
            np.testing.assert_array_equal(a.__dict__[k], b.__dict__[k])
    tp, jp = trun.map_points(), jrun.map_points()
    np.testing.assert_array_equal(tp[0], jp[0])
    np.testing.assert_array_equal(tp[1], jp[1])
    trun.save_graph(str(tmp_path / "t.g2o"))
    jrun.save_graph(str(tmp_path / "j.g2o"))
    (tk, tv), (jk, jv) = _g2o(str(tmp_path / "t.g2o")), _g2o(str(tmp_path / "j.g2o"))
    assert tk == jk and len(tk) == 12 + 11 + 2
    for a, b in zip(tv, jv):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_scan_run_of_offline_result(tmp_path):
    """An odometry OfflineResult (no loop fields): metrics rows carry
    n_tracked and used_retry; the graph is the odometry chain alone."""
    rng = np.random.default_rng(14)
    jres = _jax_scan_result(rng)
    kf = _port_scan_result(jres).keyframes
    res = pipeline.OfflineResult(
        trajectory=jres.trajectory[:6], n_tracked=np.arange(5) + 200, n_inliers=np.arange(5) + 150,
        is_keyframe=np.array([1, 0, 0, 1, 0], bool), tracking_ok=np.ones(5, bool),
        used_retry=np.array([0, 0, 1, 0, 0], bool), keyframes=kf)
    run = outputs.ScanRun(res, PipelineConfig())
    infos = run.frame_infos()
    assert [i.n_tracked for i in infos] == [0, 200, 201, 202, 203, 204]
    assert [i.used_retry for i in infos] == [False, False, False, True, False, False]
    assert run.loop_events == []
    run.save_graph(str(tmp_path / "o.g2o"))
    keys, _ = _g2o(str(tmp_path / "o.g2o"))
    assert len(keys) == 6 + 5 and keys[-1] == ("EDGE_SE3:QUAT", [4, 5])


def test_profiling_stage_timer_and_trace(tmp_path):
    """The spans' summary (the CLIs' ``stages.json``, which replaced the
    stage timer's) and the Chrome trace with the spans on its time base."""
    profiling.reset()
    with profiling.tracing(), profiling.span("a"):
        with profiling.trace(str(tmp_path / "tr")) as prof:
            with profiling.span("b"):
                torch.ones(8).sum()
    summary = profiling.summary()
    assert summary["a"]["calls"] == summary["b"]["calls"] == 1
    assert set(summary["a"]) == {"total_s", "calls", "mean_ms", "self_ms"}
    assert 0 <= summary["a"]["self_ms"] <= summary["a"]["total_s"] * 1e3 + 0.05  # total_s: 4 places
    profiling.dump(str(tmp_path / "stages.json"))
    with open(tmp_path / "stages.json") as f:
        assert json.load(f) == summary
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    span, = [e for e in events if e.get("cat") == "program_span"]
    ops = [e for e in events if e.get("name") == "aten::sum"]
    assert span["name"] == "b" and span["pid"] == "program spans" and ops
    assert all(span["ts"] <= op["ts"] and op["ts"] + op["dur"] <= span["ts"] + span["dur"]
               for op in ops)
    assert prof.key_averages() is not None
    fps = profiling.FpsMeter()
    fps.tick()
    assert fps.tick() > 0
    profiling.reset()


def test_native_library_that_does_not_load(tmp_path, monkeypatch):
    """A library built on another host (here: not a library at all) makes
    the loader unavailable with the reason, and the decoder reads."""
    bogus = tmp_path / "libslamloader-0.so"
    bogus.write_bytes(b"not an ELF file")
    monkeypatch.setattr(loader, "library_path", lambda: bogus)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "UNAVAILABLE", "")
    assert not loader.native_available()
    assert "does not load" in loader.UNAVAILABLE
