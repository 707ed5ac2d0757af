"""The port's four CLIs (``ros_stereo_slam_tpu_torch/tools/``), each run
through ``main([...])`` with ``--device cpu`` on a tiny input and held to
the library calls it makes, bit for bit (the same frames, configs and
seeds give the same float results on one host):

- ``run_kitti`` over a 4-frame KITTI-layout tree at the geometry of
  ``camera_for_sequence("00")`` (1241x376; the CLI takes its camera from
  that table): ``--mode scan`` (uint8 staging) against ``run_offline`` on
  the same uint8 frames, trajectory.txt string for string; ``--preset
  mapping --mode stream`` against ``StereoSLAM`` fed the sequence's own
  frames and colours: trajectory.txt and map.ply byte for byte;
- ``build_vocab`` from the tree and from the synthetic world against ORB +
  ``vocab.train`` (npz arrays equal), and the tree's vocabulary equal to
  the JAX package's ``train`` over the same descriptors;
- ``run_synthetic`` odometry (scan) against ``run_offline`` on the same
  world, and loop closure (scan): the vocabulary it trains and saves
  equals the JAX package's ``train`` over the same descriptors;
- ``stereo_depth`` against ``sgbm.depth_cloud``: the PLY's points equal.

One ``python -m`` run in a subprocess imports no ``jax``
(``-X importtime`` lists every module it imports).  Without a card and
without ``--device cpu`` every CLI exits with code 2.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_kitti_tree as tree_mod
from ros_stereo_slam_tpu.models import vocab as jvocab
from ros_stereo_slam_tpu_torch.config import PRESETS
from ros_stereo_slam_tpu_torch.data import kitti
from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld, small_world
from ros_stereo_slam_tpu_torch.models import vocab
from ros_stereo_slam_tpu_torch.models.pipeline import run_offline
from ros_stereo_slam_tpu_torch.models.slam import StereoSLAM
from ros_stereo_slam_tpu_torch.ops import orb, sgbm
from ros_stereo_slam_tpu_torch.tools import build_vocab, run_kitti, run_synthetic, stereo_depth
from ros_stereo_slam_tpu_torch.utils import outputs, ply
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

ROOT = Path(__file__).resolve().parents[1]
FRAMES = 4


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Sequence 00: 4 frames of the corridor world rendered at KITTI 00's
    camera, quantized to uint8, with colour frames and poses."""
    root = str(tmp_path_factory.mktemp("kitti_cli"))
    world = SyntheticWorld(camera=kitti.camera_for_sequence("00"), n_frames=FRAMES, seed=11,
                           half_w=18.0)
    frames = [world.render(i) for i in range(FRAMES)]
    lefts = tree_mod.to_u8(np.stack([f[0] for f in frames]))
    rights = tree_mod.to_u8(np.stack([f[1] for f in frames]))
    rgbs = tree_mod.to_u8(np.stack([world.render_rgb(i) for i in range(FRAMES)]))
    tree_mod.write_tree(root, "00", lefts, rights, rgbs, world.poses, filters=(1, 2))
    return root, lefts, rights


def _rows(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


def test_run_kitti_scan_matches_run_offline(tree, tmp_path):
    root, lefts, rights = tree
    out = str(tmp_path / "scan")
    assert run_kitti.main(["--root", root, "--seq", "00", "--preset", "odometry", "--mode",
                           "scan", "--frames", str(FRAMES), "--device", "cpu",
                           "--out", out]) == 0
    cfg = PRESETS["odometry"]().replace(camera=kitti.camera_for_sequence("00"))
    res = run_offline(cfg, lefts, rights, device="cpu")
    assert _rows(os.path.join(out, "trajectory.txt")) == [
        outputs.pose_row_kitti(T) for T in res.trajectory]
    assert len(_rows(os.path.join(out, "metrics.jsonl"))) == FRAMES
    for name in ("trajectory.csv", "map.ply", "map.html", "poseGraph.g2o", "summary.json",
                 "stages.json", "trajectory.png", "error_curve.png"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name


def test_run_kitti_mapping_stream_matches_stereo_slam(tree, tmp_path):
    root = tree[0]
    out = str(tmp_path / "stream")
    assert run_kitti.main(["--root", root, "--preset", "mapping", "--mode", "stream",
                           "--frames", str(FRAMES), "--device", "cpu", "--out", out,
                           "--no-plots"]) == 0
    seq = kitti.KittiSequence(root, "00")
    slam = StereoSLAM(PRESETS["mapping"]().replace(camera=seq.camera), device="cpu")
    slam.initialize(*seq.frame(0), left_rgb=seq.frame_rgb(0))
    for i in range(1, FRAMES):
        slam.process_frame(*seq.frame(i), left_rgb=seq.frame_rgb(i))
    assert _rows(os.path.join(out, "trajectory.txt")) == [
        outputs.pose_row_kitti(T) for T in slam.trajectory_array()]
    slam.save_map(str(tmp_path / "lib.ply"))
    assert (tmp_path / "lib.ply").read_bytes() == Path(out, "map.ply").read_bytes()
    _, cols = ply.load_ply(os.path.join(out, "map.ply"))
    assert np.abs(cols[:, 0].astype(int) - cols[:, 2]).max() > 0  # colours, not gray
    assert not any(f.endswith(".png") for f in os.listdir(out))


def test_run_kitti_refuses_loop_closure_without_vocab(tree, tmp_path, capsys):
    assert run_kitti.main(["--root", tree[0], "--preset", "loop_closure", "--device", "cpu",
                           "--out", str(tmp_path / "lc")]) == 2
    assert "--vocab required" in capsys.readouterr().err
    assert run_kitti.main(["--root", str(tmp_path), "--device", "cpu"]) == 2


def _orb_descriptors(frames, features: int, device="cpu"):
    descs, docs = [], []
    for i, img in frames:
        f = orb.detect_and_compute(torch.as_tensor(img).to(device), features, n_levels=4)
        v = f.valid.numpy()
        descs.append(f.desc_sign.numpy()[v])
        docs.append(np.full(int(v.sum()), i))
    return np.concatenate(descs), np.concatenate(docs)


def _npz_equal(a: str, b: vocab.Vocabulary) -> None:
    with np.load(a) as z:
        assert int(z["k"]) == b.k and int(z["levels"]) == b.levels
        np.testing.assert_array_equal(z["idf"], b.idf.numpy())
        for i, c in enumerate(b.centers):
            np.testing.assert_array_equal(z[f"level_{i}"], c.numpy())


def test_build_vocab_from_tree_matches_train_and_jax(tree, tmp_path):
    out = str(tmp_path / "v.npz")
    assert build_vocab.main(["--root", tree[0], "--seq", "00", "--frames", str(FRAMES),
                             "--stride", "2", "--k", "4", "--levels", "2", "--features",
                             "128", "--out", out, "--device", "cpu"]) == 0
    seq = kitti.KittiSequence(tree[0], "00")
    X, docs = _orb_descriptors([(i, seq.frame(i)[0]) for i in (0, 2)], 128)
    voc = vocab.train(X, k=4, levels=2, doc_ids=docs, device="cpu")
    _npz_equal(out, voc)
    jv = jvocab.train(X, k=4, levels=2, doc_ids=docs)
    _npz_equal(out, vocab.Vocabulary(k=4, levels=2, idf=torch.from_numpy(jv.idf),
                                     centers=[torch.from_numpy(np.array(c))
                                              for c in jv.centers]))


def test_build_vocab_synthetic_matches_train(tmp_path):
    out = str(tmp_path / "s.npz")
    assert build_vocab.main(["--synthetic", "--frames", "5", "--stride", "4", "--k", "3",
                             "--levels", "2", "--features", "96", "--out", out,
                             "--device", "cpu"]) == 0
    world = small_world(n_frames=5, seed=3)
    X, docs = _orb_descriptors([(i, world.render(i)[0]) for i in (0, 4)], 96)
    _npz_equal(out, vocab.train(X, k=3, levels=2, doc_ids=docs, device="cpu"))


def test_run_synthetic_odometry_scan_matches_run_offline(tmp_path):
    out = str(tmp_path / "syn")
    assert run_synthetic.main(["--frames", "5", "--scale", "4", "--mode", "scan",
                               "--device", "cpu", "--out", out, "--no-plots"]) == 0
    world, cfg = run_synthetic.world_and_config(5, False, 13, 4, "odometry")
    frames = [world.render(i)[:2] for i in range(5)]
    res = run_offline(cfg, np.stack([f[0] for f in frames]), np.stack([f[1] for f in frames]),
                      device="cpu")
    assert _rows(os.path.join(out, "trajectory.txt")) == [
        outputs.pose_row_kitti(T) for T in res.trajectory]


def test_run_synthetic_loop_closure_trains_jax_vocabulary(tmp_path):
    """The host-recursive trainer through the CLI (k = 8, L = 3) equals the
    JAX package's on the same descriptors: centres and IDF bitwise."""
    out = str(tmp_path / "lc")
    assert run_synthetic.main(["--preset", "loop_closure", "--orbit", "--frames", "12",
                               "--scale", "4", "--mode", "scan", "--device", "cpu",
                               "--out", out, "--no-plots"]) == 0
    world, cfg = run_synthetic.world_and_config(12, True, 13, 4, "loop_closure")
    X, docs = run_synthetic.sequence_descriptors(
        [world.render(i)[0] for i in range(12)], cfg, "cpu")
    jv = jvocab.train(X, k=8, levels=3, doc_ids=docs)
    _npz_equal(os.path.join(out, "vocab.npz"), vocab.Vocabulary(
        k=8, levels=3, idf=torch.from_numpy(jv.idf),
        centers=[torch.from_numpy(np.array(c)) for c in jv.centers]))
    assert len(_rows(os.path.join(out, "metrics.jsonl"))) == 12


def test_stereo_depth_matches_depth_cloud(tmp_path):
    out = str(tmp_path / "sd")
    assert stereo_depth.main(["--synthetic", "--frames", "1", "--device", "cpu", "--out", out,
                              "--no-plots"]) == 0
    world = small_world(n_frames=1, seed=5)
    L, R, _ = world.render(0)
    c = world.camera
    _, pts = sgbm.depth_cloud(torch.from_numpy(L), torch.from_numpy(R),
                              Pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy), c.baseline)
    got, _ = ply.load_ply(os.path.join(out, "StereoCloud.ply"))
    assert len(got) > 100
    np.testing.assert_array_equal(got, pts.numpy())


def test_python_m_runs_without_jax(tmp_path):
    out = str(tmp_path / "sub")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "ros_stereo_slam_tpu_torch.tools.stereo_depth",
         "--synthetic", "--frames", "1", "--device", "cpu", "--out", out, "--no-plots"],
        capture_output=True, text=True, cwd=str(ROOT), env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    imported = [line.split("|")[-1].strip() for line in proc.stderr.splitlines()
                if line.startswith("import time:")]
    assert "ros_stereo_slam_tpu_torch.ops.sgbm" in imported
    assert not [m for m in imported if m == "jax" or m.startswith(("jax.", "jaxlib"))]
    assert not [m for m in imported if m.startswith("ros_stereo_slam_tpu.")]
    assert "StereoCloud.ply" in proc.stdout


@pytest.mark.parametrize("cli", [run_kitti, run_synthetic, build_vocab, stereo_depth],
                         ids=["run_kitti", "run_synthetic", "build_vocab", "stereo_depth"])
def test_cli_without_a_card_exits_nonzero(cli, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    argv = ["--out", str(tmp_path / "x.npz")] if cli is build_vocab else []
    assert cli.main(argv) == 2
    assert "torch.cuda.is_available() is false" in capsys.readouterr().err
