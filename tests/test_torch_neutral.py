"""The port's copies of the framework-neutral modules match the originals.

``ros_stereo_slam_tpu/__init__.py`` imports jax, so the port cannot import
even the numpy/dataclass modules of the JAX package: it carries copies.
These tests pin each copy to its original (source and behaviour) and check
that importing the port pulls in no JAX.
"""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import ros_stereo_slam_tpu.config as jcfg
import ros_stereo_slam_tpu_torch.config as tcfg
from ros_stereo_slam_tpu.data import synthetic as jsyn
from ros_stereo_slam_tpu.ops import grid as jgrid
from ros_stereo_slam_tpu.utils import metrics as jmet
from ros_stereo_slam_tpu_torch.data import synthetic as tsyn
from ros_stereo_slam_tpu_torch.ops import grid as tgrid
from ros_stereo_slam_tpu_torch.utils import metrics as tmet

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize(
    "rel", ["config.py", "ops/grid.py", "data/synthetic.py", "utils/metrics.py", "utils/ply.py",
            "viz/web.py", "viz/draw.py"]
)
def test_copy_source_matches_original(rel):
    """Verbatim copies: only the package name in imports differs, and the
    reference C++ sources cited in comments lose their absolute checkout
    prefix ("/<dir>/reference/src/..." -> "reference/src/...")."""
    orig = (ROOT / "ros_stereo_slam_tpu" / rel).read_text()
    copy = (ROOT / "ros_stereo_slam_tpu_torch" / rel).read_text()
    want = orig.replace("ros_stereo_slam_tpu.", "ros_stereo_slam_tpu_torch.")
    assert copy == re.sub(r"/\w+/reference/", "reference/", want)


@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_config_presets_identical(name):
    assert dataclasses.asdict(tcfg.PRESETS[name]()) == dataclasses.asdict(
        jcfg.PRESETS[name]()
    )


def test_grid_points_identical():
    for h, w, step, cap in ((376, 1241, 24, 768), (188, 620, 12, 1024), (64, 64, 15, 8)):
        jp, jm = jgrid.grid_points(h, w, step, cap)
        tp, tm = tgrid.grid_points(h, w, step, cap)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(tm, jm)


def test_small_world_renders_identical():
    jw = jsyn.small_world(n_frames=3, seed=5, scale=4)
    tw = tsyn.small_world(n_frames=3, seed=5, scale=4)
    np.testing.assert_array_equal(tw.poses, jw.poses)
    for a, b in zip(tw.render(2), jw.render(2)):
        np.testing.assert_array_equal(a, b)


def test_metrics_identical():
    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(20, 3))
    assert tmet.ate_rmse(est, gt) == jmet.ate_rmse(est, gt)
    assert tmet.rpe(est, gt, delta=2) == jmet.rpe(est, gt, delta=2)


def test_port_import_pulls_in_no_jax():
    code = (
        "import sys\n"
        "import ros_stereo_slam_tpu_torch\n"
        "from ros_stereo_slam_tpu_torch.models import convert, pipeline, step\n"
        "from ros_stereo_slam_tpu_torch.models import loop_closure, pose_graph, slam_scan, vocab\n"
        "from ros_stereo_slam_tpu_torch.models import bundle_adjust, slam, slam_chunked\n"
        "from ros_stereo_slam_tpu_torch.ops import lk_cuda, pnp, sor, triangulate\n"
        "from ros_stereo_slam_tpu_torch.ops import anms, fast, orb, orb_cuda, ransac, vocab_cuda\n"
        "from ros_stereo_slam_tpu_torch.ops import essential, match, sgbm\n"
        "from ros_stereo_slam_tpu_torch.kernels import build\n"
        "from ros_stereo_slam_tpu_torch.parallel import dist_ba, dist_map, dist_pgo, dryrun, mesh\n"
        "from ros_stereo_slam_tpu_torch.utils import checkpoint, metrics, outputs, ply, profiling\n"
        "from ros_stereo_slam_tpu_torch.models import frontend\n"
        "from ros_stereo_slam_tpu_torch.data import kitti, loader, png\n"
        "from ros_stereo_slam_tpu_torch.viz import web\n"
        "from ros_stereo_slam_tpu_torch.tools import build_vocab, run_kitti, run_synthetic\n"
        "from ros_stereo_slam_tpu_torch.tools import endurance_run, stereo_depth\n"
        "import torch\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "assert torch.get_float32_matmul_precision() == 'highest'\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'ros_stereo_slam_tpu' or m.startswith('ros_stereo_slam_tpu.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
