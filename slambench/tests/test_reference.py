"""The plain reference against the port's plain versions on the CPU, and
its bfloat16 control against its float32 self."""

import numpy as np
import pytest
import torch

from slambench import world
from slambench.reference import fast as fast_ref
from slambench.reference import lk as lk_ref
from slambench.reference import orb as orb_ref
from slambench.reference import pose_graph as pgo_ref
from slambench.reference import trajectory
from slambench.reference import vocab as vocab_ref
from slambench.tests.conftest import SMALL_CAMERA


@pytest.fixture(scope="module")
def frames():
    w = {"recipe": "corridor", "frames": 3, "speed_m": 0.8, "yaw_rate": 0.004,
         "half_w": 18.0, "end_z": 260.0}
    f = world.corridor_frames(w, 5, SMALL_CAMERA, "cpu")
    return f.left.float() / 255.0, f.right.float() / 255.0


def test_ate_is_the_ports():
    from ros_stereo_slam_tpu_torch.utils import metrics

    rng = np.random.default_rng(0)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), 0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.1, size=(20, 3))
    assert trajectory.ate_rmse(est, gt) == pytest.approx(metrics.ate_rmse(est, gt), rel=1e-12)
    assert trajectory.ate_rmse(gt, gt) < 1e-12


def _grid(h, w, step=24, margin=20):
    ys, xs = np.mgrid[margin:h - margin:step, margin:w - margin:step]
    return torch.from_numpy(np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32))


@pytest.mark.parametrize("iters,walk", [(6, 10), (8, 3)])
def test_lk_level_is_the_ports(frames, iters, walk):
    from ros_stereo_slam_tpu_torch.ops import lk

    left, _ = frames
    pts = _grid(160, 416)
    guess = pts + torch.tensor([1.5, -0.7])
    p = lk.LKParams(window=15, iters=iters, walk_iters=walk)
    want = lk._track_level(left[0], left[1], pts, guess, p)
    got = lk_ref.track_level(left[0], left[1], pts, guess, 15, iters, walk, p.eps, p.min_eig)
    assert torch.equal(got[2], want[2]) and bool(got[3].any())
    assert float((got[0] - want[0]).abs().max()) < 1e-4
    assert float((got[1] - want[1]).abs().max()) < 1e-4


def test_lk_control_in_bfloat16_reads_far_off(frames):
    left, _ = frames
    pts = _grid(160, 416)
    guess = pts + torch.tensor([1.5, -0.7])
    f32 = lk_ref.track_level(left[0], left[1], pts, guess, 15, 6, 10, 0.01, 1e-7)
    bf = lk_ref.track_level(left[0], left[1], pts, guess, 15, 6, 10, 0.01, 1e-7, torch.bfloat16)
    both = f32[2] & bf[2] & f32[3]
    assert float((f32[0] - bf[0])[both].abs().max()) > 0.02


def test_orb_signs_are_the_ports(frames):
    from ros_stereo_slam_tpu_torch.ops import orb

    left, _ = frames
    pts = _grid(160, 416, step=17, margin=18)
    valid = torch.ones(len(pts), dtype=torch.bool)
    valid[::5] = False
    want, _, _ = orb._level_describe_plain(left[0], pts, valid)
    got = orb_ref.signs(left[0], pts, valid)
    assert float((got != want).float().mean()) < 1e-3
    assert torch.equal(got[~valid], torch.zeros_like(got[~valid]))
    bf = orb_ref.signs(left[0], pts, valid, torch.bfloat16)
    assert float((bf != got)[valid].float().mean()) > 1e-3


def test_descent_is_the_ports():
    from ros_stereo_slam_tpu_torch.models import vocab
    from ros_stereo_slam_tpu_torch.ops import orb

    g = torch.Generator().manual_seed(0)
    k, levels = 4, 3
    centers = [torch.where(torch.rand((k ** (l + 1), 256), generator=g) < 0.5, 1, -1).to(torch.int8)
               for l in range(levels)]
    q = torch.where(torch.rand((300, 256), generator=g) < 0.5, 1.0, -1.0)
    q[:4] = centers[0][:4].float()  # ties at the first level
    packed = orb.pack_bits(q > 0)
    valid = torch.ones(300, dtype=torch.bool)
    valid[::7] = False
    tree = vocab.pack_centers(centers, k)
    want = vocab._descend_packed_plain(packed, valid, tree, k, levels)
    assert torch.equal(vocab_ref.words(packed, valid, centers, k), want)


def test_fast_scores_are_the_ports(frames):
    from ros_stereo_slam_tpu_torch.ops import fast

    img = frames[0][0]
    ours, theirs = fast_ref.score(img, 12 / 255), fast.fast_score(img, 12 / 255)
    torch.testing.assert_close(ours, theirs, rtol=1e-5, atol=1e-6)
    assert int((ours > 0).sum()) > 100
    pts = fast_ref.corners(img, 12 / 255, 50, 17)
    assert pts.shape == (50, 2) and bool((pts >= 17).all())
    s = ours[pts[:, 1].long(), pts[:, 0].long()]
    assert bool((s[:-1] >= s[1:]).all())  # the strongest first


def _lap(F=60, r=5.0):
    th = np.linspace(0, 2 * np.pi, F + 1)[:F]
    gt = np.tile(np.eye(4), (F, 1, 1))
    for i, t in enumerate(th):
        c, s = np.cos(t), np.sin(t)
        gt[i, :3, :3] = [[c, 0, s], [0, 1, 0], [-s, 0, c]]
        gt[i, :3, 3] = [r * (1 - c), 0, r * s]
    return torch.from_numpy(gt)


def test_pose_graph_is_the_ports():
    """A drifting odometry chain of a lap closed by two loop edges: the
    plain Gauss-Newton lands where the port's does, and both nearer the
    truth than the chain."""
    from ros_stereo_slam_tpu_torch.models import pose_graph as pg

    torch.manual_seed(0)
    gt = _lap()
    F = gt.shape[0]
    noise = pgo_ref.exp(torch.randn(F, 6, dtype=torch.float64)
                        * torch.tensor([0.02, 0.02, 0.02, 0.005, 0.01, 0.005]))
    rel = pgo_ref.inv(gt[:-1]) @ gt[1:]
    odo = [gt[0]]
    for i in range(F - 1):
        odo.append(odo[-1] @ rel[i] @ noise[i])
    odo = torch.stack(odo)
    edges = [(55, 2, (pgo_ref.inv(gt[55]) @ gt[2]).numpy()),
             (58, 5, (pgo_ref.inv(gt[58]) @ gt[5]).numpy())]
    ref = pgo_ref.optimize(odo, edges, 10)
    theirs = pg.optimize(odo.float(), F, pg.chain_measurements(odo.float()),
                         torch.tensor([55, 58]), torch.tensor([2, 5]),
                         torch.stack([torch.as_tensor(z).float() for _, _, z in edges]),
                         torch.ones(2, dtype=torch.bool), iters=10, cg_iters=128, damping=1e-6)

    def gap(a, b):
        return float((a[:, :3, 3].double() - b[:, :3, 3].double()).norm(dim=1).max())

    assert gap(theirs, ref) < 1e-4
    assert gap(ref, gt) < 0.5 * gap(odo, gt)
    one = pg.optimize(odo.float(), F, pg.chain_measurements(odo.float()),
                      torch.tensor([55, 58]), torch.tensor([2, 5]),
                      torch.stack([torch.as_tensor(z).float() for _, _, z in edges]),
                      torch.ones(2, dtype=torch.bool), iters=1, cg_iters=128, damping=1e-6)
    assert gap(one, ref) > 0.1 and gap(odo, ref) > 0.5  # one iteration, none: far off


def test_pose_graph_without_loop_edges_keeps_the_chain():
    gt = _lap(12)
    torch.testing.assert_close(pgo_ref.optimize(gt, [], 3), gt, rtol=0, atol=1e-9)


def test_se3_exp_and_log_are_inverse():
    xi = torch.randn(20, 6, dtype=torch.float64) * 0.5
    torch.testing.assert_close(pgo_ref.log(pgo_ref.exp(xi)), xi, rtol=0, atol=1e-9)

