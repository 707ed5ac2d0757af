"""Kernels K1, K2 and K3 on the card against their plain versions.

These tests need an NVIDIA GPU and nvcc; without them they skip.  The file
imports nothing of JAX, so it runs on the GPU host, which has no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances:

- K1 (``csrc/lk_level.cu``): those of the JAX package's kernel-vs-oracle
  test: 5e-3 px, 1e-2 residual, ``ok`` equal, on points that stay inside
  the image.
- K2 (``csrc/orb_desc.cu``): >= 99.5 % of descriptor bits equal on corners
  >= 17 px inside the image, and no such corner differing in more than 4
  of its 256 bits (bits flip where the two samples of a pair nearly tie,
  ROADMAP H8); moments within 2e-3 + 1e-5 relative (f32 sums
  of 709 terms in another order).
- K3 (``csrc/vocab_descend.cu``): word ids equal on every row (exact).
"""

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.data.synthetic import _smooth_noise_2d
from ros_stereo_slam_tpu_torch.models import vocab
from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda, orb, orb_cuda, vocab_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _setup(seed, n, shape=(192, 256), shift=(-2, 3)):
    rng = np.random.default_rng(seed)
    img = _smooth_noise_2d(shape, rng, octaves=5, base_period=24)
    cur = np.roll(img, shift, axis=(0, 1)).astype(np.float32)
    pts = np.stack([rng.uniform(30, shape[1] - 30, n),
                    rng.uniform(30, shape[0] - 30, n)], 1).astype(np.float32)
    guess = (pts + rng.uniform(-1, 1, pts.shape)).astype(np.float32)
    return [torch.from_numpy(a) for a in (img, cur, pts, guess)]


@pytest.mark.parametrize("window,iters", [(15, 6), (15, 10), (21, 8), (31, 4)])
def test_kernel_matches_plain_version(cuda_device, window, iters):
    args = [t.to(cuda_device) for t in _setup(window + iters, 200)]
    params = lk.LKParams(window=window, iters=iters, walk_iters=max(iters, 10))
    before = lk_cuda.LAUNCHES
    kg, kr, kok = lk_cuda.track_level(*args, params)
    pg, pr, pok = lk._track_level(*args, params)
    torch.cuda.synchronize()
    assert lk_cuda.LAUNCHES == before + 1
    assert torch.equal(kok, pok)
    np.testing.assert_allclose(kg.cpu().numpy(), pg.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(kr.cpu().numpy(), pr.cpu().numpy(), atol=1e-2)
    flow = (kg.cpu() - args[2].cpu()).numpy()
    assert np.median(np.abs(flow - np.array([3.0, -2.0]))) < 0.05


def test_kernel_wrapper_checks_inputs(cuda_device):
    img, cur, pts, guess = [t.to(cuda_device) for t in _setup(0, 16)]
    params = lk.LKParams(window=15, iters=6)
    with pytest.raises(ValueError, match="contiguous"):
        lk_cuda.track_level(img.t(), cur.t(), pts, guess, params)
    with pytest.raises(TypeError, match="float32"):
        lk_cuda.track_level(img.double(), cur, pts, guess, params)
    with pytest.raises(ValueError, match="is on"):
        lk_cuda.track_level(img, cur.cpu(), pts, guess, params)
    with pytest.raises(ValueError, match="window"):
        lk_cuda.track_level(img, cur, pts, guess, params._replace(window=33))
    empty = torch.empty((0, 2), device=cuda_device)
    out = lk_cuda.track_level(img, cur, empty, empty, params)
    assert out[0].shape == (0, 2)


@pytest.mark.parametrize("shape,budget", [((376, 1241), 173), ((193, 635), 89)])
def test_orb_kernel_matches_plain_version(cuda_device, shape, budget):
    rng = np.random.default_rng(shape[0])
    img = torch.from_numpy(_smooth_noise_2d(shape, rng, octaves=5, base_period=24))
    img = img.to(cuda_device)
    pts, valid = orb._level_corners(img, budget, 12.0 / 255.0)
    before = orb_cuda.LAUNCHES
    ks, km = orb_cuda.orb_descriptors(img, pts)
    ps, pm = orb._descriptors_plain(img, pts)
    torch.cuda.synchronize()
    assert orb_cuda.LAUNCHES == before + 1
    assert int(valid.sum()) > budget // 2
    agree = (ks == ps)[valid].float().mean().item()
    assert agree >= 0.995, agree
    assert int((ks != ps)[valid].sum(dim=1).max()) <= 4
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), atol=2e-3, rtol=1e-5)
    assert set(torch.unique(ks).tolist()) <= {-1.0, 1.0}


def test_orb_kernel_border_corners_stay_in_bounds(cuda_device):
    """Corners on and beyond the border: the kernel clamps every sample as
    bilinear_at does (same moments as the plain version), reads nothing
    outside the image, and matches the plain version there too."""
    rng = np.random.default_rng(5)
    img = torch.from_numpy(_smooth_noise_2d((64, 96), rng)).to(cuda_device)
    pts = torch.tensor([[0.0, 0.0], [95.0, 63.0], [18.0, 30.0], [-5.0, 70.0],
                        [float("nan"), 10.0]], device=cuda_device)
    ks, km = orb_cuda.orb_descriptors(img, pts)
    ps, pm = orb._descriptors_plain(img, pts)
    torch.cuda.synchronize()
    assert torch.isfinite(km).all()
    np.testing.assert_allclose(km[:4].cpu().numpy(), pm[:4].cpu().numpy(), atol=2e-3,
                               rtol=1e-5)


def test_orb_kernel_wrapper_checks_inputs(cuda_device):
    img = torch.rand((64, 96), device=cuda_device)
    pts = torch.full((4, 2), 32.0, device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        orb_cuda.orb_descriptors(img.double(), pts)
    with pytest.raises(ValueError, match="contiguous"):
        orb_cuda.orb_descriptors(img.t(), pts)
    with pytest.raises(ValueError, match="is on"):
        orb_cuda.orb_descriptors(img, pts.cpu())
    sign, m = orb_cuda.orb_descriptors(img, torch.empty((0, 2), device=cuda_device))
    assert sign.shape == (0, 256) and m.shape == (0, 2)


def _sign_tables(rng, k, first, last):
    """Random +-1 int8 tables for levels first..last of a k-ary tree."""
    return [torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(k ** (l + 1), 256)))
            for l in range(first, last + 1)]


def test_vocab_kernel_matches_plain_version(cuda_device):
    rng = np.random.default_rng(3)
    k, n = 9, 512
    tables = [t.to(cuda_device) for t in _sign_tables(rng, k, 3, 4)]  # 6,561 and 59,049 rows
    q = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), size=(n, 256)))
    q[::7] = 0.0  # invalid features: all-zero rows
    q = q.to(cuda_device)
    node = torch.from_numpy(rng.integers(0, k**3, size=n)).to(cuda_device)
    before = vocab_cuda.LAUNCHES
    out = vocab_cuda.deep_descend(q, node, tables, k)
    ref = vocab._deep_descend_plain(q, node, tables, k)
    torch.cuda.synchronize()
    assert vocab_cuda.LAUNCHES == before + 1
    assert torch.equal(out, ref)
    # zero rows tie at every level and take child 0 each time
    assert torch.equal(out[::7], node[::7] * k * k)


def test_vocab_kernel_first_max_on_ties(cuda_device):
    """Duplicate sibling rows force exact ties: the lowest sibling wins."""
    rng = np.random.default_rng(7)
    k, n = 4, 256
    t = rng.choice(np.array([-1, 1], np.int8), size=(k**3, 256)).reshape(-1, k, 256)
    t[:, 2] = t[:, 1]
    t[:, 3] = t[:, 0]
    tables = [torch.from_numpy(t.reshape(-1, 256)).to(cuda_device)]
    q = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), size=(n, 256)))
    q = q.to(cuda_device)
    node = torch.from_numpy(rng.integers(0, k**2, size=n)).to(cuda_device)
    out = vocab_cuda.deep_descend(q, node, tables, k)
    ref = vocab._deep_descend_plain(q, node, tables, k)
    assert torch.equal(out, ref)
    assert set(torch.unique(out % k).tolist()) <= {0, 1}


def test_descend_routes_deep_levels_through_kernel(cuda_device):
    """k = 9, L = 5: levels 0-3 dense, level 4 (59,049 rows) through K3;
    the word ids equal the CPU route's."""
    rng = np.random.default_rng(11)
    k = 9
    centers = _sign_tables(rng, k, 0, 4)
    q = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), size=(300, 256)))
    cpu = vocab._descend(centers, q, k, 5)
    before = vocab_cuda.LAUNCHES
    gpu = vocab._descend([c.to(cuda_device) for c in centers], q.to(cuda_device), k, 5)
    assert vocab_cuda.LAUNCHES == before + 1
    assert torch.equal(gpu.cpu(), cpu)


def test_vocab_kernel_wrapper_checks_inputs(cuda_device):
    k = 3
    t = torch.ones((27, 256), dtype=torch.int8, device=cuda_device)
    q = torch.ones((4, 256), device=cuda_device)
    node = torch.zeros((4,), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int8"):
        vocab_cuda.deep_descend(q, node, [t.float()], k)
    with pytest.raises(ValueError, match="is on"):
        vocab_cuda.deep_descend(q, node, [t.cpu()], k)
    with pytest.raises(ValueError, match=r"\(N,\)"):
        vocab_cuda.deep_descend(q, node[:2], [t], k)
    # a node outside its table comes back as -1 instead of reading past it
    out = vocab_cuda.deep_descend(q, torch.tensor([0, 8, 9, 100], device=cuda_device), [t], k)
    assert out.tolist()[:2] == [0, 24] and out.tolist()[2:] == [-1, -1]
