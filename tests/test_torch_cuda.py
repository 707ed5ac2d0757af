"""Kernel K1 (``csrc/lk_level.cu``) on the card against its plain version.

These tests need an NVIDIA GPU and nvcc; without them they skip.  The file
imports nothing of JAX, so it runs on the GPU host, which has no JAX:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

(``--noconftest``: tests/conftest.py configures JAX.)  Tolerances are those
of the JAX package's kernel-vs-oracle test: 5e-3 px, 1e-2 residual, ``ok``
equal, on points that stay inside the image.
"""

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.data.synthetic import _smooth_noise_2d
from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda

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
