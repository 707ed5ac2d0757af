"""Kernels K1, K2 and K3, and the lane-gridded K1b and K2b, on the card
against their plain versions.

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
  The folded outputs of ``level_describe`` are exact: the packed words are
  ``pack_bits`` of the kernel's own signs, invalid rows are zero, valid rows
  equal those of the call with every corner valid; corners 17..21 px from a border (the
  staged patch hangs over it) keep the bit bound.  K1's folded gate: a
  point whose ``ok`` is false returns its guess, bit for bit; points within
  a window of a border read nothing outside the image (NaN guard rows).
  Two runs of one call are bitwise equal (no atomics).
- K3 (``csrc/vocab_descend.cu``): word ids equal to the plain version on
  every row (exact): full width, ties, invalid rows, two sibling passes
  (k = 20), two runs bitwise equal.
- K1b and K2b (B lanes through each source's one entry point): K1's and
  K2's bounds against the lane loops of the plain versions, and bitwise
  equal, lane by lane, to the single-lane calls.
- K1 and K1b with freeze-polish (``walk_iters < iters``): K1's bounds, on
  interior points and on points whose walk converges next to the right or
  bottom border, where the polish anchor clamps and the clamped sample
  must still move them; NaN guard rows around border points.
- The points-sharded odometry step (``parallel/dist_frontend.py``) on a
  one-rank NCCL group at the corridor's shapes (1241x376, 768 points):
  bitwise ``frontend.odometry_step`` with the same seed, through K1.
- PnP's CUDA graph (``ops/pnp.py::_solve``): the replayed solve equals
  the eager ``_pnp_from_sets`` bitwise (the same kernels on the same
  shapes) over 16 draws of 1 and 2 lanes, with and without the prior,
  and with the 8 px retry ladder engaged; one capture per signature; a
  first result keeps its values through a second replay; a single-lane
  solve at the loop edge's shapes replays too, bitwise the eager solve of
  its sets as one lane; the 97-frame
  bench corridor through ``run_offline`` gives the eager run's poses.
- BA's CUDA graph (``models/bundle_adjust.py::ba_solve``): the replayed
  solve equals the eager ``_solve`` bit for bit over 6 windows at the
  cell's shapes (9 poses, 768 landmarks), 6 diverging windows that keep
  their input (the RMS grows) and 6 degenerate ones whose factorisation
  fails (a non-finite observation); one capture per signature; two
  replays of one window equal; lane 0's result keeps its values through
  lane 1's replay; the BA cell's 97-frame corridor through
  ``run_offline`` gives the eager run's poses and BA RMS, every solve
  after the capture replayed.
- ORB's CUDA graph (``ops/orb.py::_corner_stage`` through
  ``utils/cuda_graph.py::ORB``): ``detect_and_compute`` at 1241x376 with
  its corner stage replayed equals the eager call on every field of
  ``OrbFeatures``, bit for bit, over 3 frames of each case (4 levels with
  512 features, 1 level at the frontend's 768, a 2-lane stack, a blank
  frame with no corner); one capture per signature; K2 still launches
  once a level outside the graph; a first result keeps its values through
  a second frame's replay, which gives that frame's eager result.
- The endurance CLI's scan posture (``tools/endurance_run.py``) at
  1241x376 over a tiled 160-pose lap with both rings wrapping: at least
  3 closures at exact revisits, post-PGO ATE below odometry-only, K3 once
  per detection frame.
"""

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.data.synthetic import _smooth_noise_2d
from ros_stereo_slam_tpu_torch.models import vocab
from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda, orb, orb_cuda, vocab_cuda
from ros_stereo_slam_tpu_torch.utils import cuda_graph

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _every(pts):
    """Every corner of `pts` valid: ``level_describe``'s raw signs."""
    return torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)


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


def test_kernel_folds_the_gate_and_repeats_bitwise(cuda_device):
    """Half of the image is flat: points there fail the min-eigenvalue gate
    and come back as their guesses, bit for bit; one allocation carries the
    three outputs; a second run gives the same bits."""
    img, cur, pts, guess = _setup(3, 200)
    img[:, :128] = 0.5
    cur[:, :128] = 0.5
    args = [t.to(cuda_device) for t in (img, cur, pts, guess)]
    params = lk.LKParams(window=15, iters=6)
    kg, kr, kok = lk_cuda.track_level(*args, params)
    pg, pr, pok = lk._track_level(*args, params)
    again = lk_cuda.track_level(*args, params)
    torch.cuda.synchronize()
    assert kok.dtype == torch.bool and torch.equal(kok, pok)
    assert 20 < int(kok.sum()) < 180
    assert torch.equal(kg[~kok], args[3][~kok])
    assert torch.isfinite(kr).all()
    assert all(torch.equal(x, y) for x, y in zip((kg, kr, kok), again))
    assert kg.untyped_storage().data_ptr() == kok.untyped_storage().data_ptr()


@pytest.mark.parametrize("window", [15, 21])
def test_kernel_border_points_read_inside_the_image(cuda_device, window):
    """Points within a window of a border, where every tile start clamps:
    the image lies between NaN rows, so a read above or below it shows."""
    rng = np.random.default_rng(window)
    H, W = 96, 128
    img = torch.from_numpy(_smooth_noise_2d((H, W), rng, octaves=4, base_period=16))
    d = rng.uniform(0.0, window, 64)
    x = np.concatenate([d[:16], W - 1 - d[16:32], rng.uniform(0, W - 1, 32)])
    y = np.concatenate([rng.uniform(0, H - 1, 32), d[32:48], H - 1 - d[48:]])
    pts = torch.from_numpy(np.stack([x, y], 1).astype(np.float32)).to(cuda_device)
    pad = window + 4
    guarded = torch.full(((H + 2 * pad) * W,), float("nan"), device=cuda_device)
    inner = guarded[pad * W:(pad + H) * W].view(H, W)
    inner.copy_(img)
    params = lk.LKParams(window=window, iters=6)
    kg, kr, kok = lk_cuda.track_level(inner, inner, pts, pts.clone(), params)
    torch.cuda.synchronize()
    assert torch.isfinite(kg).all() and torch.isfinite(kr).all()
    # the image against itself from the true position: nothing runs away
    assert float((kg - pts).abs().max()) < window


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
    ks, km, _ = orb_cuda.level_describe(img, pts, _every(pts))
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
    ks, km, _ = orb_cuda.level_describe(img, pts, _every(pts))
    ps, pm = orb._descriptors_plain(img, pts)
    torch.cuda.synchronize()
    assert torch.isfinite(km).all()
    np.testing.assert_allclose(km[:4].cpu().numpy(), pm[:4].cpu().numpy(), atol=2e-3,
                               rtol=1e-5)


@pytest.mark.parametrize("shape", [(376, 1241), (193, 635), (64, 96)])
def test_orb_kernel_corners_17_to_21_px_from_borders(cuda_device, shape):
    """The nearest valid corners: the staged 44 x 44 patch hangs over the
    border (its origin is not clamped, fault F3), the samples are still
    bilinear_at's."""
    rng = np.random.default_rng(shape[1])
    img = torch.from_numpy(_smooth_noise_2d(shape, rng, octaves=5, base_period=24))
    img = img.to(cuda_device)
    H, W = shape
    xy = []
    for d in range(17, 22):
        xy += [(d, H // 2), (W - 1 - d, H // 3), (W // 2, d), (W // 3, H - 1 - d),
               (d, d), (W - 1 - d, d), (d, H - 1 - d), (W - 1 - d, H - 1 - d)]
    pts = torch.tensor(xy, dtype=torch.float32, device=cuda_device)
    valid = torch.ones(len(xy), dtype=torch.bool, device=cuda_device)
    ks, km, kw = orb_cuda.level_describe(img, pts, valid)
    ps, pm = orb._descriptors_plain(img, pts)
    torch.cuda.synchronize()
    assert int((ks != ps).sum(dim=1).max()) <= 4
    assert (ks == ps).float().mean().item() >= 0.995
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), atol=2e-3, rtol=1e-5)
    assert torch.equal(kw, orb.pack_bits(ks > 0))


def test_orb_kernel_non_integer_corners(cuda_device):
    """Corners with a fraction take the kernel's general centroid route."""
    rng = np.random.default_rng(8)
    img = torch.from_numpy(_smooth_noise_2d((96, 128), rng, octaves=4, base_period=16))
    img = img.to(cuda_device)
    pts = torch.from_numpy(np.stack([rng.uniform(17, 110, 40), rng.uniform(17, 78, 40)],
                                    1).astype(np.float32)).to(cuda_device)
    ks, km, _ = orb_cuda.level_describe(img, pts, _every(pts))
    ps, pm = orb._descriptors_plain(img, pts)
    assert int((ks != ps).sum(dim=1).max()) <= 4
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), atol=2e-3, rtol=1e-5)


@pytest.mark.parametrize("lanes", [0, 2])
def test_level_describe_folds_the_epilogue(cuda_device, lanes):
    """level_describe: one launch; the packed words are pack_bits of the
    kernel's own signs, invalid rows are zero, valid rows and the moments are
    those of the same call with every corner valid, and a second run gives
    the same bits."""
    rng = np.random.default_rng(21 + lanes)
    shape, budget = (241, 794), 111
    imgs = torch.from_numpy(np.stack([_smooth_noise_2d(shape, rng, octaves=5, base_period=24)
                                      for _ in range(max(lanes, 1))])).to(cuda_device)
    img = imgs if lanes else imgs[0]
    pts, valid = orb._level_corners(img, budget, 12.0 / 255.0)
    valid = valid.clone()
    valid[..., ::4] = False
    before = (orb_cuda.LAUNCHES, orb_cuda.BATCH_LAUNCHES)
    ks, km, kw = orb_cuda.level_describe(img, pts, valid)
    assert (orb_cuda.LAUNCHES, orb_cuda.BATCH_LAUNCHES) == (
        before[0] + (lanes == 0), before[1] + (lanes > 0))
    again = orb_cuda.level_describe(img, pts, valid)
    raw_s, raw_m, _ = orb_cuda.level_describe(img, pts, _every(pts))
    ps, pm, pw = orb._level_describe_plain(img, pts, valid)
    torch.cuda.synchronize()
    assert kw.dtype == torch.int32 and kw.shape == (*pts.shape[:-1], 8)
    assert torch.equal(kw, orb.pack_bits(ks > 0))
    assert not ks[~valid].any() and not kw[~valid].any()
    assert torch.equal(ks[valid], raw_s[valid]) and torch.equal(km, raw_m)
    assert all(torch.equal(x, y) for x, y in zip((ks, km, kw), again))
    assert int((ks != ps)[valid].sum(dim=-1).max()) <= 4
    same_rows = (ks == ps).all(dim=-1)
    assert torch.equal(kw[same_rows], pw[same_rows])
    for b in range(lanes):  # each lane: the single-lane call, bitwise
        for x, y in zip((ks, km, kw), orb_cuda.level_describe(img[b], pts[b], valid[b])):
            assert torch.equal(x[b], y)
    with pytest.raises(ValueError, match="valid"):
        orb_cuda.level_describe(img, pts, valid.float())


def test_orb_kernel_wrapper_checks_inputs(cuda_device):
    img = torch.rand((64, 96), device=cuda_device)
    pts = torch.full((4, 2), 32.0, device=cuda_device)
    valid = _every(pts)
    with pytest.raises(TypeError, match="float32"):
        orb_cuda.level_describe(img.double(), pts, valid)
    with pytest.raises(ValueError, match="contiguous"):
        orb_cuda.level_describe(img.t(), pts, valid)
    with pytest.raises(ValueError, match="is on"):
        orb_cuda.level_describe(img, pts.cpu(), valid)
    empty = torch.empty((0, 2), device=cuda_device)
    sign, m, words = orb_cuda.level_describe(img, empty, _every(empty))
    assert sign.shape == (0, 256) and m.shape == (0, 2) and words.shape == (0, 8)


def _sign_tables(rng, k, first, last):
    """Random +-1 int8 tables for levels first..last of a k-ary tree."""
    return [torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(k ** (l + 1), 256)))
            for l in range(first, last + 1)]


def _queries(rng, n, dev, invalid_every=7):
    """n random packed descriptors, every `invalid_every`-th invalid (its
    words zero, as ORB leaves them)."""
    q = torch.from_numpy(rng.integers(-2**31, 2**31, size=(n, 8), dtype=np.int64)
                         .astype(np.int32))
    valid = torch.ones(n, dtype=torch.bool)
    valid[::invalid_every] = False
    q[~valid] = 0
    return q.to(dev), valid.to(dev)


def test_vocab_kernel_matches_plain_version(cuda_device):
    """The full-width tree (k = 9, L = 6: 597,870 packed rows), 512 and
    1,024 descriptors: word ids equal on every row, one launch a call."""
    rng = np.random.default_rng(3)
    k, L = 9, 6
    tree = vocab.pack_centers(_sign_tables(rng, k, 0, L - 1), k).to(cuda_device)
    for n in (512, 1024):
        q, valid = _queries(rng, n, cuda_device)
        before = vocab_cuda.LAUNCHES
        out = vocab_cuda.descend(q, valid, tree, k, L)
        ref = vocab._descend_packed_plain(q, valid, tree, k, L)
        torch.cuda.synchronize()
        assert vocab_cuda.LAUNCHES == before + 1
        assert out.dtype == torch.int64 and torch.equal(out, ref)
        assert int(out.max()) < k ** L


def test_vocab_kernel_first_max_on_ties(cuda_device):
    """Duplicate sibling rows at every level force exact ties: the lowest
    sibling wins, through the wrapper and the bare launch."""
    rng = np.random.default_rng(7)
    k, L, n = 4, 3, 256
    tabs = []
    for t in _sign_tables(rng, k, 0, L - 1):
        t = t.reshape(-1, k, 256).clone()
        t[:, 2] = t[:, 1]
        t[:, 3] = t[:, 0]
        tabs.append(t.reshape(-1, 256))
    tree = vocab.pack_centers(tabs, k).to(cuda_device)
    q, valid = _queries(rng, n, cuda_device, invalid_every=n + 1)
    ref = vocab._descend_packed_plain(q, valid, tree, k, L)
    launch = vocab_cuda.bare_launch(q, valid, tree, k, L)
    assert launch() == 0
    torch.cuda.synchronize()
    assert torch.equal(launch.outputs[0], ref)
    assert torch.equal(vocab_cuda.descend(q, valid, tree, k, L), ref)
    for m in range(L):
        assert set(torch.unique(ref // k ** m % k).tolist()) <= {0, 1}


def test_vocab_kernel_invalid_rows_and_runs_equal(cuda_device):
    """Invalid rows take word 0 whatever their words hold; two runs of one
    call agree bit for bit; k = 20 takes two sibling chunks."""
    rng = np.random.default_rng(5)
    for k, L in ((9, 4), (20, 3)):
        tree = vocab.pack_centers(_sign_tables(rng, k, 0, L - 1), k).to(cuda_device)
        q, valid = _queries(rng, 700, cuda_device, invalid_every=3)
        q[~valid] = -1  # garbage words on invalid rows are not read
        out = vocab_cuda.descend(q, valid, tree, k, L)
        again = vocab_cuda.descend(q, valid, tree, k, L)
        ref = vocab._descend_packed_plain(q, valid, tree, k, L)
        assert torch.equal(out, again) and torch.equal(out, ref)
        assert not out[~valid].any() and bool(out[valid].any())


def test_descend_routes_deep_levels_through_kernel(cuda_device):
    """_descend on sign rows (k = 9, L = 5): every level through one K3
    launch; the word ids equal the CPU route's."""
    rng = np.random.default_rng(11)
    k = 9
    centers = _sign_tables(rng, k, 0, 4)
    q = torch.from_numpy(rng.choice(np.array([-1.0, 1.0], np.float32), size=(300, 256)))
    q[::9] = 0.0
    cpu = vocab._descend(centers, q, k, 5)
    before = vocab_cuda.LAUNCHES
    gpu = vocab._descend([c.to(cuda_device) for c in centers], q.to(cuda_device), k, 5)
    assert vocab_cuda.LAUNCHES == before + 1
    assert torch.equal(gpu.cpu(), cpu)


def test_vocab_kernel_wrapper_checks_inputs(cuda_device):
    k = 3
    tabs = [torch.ones((3, 256), dtype=torch.int8), torch.ones((9, 256), dtype=torch.int8)]
    tree = vocab.pack_centers(tabs, k).to(cuda_device)
    q = torch.zeros((4, 8), dtype=torch.int32, device=cuda_device)
    valid = torch.ones((4,), dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        vocab_cuda.descend(q.float(), valid, tree, k, 2)
    with pytest.raises(ValueError, match=r"\(N,\) bool"):
        vocab_cuda.descend(q, valid[:2], tree, k, 2)
    with pytest.raises(ValueError, match="is on"):
        vocab_cuda.descend(q, valid, tree.to("cpu"), k, 2)
    with pytest.raises(ValueError, match="levels"):
        vocab_cuda.descend(q, valid, tree, k, 3)
    with pytest.raises(ValueError, match="rows, not"):
        vocab_cuda.descend(q, valid, tree, 2, 2)
    # the +-1 contract: a 0 or a 2 entry is refused before anything is packed
    for entry in (0, 2):
        bad = [t.clone() for t in tabs]
        bad[1][4, 9] = entry
        with pytest.raises(ValueError, match="level 1 row 4"):
            vocab.pack_centers([t.to(cuda_device) for t in bad], k)
    assert vocab_cuda.descend(q[:0], valid[:0], tree, k, 2).shape == (0,)


def _lanes(seeds, n, shape=(192, 256)):
    """(B, ...) stacks of _setup's image pairs, points and guesses, one
    lane per seed, each lane with its own shift."""
    cases = [_setup(sd, n, shape, shift=(-2 + b, 3 - 2 * b)) for b, sd in enumerate(seeds)]
    return [torch.stack(t) for t in zip(*cases)]


@pytest.mark.parametrize("window,iters", [(15, 6), (21, 10)])
def test_batch_kernel_matches_plain_version(cuda_device, window, iters):
    args = [t.to(cuda_device) for t in _lanes((1, 2, 3), 200)]
    params = lk.LKParams(window=window, iters=iters, walk_iters=max(iters, 10))
    before, before_1 = lk_cuda.BATCH_LAUNCHES, lk_cuda.LAUNCHES
    kg, kr, kok = lk_cuda.track_level_batch(*args, params)
    assert (lk_cuda.BATCH_LAUNCHES, lk_cuda.LAUNCHES) == (before + 1, before_1)
    pg, pr, pok = lk_cuda.track_level_batch_plain(*args, params)
    torch.cuda.synchronize()
    assert torch.equal(kok, pok)
    np.testing.assert_allclose(kg.cpu().numpy(), pg.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(kr.cpu().numpy(), pr.cpu().numpy(), atol=1e-2)
    for b in range(3):  # each lane: the single-lane entry point, bitwise
        sg, sr, sok = lk_cuda.track_level(*(t[b] for t in args), params)
        assert torch.equal(sg, kg[b]) and torch.equal(sr, kr[b]) and torch.equal(sok, kok[b])
    one = lk_cuda.track_level_batch(*(t[:1] for t in args), params)  # B = 1
    assert all(torch.equal(x[0], y[0]) for x, y in zip(one, (kg, kr, kok)))


def test_batch_kernel_wrapper_checks_inputs(cuda_device):
    img, cur, pts, guess = [t.to(cuda_device) for t in _lanes((0, 1), 16)]
    params = lk.LKParams(window=15, iters=6)
    with pytest.raises(ValueError, match="images"):
        lk_cuda.track_level_batch(img, cur[:1], pts, guess, params)
    with pytest.raises(ValueError, match="B, N, 2"):
        lk_cuda.track_level_batch(img, cur, pts[:1], guess, params)
    with pytest.raises(ValueError, match="contiguous"):
        lk_cuda.track_level_batch(img.transpose(1, 2), cur.transpose(1, 2), pts, guess, params)
    with pytest.raises(TypeError, match="float32"):
        lk_cuda.track_level_batch(img, cur, pts.double(), guess, params)
    with pytest.raises(ValueError, match="B, H, W"):
        lk_cuda.track_level_batch(img[0], cur[0], pts[0], guess[0], params)


def test_orb_batch_kernel_matches_plain_version(cuda_device):
    """Two lanes at the main path's level-0 shape, and a third, black lane
    where every sample is exactly 0, so every pair ties (both routes give
    -1 there)."""
    rng = np.random.default_rng(9)
    shape, budget = (376, 1241), 173
    imgs = torch.from_numpy(np.stack(
        [_smooth_noise_2d(shape, rng, octaves=5, base_period=24) for _ in range(2)]
        + [np.zeros(shape, np.float32)])).to(cuda_device)
    pts, valid = orb._level_corners(imgs[:2], budget, 12.0 / 255.0)
    pts = torch.cat([pts, pts[:1]]).contiguous()
    valid = torch.cat([valid, valid[:1]])
    every = _every(pts)
    before, before_1 = orb_cuda.BATCH_LAUNCHES, orb_cuda.LAUNCHES
    ks, km, _ = orb_cuda.level_describe(imgs, pts, every)
    assert (orb_cuda.BATCH_LAUNCHES, orb_cuda.LAUNCHES) == (before + 1, before_1)
    ps, pm, _ = orb._level_describe_plain(imgs, pts, every)
    torch.cuda.synchronize()
    assert int(valid[:2].sum()) > budget
    assert (ks == ps)[:2][valid[:2]].float().mean().item() >= 0.995
    assert int((ks != ps)[:2][valid[:2]].sum(dim=-1).max()) <= 4
    np.testing.assert_allclose(km.cpu().numpy(), pm.cpu().numpy(), atol=2e-3, rtol=1e-5)
    assert bool((ks[2] == -1.0).all()) and torch.equal(ks[2], ps[2])  # ties
    for b in range(3):
        s1, m1, _ = orb_cuda.level_describe(imgs[b], pts[b], every[b])
        assert torch.equal(s1, ks[b]) and torch.equal(m1, km[b])
    one = orb_cuda.level_describe(imgs[:1], pts[:1], every[:1])  # B = 1
    assert torch.equal(one[0][0], ks[0]) and torch.equal(one[1][0], km[0])


def test_orb_batch_kernel_wrapper_checks_inputs(cuda_device):
    imgs = torch.rand((2, 64, 96), device=cuda_device)
    pts = torch.full((2, 4, 2), 32.0, device=cuda_device)
    valid = _every(pts)
    with pytest.raises(ValueError, match="B, N, 2"):
        orb_cuda.level_describe(imgs, pts[:1], valid[:1])
    with pytest.raises(TypeError, match="float32"):
        orb_cuda.level_describe(imgs.double(), pts, valid)
    with pytest.raises(ValueError, match="contiguous"):
        orb_cuda.level_describe(imgs.transpose(1, 2), pts, valid)
    with pytest.raises(ValueError, match="B, H, W"):  # neither an image nor a stack
        orb_cuda.level_describe(imgs[None], pts[None], valid[None])
    empty = torch.empty((2, 0, 2), device=cuda_device)
    sign, m, words = orb_cuda.level_describe(imgs, empty, _every(empty))
    assert sign.shape == (2, 0, 256) and m.shape == (2, 0, 2) and words.shape == (2, 0, 8)


def test_vocab_train_on_card_equals_cpu(cuda_device):
    """The host-recursive trainer with its dots on the card: the same
    centres and IDF as on the CPU, bit for bit (+-1 dots are exact integers
    in float32; argmax takes the first max on both), and the IDF's descent
    is one K3 launch."""
    rng = np.random.default_rng(17)
    cent = rng.choice(np.array([-1.0, 1.0], np.float32), size=(12, 256))
    X = cent[rng.integers(0, 12, 2000)]
    X = np.where(rng.random(X.shape) < 0.1, -X, X).astype(np.float32)
    docs = rng.integers(0, 40, 2000)
    before = vocab_cuda.LAUNCHES
    on_card = vocab.train(X, k=8, levels=3, doc_ids=docs, device=cuda_device)
    torch.cuda.synchronize()
    assert vocab_cuda.LAUNCHES == before + 1
    on_cpu = vocab.train(X, k=8, levels=3, doc_ids=docs, device="cpu")
    for a, b in zip(on_card.centers, on_cpu.centers, strict=True):
        assert a.device.type == "cuda" and torch.equal(a.cpu(), b)
    assert torch.equal(on_card.idf.cpu(), on_cpu.idf)


@pytest.mark.parametrize("window,walk,iters", [(15, 3, 8), (15, 2, 6), (21, 3, 8)])
def test_polish_kernel_matches_plain_version(cuda_device, window, walk, iters):
    args = [t.to(cuda_device) for t in _setup(window + walk + iters, 200)]
    params = lk.LKParams(window=window, iters=iters, walk_iters=walk)
    kg, kr, kok = lk_cuda.track_level(*args, params)
    pg, pr, pok = lk._track_level(*args, params)
    torch.cuda.synchronize()
    assert torch.equal(kok, pok)
    np.testing.assert_allclose(kg.cpu().numpy(), pg.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(kr.cpu().numpy(), pr.cpu().numpy(), atol=1e-2)
    walk_only = lk_cuda.track_level(*args, params._replace(iters=walk))[0]
    assert float((walk_only - kg).abs().max()) > 1e-3  # the polish steps ran


def _converged_at_border(seed, window, shape=(96, 128)):
    """Reference points whose true match in the current image (the image
    moved by +1 px across the border) lies in [dim - S//2 - 2, dim - S//2 - 1):
    the walk converges there at once and no tile clamps, but the polish
    anchor does, and its clamped sample sits up to 1 px left of (above) the
    match.  Half the points at the right border, half at the bottom."""
    rng = np.random.default_rng(seed)
    H, W = shape
    img = _smooth_noise_2d(shape, rng, octaves=4, base_period=16)
    r = window // 2
    n = 32
    fx = rng.uniform(0.1, 0.9, n)
    x = np.concatenate([W - r - 3 + fx[:16], rng.uniform(30, W - 30, 16)])
    y = np.concatenate([rng.uniform(30, H - 30, 16), H - r - 3 + fx[16:]])
    pts = np.stack([x, y], 1).astype(np.float32)
    shift = np.concatenate([np.tile([1.0, 0.0], (16, 1)), np.tile([0.0, 1.0], (16, 1))])
    cur_r = np.roll(img, 1, axis=1).astype(np.float32)
    cur_b = np.roll(img, 1, axis=0).astype(np.float32)
    return img, cur_r, cur_b, pts, (pts + shift).astype(np.float32)


@pytest.mark.parametrize("window", [15, 21])
def test_polish_kernel_runs_after_a_converged_walk(cuda_device, window):
    img, cur_r, cur_b, pts, match = _converged_at_border(window, window)
    params = lk.LKParams(window=window, iters=8, walk_iters=3)
    for cur, sel in ((cur_r, slice(0, 16)), (cur_b, slice(16, 32))):
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                for a in (img, cur, pts[sel], match[sel])]
        kg, kr, kok = lk_cuda.track_level(*args, params)
        pg, pr, pok = lk._track_level(*args, params)
        torch.cuda.synchronize()
        assert torch.equal(kok, pok) and bool(kok.all())
        np.testing.assert_allclose(kg.cpu().numpy(), pg.cpu().numpy(), atol=5e-3)
        np.testing.assert_allclose(kr.cpu().numpy(), pr.cpu().numpy(), atol=1e-2)
        walk_only = lk_cuda.track_level(*args, params._replace(iters=3))[0]
        assert float((walk_only - args[3]).abs().max()) < 1e-3  # the walk converged
        assert float((kg - walk_only).abs().max(1).values.mean()) > 0.05  # polish moved them


@pytest.mark.parametrize("window", [15, 21])
def test_polish_kernel_border_points_read_inside_the_image(cuda_device, window):
    """test_kernel_border_points_read_inside_the_image with freeze-polish."""
    rng = np.random.default_rng(window + 1)
    H, W = 96, 128
    img = torch.from_numpy(_smooth_noise_2d((H, W), rng, octaves=4, base_period=16))
    d = rng.uniform(0.0, window, 64)
    x = np.concatenate([d[:16], W - 1 - d[16:32], rng.uniform(0, W - 1, 32)])
    y = np.concatenate([rng.uniform(0, H - 1, 32), d[32:48], H - 1 - d[48:]])
    pts = torch.from_numpy(np.stack([x, y], 1).astype(np.float32)).to(cuda_device)
    pad = window + 4
    guarded = torch.full(((H + 2 * pad) * W,), float("nan"), device=cuda_device)
    inner = guarded[pad * W:(pad + H) * W].view(H, W)
    inner.copy_(img)
    params = lk.LKParams(window=window, iters=8, walk_iters=3)
    kg, kr, kok = lk_cuda.track_level(inner, inner, pts, pts.clone(), params)
    torch.cuda.synchronize()
    assert torch.isfinite(kg).all() and torch.isfinite(kr).all()
    assert float((kg - pts).abs().max()) < window


def test_polish_batch_kernel_matches_plain_version(cuda_device):
    args = [t.to(cuda_device) for t in _lanes((4, 5, 6), 200)]
    params = lk.LKParams(window=15, iters=8, walk_iters=3)
    kg, kr, kok = lk_cuda.track_level_batch(*args, params)
    pg, pr, pok = lk_cuda.track_level_batch_plain(*args, params)
    torch.cuda.synchronize()
    assert torch.equal(kok, pok)
    np.testing.assert_allclose(kg.cpu().numpy(), pg.cpu().numpy(), atol=5e-3)
    np.testing.assert_allclose(kr.cpu().numpy(), pr.cpu().numpy(), atol=1e-2)
    for b in range(3):  # each lane: the single-lane entry point, bitwise
        sg, sr, sok = lk_cuda.track_level(*(t[b] for t in args), params)
        assert torch.equal(sg, kg[b]) and torch.equal(sr, kr[b]) and torch.equal(sok, kok[b])


def test_points_sharded_odometry_on_one_rank_is_single_bitwise(cuda_device):
    import torch.distributed as dist

    from ros_stereo_slam_tpu_torch.config import preset_distributed
    from ros_stereo_slam_tpu_torch.data.synthetic import small_world
    from ros_stereo_slam_tpu_torch.parallel import dryrun
    from ros_stereo_slam_tpu_torch.parallel.mesh import mesh_from_config

    world = small_world(n_frames=2, seed=11, scale=1)
    cfg = preset_distributed(1).replace(camera=world.camera)
    (l0, r0, _), (l1, _, _) = world.render(0), world.render(1)
    inputs = dryrun.odometry_inputs(cfg, l0, r0, l1, cuda_device)
    assert inputs[2].pts2d.shape == (768, 2) and l0.shape == (376, 1241)
    torch.cuda.set_device(cuda_device)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0, world_size=1,
                            device_id=cuda_device)
    try:
        mesh = mesh_from_config(cfg.parallel, cuda_device)
        before = lk_cuda.LAUNCHES
        sharded = dryrun.run_odometry(mesh, cfg, inputs)
        torch.cuda.synchronize()
        launched = lk_cuda.LAUNCHES - before
    finally:
        dist.destroy_process_group()
    single = dryrun.run_odometry(None, cfg, inputs)
    assert launched > 0
    assert int(single.n_inliers) > 100
    for a, b in zip(sharded, single, strict=True):
        assert torch.equal(a, b)


def test_endurance_scan_posture_with_cut_capacities(cuda_device):
    """The endurance CLI's scan posture on the card at reduced depth: a
    160-pose lap of radius 20 m (0.785 m a frame) at 1241x376, tiled to
    400 frames, its own k = 9, L = 6 vocabulary, 64 keyframe slots and a
    320-frame database (both rings wrap; the database spans two laps, so
    the rows it overwrites are overwritten by identical frames and F6
    cannot change a verdict: phase endurance of chip_smoke.py shows F6)."""
    import dataclasses

    from ros_stereo_slam_tpu_torch.config import KeyframeConfig
    from ros_stereo_slam_tpu_torch.tools import endurance_run as er

    frames, lap = 400, 160
    left, right, gt, lap_left = er.render_frames(frames, lap, 20.0)
    assert left.shape == (frames, 376, 1241) and left.dtype == np.uint8
    cfg = er.loop_config(1, 2 * lap).replace(
        keyframes=dataclasses.replace(KeyframeConfig(), max_keyframes=64))
    voc = er.train_vocab(lap_left, cfg, cuda_device)
    sc = er.run_postures(cfg, voc, left, right, gt, cuda_device, lap)["scan"]
    ring = er.bow_ring(frames, cfg)
    assert ring["bow_rows_overwritten"] > 0 and sc["keyframes_inserted"] > 64
    assert len(sc["loop_events"]) >= 3
    assert sc["true_revisit_max_offset"] <= 3
    assert sc["ate_rmse_m"] < sc["ate_rmse_odometry_m"]
    assert sc["tracking_ok_fraction"] == 1.0
    assert sc["launches"]["k1"] > 0 and sc["launches"]["k2"] > 0
    assert sc["launches"]["k3"] == ring["bow_inserts"]


def _pnp_scene(lanes: int, draw: int, dev, n: int = 768):
    """`lanes` scenes of `n` points seen from a random pose, with pixel
    noise, 20 % gross outliers and 10 % masked points; a nearby prior."""
    from ros_stereo_slam_tpu_torch.utils import lie

    rng = np.random.default_rng(1000 * lanes + draw)
    X = np.stack([rng.uniform(-15, 15, (lanes, n)), rng.uniform(-3, 3, (lanes, n)),
                  rng.uniform(5, 60, (lanes, n))], -1)
    xi = np.concatenate([rng.normal(scale=0.3, size=(lanes, 3)),
                         rng.normal(scale=0.02, size=(lanes, 3))], -1)
    T = lie.exp_se3(torch.from_numpy(xi)).numpy()
    pc = np.einsum("bij,bnj->bni", T[:, :3, :3], X) + T[:, None, :3, 3]
    uv = np.stack([718.856 * pc[..., 0] / pc[..., 2] + 607.1928,
                   718.856 * pc[..., 1] / pc[..., 2] + 185.2157], -1)
    uv += rng.normal(scale=0.3, size=uv.shape)
    bad = rng.random((lanes, n)) < 0.2
    uv[bad] += rng.uniform(15, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    prior = lie.exp_se3(torch.from_numpy(xi + 0.01)).float()
    return (torch.from_numpy(X).float().to(dev), torch.from_numpy(uv).float().to(dev),
            torch.from_numpy(rng.random((lanes, n)) > 0.1).to(dev), prior.to(dev))


def _pnp_sets(mask, prior: bool, seed: int, K: int = 128, K2: int = 32):
    from ros_stereo_slam_tpu_torch.ops.ransac import _sample_minimal_sets

    gens = [torch.Generator(device=mask.device).manual_seed(seed + b)
            for b in range(mask.shape[0])]
    idx = torch.stack([_sample_minimal_sets(g, m, K, 6) for g, m in zip(gens, mask)])
    idx2 = (torch.stack([_sample_minimal_sets(g, m, K2, 8) for g, m in zip(gens, mask)])
            if prior else None)
    return idx, idx2


def _assert_bitwise(got, want):
    for name, a, b in zip(want._fields, got, want, strict=True):
        diff = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
        assert torch.equal(a, b), f"{name}: largest difference {diff}"


_PNP_KW = dict(thresh_px=1.0, refine_iters=4, retry_thresh_px=8.0, min_inliers=15,
               huber_px=0.5)


@pytest.mark.parametrize("case", ["one_lane", "two_lanes", "starved_retry", "no_prior"])
def test_pnp_graph_replays_the_eager_solve_bitwise(cuda_device, monkeypatch, case):
    from ros_stereo_slam_tpu_torch.ops import pnp
    from ros_stereo_slam_tpu_torch.utils.camera import kitti_default

    monkeypatch.setattr(cuda_graph.PNP, "graphs", {})
    lanes = 2 if case == "two_lanes" else 1
    prior = case != "no_prior"
    kw = dict(_PNP_KW, **({"thresh_px": 0.02, "min_inliers": 600}
                          if case == "starved_retry" else {}))
    cam = kitti_default()
    captures, replays = cuda_graph.PNP.captures, cuda_graph.PNP.replays
    for draw in range(16):
        X, uv, mask, T_prior = _pnp_scene(lanes, draw, cuda_device)
        idx, idx2 = _pnp_sets(mask, prior, draw)
        T_init = T_prior if prior else None
        got = pnp._solve(idx, idx2, cam, X, uv, mask, T_init=T_init, **kw)
        want = pnp._pnp_from_sets(idx, idx2, cam, X, uv, mask, T_init=T_init, **kw)
        torch.cuda.synchronize()
        _assert_bitwise(got, want)
        if case == "starved_retry":
            assert bool(got.used_retry.all())
        elif prior:  # the DLT family alone may starve at 1 px on some draws
            assert not bool(got.used_retry.any())
        assert int(got.n_inliers.min()) > 400
    assert cuda_graph.PNP.captures == captures + 1 and len(cuda_graph.PNP.graphs) == 1
    assert cuda_graph.PNP.replays == replays + 16


def test_pnp_graph_first_result_survives_a_second_replay(cuda_device, monkeypatch):
    """The rescue's case: a second solve of the same signature replays the
    same graph while the first result is still held."""
    from ros_stereo_slam_tpu_torch.ops import pnp
    from ros_stereo_slam_tpu_torch.utils.camera import kitti_default

    monkeypatch.setattr(cuda_graph.PNP, "graphs", {})
    cam = kitti_default()
    inputs = []
    for draw in (0, 1):
        X, uv, mask, T_prior = _pnp_scene(1, draw, cuda_device)
        inputs.append((*_pnp_sets(mask, True, draw), cam, X, uv, mask))
    first = pnp._solve(*inputs[0], T_init=T_prior, **_PNP_KW)
    kept = tuple(t.clone() for t in first)
    second = pnp._solve(*inputs[1], T_init=T_prior, **_PNP_KW)
    torch.cuda.synchronize()
    assert len(cuda_graph.PNP.graphs) == 1
    assert not torch.equal(first.T_cw, second.T_cw)
    for a, b in zip(first, kept, strict=True):
        assert torch.equal(a, b)
    _assert_bitwise(first, pnp._pnp_from_sets(*inputs[0], T_init=T_prior, **_PNP_KW))


def test_pnp_single_lane_loop_edge_replays_the_eager_lane_form_bitwise(cuda_device,
                                                                      monkeypatch):
    """The loop edge's solve (``slam_scan._edges_pnp_batch``: one lane, N =
    512, K = 128, K2 = 32, the identity prior, no retry ladder) replays
    PnP's graph, bitwise the eager solve of its sets as one lane."""
    from ros_stereo_slam_tpu_torch.ops import pnp
    from ros_stereo_slam_tpu_torch.utils.camera import kitti_default

    monkeypatch.setattr(cuda_graph.PNP, "graphs", {})
    cam, eye = kitti_default(), torch.eye(4, device=cuda_device)
    kw = dict(thresh_px=2.0, refine_iters=4)
    captures, replays = cuda_graph.PNP.captures, cuda_graph.PNP.replays
    for draw in range(8):
        X, uv, mask, _ = _pnp_scene(1, draw, cuda_device, n=512)
        idx, idx2 = _pnp_sets(mask, True, draw)
        got = pnp._solve(idx[0], idx2[0], cam, X[0], uv[0], mask[0], T_init=eye, **kw)
        want = pnp._pnp_from_sets(idx, idx2, cam, X, uv, mask, T_init=eye[None], **kw)
        torch.cuda.synchronize()
        assert got.T_cw.shape == (4, 4) and got.inliers.shape == (512,)
        _assert_bitwise(got, pnp.PnPResult(*(t[0] for t in want)))
        assert int(got.n_inliers) > 250
    assert cuda_graph.PNP.captures == captures + 1 and len(cuda_graph.PNP.graphs) == 1
    assert cuda_graph.PNP.replays == replays + 8


def test_run_offline_corridor_graph_equals_eager(cuda_device, monkeypatch):
    """The benchmark's 97-frame corridor (odo.corridor.offline's mix and
    configuration) through ``run_offline``: the same poses, inlier counts
    and retry flags with PnP replayed from its graph as with every solve
    eager; every step PnP call replays (frames 1.. and each rescue)."""
    from pathlib import Path

    from ros_stereo_slam_tpu_torch.models import pipeline, step
    from slambench import drivers, manifest, world

    man = manifest.Manifest(Path(__file__).resolve().parents[1])
    cell = man.cell("odo.corridor.offline")
    conf, mix = man.config(cell["config"]), man.traffic(cell["traffic"])
    seeds = world.draw(6400000017)
    frames = world.make_frames(mix["world"], conf["camera"], cuda_device, seeds)
    left, right = frames.left.cpu().numpy(), frames.right.cpu().numpy()
    assert left.shape == (97, 376, 1241)
    cfg = drivers.pipeline_config(conf, mix["overrides"], seeds["program"])
    fam = cuda_graph.PNP
    replays, rescues = fam.replays, step.RESCUES
    graph = pipeline.run_offline(cfg, left, right, device=cuda_device)
    n_calls = len(left) - 1 + step.RESCUES - rescues
    assert fam.replays - replays == n_calls
    monkeypatch.setattr(fam, "replays_on", lambda device, mesh: False)
    eager_before = fam.eager
    eager = pipeline.run_offline(cfg, left, right, device=cuda_device)
    assert fam.eager - eager_before == n_calls
    for name in ("trajectory", "n_inliers", "tracking_ok", "used_retry", "is_keyframe"):
        a, b = getattr(graph, name), getattr(eager, name)
        assert np.array_equal(a, b), (name, float(np.abs(a.astype(np.float64)
                                                         - b.astype(np.float64)).max()))
    assert graph.tracking_ok.all()


def _ba_window(case: str, seed: int, dev):
    """A BA window on `dev` and the solve's keywords.  "corridor": the
    cell's shapes (9 poses 0.8 m apart along z, the first two fixed, 768
    landmarks 5-60 m ahead, 0.3 px of noise, a tenth unobserved in each
    view), poses and landmarks perturbed; "rms_grows": the undamped step
    of tests/test_torch_ba.py's diverging case (a free pose turned 1 rad
    away, no Huber, one step), which raises the RMS on some draws, so the
    input is kept;
    "degenerate": the corridor window with one non-finite observation,
    which makes the reduced system and the RMS non-finite, so the
    factorisation fails and the input is kept."""
    from ros_stereo_slam_tpu_torch.utils import lie
    from ros_stereo_slam_tpu_torch.utils.camera import Pinhole

    rng = np.random.default_rng(seed)
    cam = Pinhole(707.0912, 707.0912, 601.8873, 183.1104)
    W, N = (3, 12) if case == "rms_grows" else (9, 768)
    X = np.stack([rng.uniform(-6, 6, N), rng.uniform(-3, 3, N), rng.uniform(5, 14, N)], 1)
    if case != "rms_grows":
        X = np.stack([rng.uniform(-20, 20, N), rng.uniform(-3, 3, N), rng.uniform(10, 60, N)],
                     1)
    T = np.tile(np.eye(4), (W, 1, 1))
    T[:, 2, 3] = -0.8 * np.arange(W)
    T[:, 0, 3] = -1.5 * np.arange(W) if case == "rms_grows" else 0.0
    p = np.einsum("wij,nj->wni", T[:, :3, :3], X) + T[:, None, :3, 3]
    obs = p[..., :2] / p[..., 2:] * cam.fx + [cam.cx, cam.cy] + rng.normal(0, 0.3, (W, N, 2))
    mask = rng.random((W, N)) > (0.0 if case == "rms_grows" else 0.1)
    fixed = np.arange(W) < 2
    kw = dict(iters=10, damping=1e-4, huber_px=2.0)
    if case == "rms_grows":
        T[2] = lie.exp_se3(torch.tensor([0.0, 0.0, 0.0, 0.0, 1.0, 0.0],
                                        dtype=torch.float64)).numpy() @ T[2]
        kw = dict(iters=1, damping=0.0, huber_px=1e9)
    else:
        xi = np.concatenate([rng.normal(0, 0.05, (W, 3)), rng.normal(0, 0.005, (W, 3))], 1)
        xi[fixed] = 0.0
        T = lie.exp_se3(torch.from_numpy(xi)).numpy() @ T
        X = X + rng.normal(0, 0.2, X.shape)
    if case == "degenerate":
        obs[3, 5, 0], mask[3, 5] = np.nan, True
    f32 = dict(dtype=torch.float32, device=dev)
    return (cam, torch.tensor(T, **f32), torch.tensor(X, **f32), torch.tensor(obs, **f32),
            torch.tensor(mask, device=dev), torch.tensor(fixed, device=dev)), kw


def _assert_same_bits(got, want):
    """Every output bit for bit (NaN included: the kept input of a
    degenerate window may hold one)."""
    for name, a, b in zip(want._fields, got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        assert torch.equal(a.view(ints), b.view(ints)), name


@pytest.mark.parametrize("case", ["corridor", "rms_grows", "degenerate"])
def test_ba_graph_replays_the_eager_solve_bitwise(cuda_device, monkeypatch, case):
    """``ba_solve`` on the card replays one graph per window signature,
    bitwise the eager solve, over 6 windows of each case; the diverging
    and the degenerate windows keep their input, and the degenerate one's
    factorisation fails in the eager solve."""
    from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba

    monkeypatch.setattr(cuda_graph.BA, "graphs", {})
    infos = []
    factor = torch.linalg.cholesky_ex

    def recording(S):
        L, info = factor(S)
        infos.append((info != 0) | ~torch.isfinite(L).all())
        return L, info

    captures, replays = cuda_graph.BA.captures, cuda_graph.BA.replays
    # the diverging case's draws whose undamped step raises the RMS (on
    # other draws the step lowers it, and the window is refined)
    for seed in (0, 1, 2, 3, 8, 14) if case == "rms_grows" else range(6):
        args, kw = _ba_window(case, seed, cuda_device)
        got = ba.ba_solve(*args, **kw)
        with monkeypatch.context() as mp:
            mp.setattr(torch.linalg, "cholesky_ex", recording)
            want = ba._solve(*args, **kw)
        torch.cuda.synchronize()
        _assert_same_bits(got, want)
        kept = torch.equal(got.T_cw, args[1])
        if case == "corridor":
            assert not kept and float(got.rms_after) < float(got.rms_before)
        else:
            assert kept and torch.equal(got.landmarks, args[2])
        if case == "rms_grows":
            assert float(got.rms_after) == float(got.rms_before) > 100.0
        if case == "degenerate":
            assert bool(torch.stack(infos).all())
        infos.clear()
    assert cuda_graph.BA.captures == captures + 1 and len(cuda_graph.BA.graphs) == 1
    assert cuda_graph.BA.replays == replays + 6


def test_ba_graph_repeats_bitwise(cuda_device, monkeypatch):
    """Two replays of one window give the same bits (no atomics, H10)."""
    from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba

    monkeypatch.setattr(cuda_graph.BA, "graphs", {})
    args, kw = _ba_window("corridor", 7, cuda_device)
    first = ba.ba_solve(*args, **kw)
    second = ba.ba_solve(*args, **kw)
    torch.cuda.synchronize()
    assert len(cuda_graph.BA.graphs) == 1
    _assert_same_bits(first, second)


def test_ba_graph_first_lane_survives_the_second_lanes_replay(cuda_device, monkeypatch):
    """``_ba_refine``'s case: lane 1's solve replays the graph of lane 0's
    while lane 0's result is still held."""
    from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba

    monkeypatch.setattr(cuda_graph.BA, "graphs", {})
    (args0, kw), (args1, _) = (_ba_window("corridor", s, cuda_device) for s in (8, 9))
    first = ba.ba_solve(*args0, **kw)
    kept = tuple(t.clone() for t in first)
    second = ba.ba_solve(*args1, **kw)
    torch.cuda.synchronize()
    assert len(cuda_graph.BA.graphs) == 1
    assert not torch.equal(first.T_cw, second.T_cw)
    for a, b in zip(first, kept, strict=True):
        assert torch.equal(a, b)
    _assert_same_bits(first, ba._solve(*args0, **kw))


def test_run_offline_ba_graph_equals_eager(cuda_device, monkeypatch):
    """The benchmark's BA cell (``ba.corridor.offline``: ``kitti08_ba``
    over the 97-frame corridor) through ``run_offline``: the same poses,
    inliers, keyframes and BA RMS with ``ba_solve`` replayed from its graph
    as with every solve eager; one capture, then every solve replays."""
    from pathlib import Path

    from ros_stereo_slam_tpu_torch.models import bundle_adjust as ba
    from ros_stereo_slam_tpu_torch.models import pipeline
    from slambench import drivers, manifest, world

    monkeypatch.setattr(cuda_graph.BA, "graphs", {})
    man = manifest.Manifest(Path(__file__).resolve().parents[1])
    cell = man.cell("ba.corridor.offline")
    conf, mix = man.config(cell["config"]), man.traffic(cell["traffic"])
    seeds = world.draw(6400000023)
    frames = world.make_frames(mix["world"], conf["camera"], cuda_device, seeds)
    left, right = frames.left.cpu().numpy(), frames.right.cpu().numpy()
    assert left.shape == (97, 370, 1226)
    cfg = drivers.pipeline_config(conf, mix["overrides"], seeds["program"])
    assert cfg.ba_enabled
    fam = cuda_graph.BA
    solves, captures, replays = ba.SOLVES, fam.captures, fam.replays
    graph = pipeline.run_offline(cfg, left, right, device=cuda_device)
    n_solves = ba.SOLVES - solves
    assert n_solves == len(left) - 1
    assert fam.captures - captures == 1 and fam.replays - replays == n_solves
    monkeypatch.setattr(fam, "replays_on", lambda device, mesh: False)
    eager_before = fam.eager
    eager = pipeline.run_offline(cfg, left, right, device=cuda_device)
    assert fam.eager - eager_before == n_solves
    for name in ("trajectory", "n_inliers", "tracking_ok", "used_retry", "is_keyframe",
                 "ba_rms"):
        a, b = getattr(graph, name), getattr(eager, name)
        assert np.array_equal(a, b), (name, float(np.abs(a.astype(np.float64)
                                                         - b.astype(np.float64)).max()))
    assert graph.tracking_ok.all()


def _orb_frame(seed: int, lanes: int = 0, shape=(376, 1241)) -> torch.Tensor:
    """A full-size frame of smooth noise, or a (lanes, H, W) stack of them."""
    rng = np.random.default_rng(seed)
    imgs = [_smooth_noise_2d(shape, rng, octaves=5, base_period=24)
            for _ in range(max(lanes, 1))]
    return torch.from_numpy(np.stack(imgs) if lanes else imgs[0]).float()


# case -> (n_features, n_levels, lanes): the SLAM cell's detection, the ORB
# frontend's one level at max_points, a 2-lane stack, and a blank frame
_ORB_CASES = {"four_levels": (512, 4, 0), "one_level": (768, 1, 0), "two_lanes": (512, 4, 2),
              "blank": (512, 4, 0)}


def _orb_eager(monkeypatch, img, n_features, n_levels):
    with monkeypatch.context() as mp:
        mp.setattr(cuda_graph.ORB, "replays_on", lambda device, mesh: False)
        return orb.detect_and_compute(img, n_features, 12.0 / 255.0, n_levels=n_levels)


@pytest.mark.parametrize("case", list(_ORB_CASES))
def test_orb_graph_replays_the_eager_stage_bitwise(cuda_device, monkeypatch, case):
    """``detect_and_compute`` replays its corner stage from one graph per
    signature, bitwise the eager call on every field; K2 launches once a
    level on the replay's outputs (the batched count for a stack)."""
    monkeypatch.setattr(cuda_graph.ORB, "graphs", {})
    n_features, n_levels, lanes = _ORB_CASES[case]
    fam = cuda_graph.ORB
    captures, replays = fam.captures, fam.replays
    for draw in range(3):
        img = _orb_frame(draw, lanes).to(cuda_device)
        if case == "blank":
            img = torch.zeros_like(img)
        launches = (orb_cuda.LAUNCHES, orb_cuda.BATCH_LAUNCHES)
        got = orb.detect_and_compute(img, n_features, 12.0 / 255.0, n_levels=n_levels)
        assert (orb_cuda.LAUNCHES - launches[0], orb_cuda.BATCH_LAUNCHES - launches[1]) == (
            (0, n_levels) if lanes else (n_levels, 0))
        want = _orb_eager(monkeypatch, img, n_features, n_levels)
        torch.cuda.synchronize()
        _assert_bitwise(got, want)
        assert got.pts.shape == img.shape[:-2] + (n_features, 2)
        counts = got.valid.sum(-1).reshape(-1).tolist()
        if case == "blank":
            assert counts == [0]
        else:
            assert min(counts) > n_features // 2, counts
    assert fam.captures == captures + 1 and len(fam.graphs) == 1
    assert fam.replays == replays + 3


def test_orb_graph_first_result_survives_a_second_replay(cuda_device, monkeypatch):
    """A second frame through the same graph gives its own eager result,
    and the first frame's result keeps its values after that replay."""
    monkeypatch.setattr(cuda_graph.ORB, "graphs", {})
    a, b = (_orb_frame(seed).to(cuda_device) for seed in (11, 12))
    first = orb.detect_and_compute(a, 512, 12.0 / 255.0, n_levels=4)
    kept = tuple(t.clone() for t in first)
    second = orb.detect_and_compute(b, 512, 12.0 / 255.0, n_levels=4)
    torch.cuda.synchronize()
    assert len(cuda_graph.ORB.graphs) == 1
    assert not torch.equal(first.pts, second.pts)
    for x, y in zip(first, kept, strict=True):
        assert torch.equal(x, y)
    _assert_bitwise(first, _orb_eager(monkeypatch, a, 512, 4))
    _assert_bitwise(second, _orb_eager(monkeypatch, b, 512, 4))
