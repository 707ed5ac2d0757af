"""FAST, ANMS and ORB of the port against the JAX package (jnp route).

Same seeded numpy images go through both packages on the CPU.  Bounds:

- FAST scores, the exact top corners and ANMS are bitwise equal: the
  port sums the ring in the reference's order, and its top-k keeps the
  reference's lowest-index-first order among ties (constructed tie cases
  included).
- ORB features: the same points (level 0 exactly; levels > 0 within
  1e-4 px, the f32 rounding of the level-0 mapping), the same validity
  and octaves, and >= 99.5 % of descriptor bits equal on valid features
  (bits flip where the two samples of a pair nearly tie; the resize and
  moment sums round differently, ROADMAP H8).  Measured: every bit and
  point equal on this frame (124 and 187 valid features).
- The descriptors' plain version against the jnp route on given corners:
  moments within 1e-3 + 1e-5 relative, >= 99.5 % bits equal.
- The folded plain version (``_level_describe_plain``: signs zeroed and
  bits packed where a corner is invalid) equals masking and ``pack_bits``
  of ``_descriptors_plain`` exactly, one image or lanes; through
  ``detect_and_compute`` on one level the port still gives the JAX
  package's ``_level_features``: corners and validity equal, >= 99.5 % of
  bits equal, the packed words equal on every row whose bits are, angles
  within 1e-4.
- ``desc_bits``, which the vocabulary descent reads, is exactly
  ``pack_bits(desc_sign > 0)`` on valid rows and zero on invalid rows.
- ORB's graph family (``utils/cuda_graph.py::ORB``) on the CPU: every
  ``detect_and_compute`` runs the corner stage eagerly (``eager`` + 1, no
  capture), the stage gives each level's image and ``_level_corners`` at
  its budget, and the family's key separates the image's shape and
  lanes, ``n_features``, ``n_levels``, ``scale_factor`` and
  ``fast_thresh``; the span report reads the ``detect.orb`` calls beside
  the family's counters.
- Fault F3 of the JAX package (ROADMAP queue 3): the Pallas kernel's tile
  clamp describes a corner 18 px from the left border from a shifted
  patch, so its moments differ from the jnp route's by far more than
  rounding; the port follows the jnp route there.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.data.synthetic import _smooth_noise_2d, small_world
from ros_stereo_slam_tpu.ops import anms as janms
from ros_stereo_slam_tpu.ops import fast as jfast
from ros_stereo_slam_tpu.ops import interp as jinterp
from ros_stereo_slam_tpu.ops import orb as jorb
from ros_stereo_slam_tpu_torch.ops import anms, fast, orb, orb_cuda, topk
from ros_stereo_slam_tpu_torch.utils import cuda_graph


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def images():
    world = small_world(n_frames=2, seed=5)
    frame = world.render(0)[0].astype(np.float32)
    noise = _smooth_noise_2d((160, 256), np.random.default_rng(3), octaves=5,
                             base_period=16)
    return {"frame": frame, "noise": noise}


def test_constants_match_reference():
    np.testing.assert_array_equal(orb._PAT_P, jorb._PAT_P)
    np.testing.assert_array_equal(orb._PAT_Q, jorb._PAT_Q)
    np.testing.assert_array_equal(orb._CENT, jorb._CENT)
    for n_in, n_out in ((376, 301), (1241, 993), (188, 120)):
        np.testing.assert_array_equal(orb._resize_matrix(n_in, n_out),
                                      jorb._resize_matrix(n_in, n_out))


@pytest.mark.parametrize("n,levels", [(512, 4), (128, 4), (64, 8), (40, 5), (32, 1)])
def test_level_budgets_match_reference(n, levels):
    assert orb._level_budgets(n, levels, 1.25) == jorb._level_budgets(n, levels, 1.25)


@pytest.mark.parametrize("name", ["frame", "noise"])
def test_fast_score_and_top_corners_bitwise(images, name):
    img = images[name]
    sj = np.asarray(jfast.fast_score(jnp.asarray(img), 12.0 / 255.0))
    st = fast.fast_score(torch.from_numpy(img), 12.0 / 255.0)
    np.testing.assert_array_equal(st.numpy(), sj)
    pj, vj, mj = jfast.top_corners(jnp.asarray(sj), 400, exact=True)
    pt, vt, mt = fast.top_corners(st, 400)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))


@pytest.mark.parametrize("k", [1, 7, 64])
def test_top_k_tie_order_matches_lax(k):
    """The shared top-k helper: among equal values the lowest index first,
    as lax.top_k (a tie-heavy integer-valued input, sentinels included)."""
    import jax

    rng = np.random.default_rng(k)
    x = rng.integers(0, 5, size=(3, 64)).astype(np.float32)
    x[:, ::9] = -1e9
    vj, ij = jax.lax.top_k(jnp.asarray(x), k)
    vt, it = topk.top_k(torch.from_numpy(x), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_top_corners_ties_take_lowest_index():
    """Equal peaks and a zero plateau: the order is the reference's."""
    score = np.zeros((40, 60), np.float32)
    score[10::6, 8::7] = 0.5  # 30 isolated equal peaks
    score[30, 50] = 0.9
    pj, vj, _ = jfast.top_corners(jnp.asarray(score), 64, exact=True)
    pt, vt, _ = fast.top_corners(torch.from_numpy(score), 64)
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_anms_ties_match_reference():
    """Integer corners on a lattice with equal scores: the squared radii tie
    exactly, and the kept set and its order must be the reference's."""
    rng = np.random.default_rng(0)
    xs, ys = np.meshgrid(np.arange(20, 200, 9), np.arange(20, 120, 7))
    pts = np.stack([xs.ravel(), ys.ravel()], 1).astype(np.float32)
    scores = rng.choice(np.array([0.2, 0.4], np.float32), size=pts.shape[0])
    mask = rng.random(pts.shape[0]) > 0.1
    for keep in (16, 64):
        kj, vj = janms.anms(jnp.asarray(pts), jnp.asarray(scores), jnp.asarray(mask), keep)
        kt, vt = anms.anms(torch.from_numpy(pts), torch.from_numpy(scores),
                           torch.from_numpy(mask), keep)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


@pytest.mark.parametrize("n_features,n_levels", [(128, 4), (200, 1)])
def test_detect_and_compute_matches_jnp_route(images, n_features, n_levels):
    img = images["frame"]
    fj = jorb.detect_and_compute(jnp.asarray(img), n_features, 12.0 / 255.0,
                                 backend="jnp", n_levels=n_levels)
    ft = orb.detect_and_compute(torch.from_numpy(img), n_features, 12.0 / 255.0,
                                n_levels=n_levels)
    valid = np.asarray(fj.valid)
    np.testing.assert_array_equal(ft.valid.numpy(), valid)
    np.testing.assert_array_equal(ft.octave.numpy(), np.asarray(fj.octave))
    np.testing.assert_allclose(ft.pts.numpy(), np.asarray(fj.pts), atol=1e-4)
    assert valid.sum() > n_features // 2
    sj = np.asarray(fj.desc_sign)[valid]
    st = ft.desc_sign.numpy()[valid]
    assert (sj == st).mean() >= 0.995, (sj == st).mean()
    assert not ft.desc_sign.numpy()[~valid].any()  # invalid rows are zero
    # packed bits hold the reference's uint32 patterns
    bj = np.asarray(fj.desc_bits)
    bt = ft.desc_bits.numpy().view(np.uint32)
    same_rows = (sj == st).all(axis=1)
    np.testing.assert_array_equal(bt[valid][same_rows], bj[valid][same_rows])
    assert not bt[~valid].any()
    np.testing.assert_allclose(ft.angle.numpy()[valid][same_rows],
                               np.asarray(fj.angle)[valid][same_rows], atol=1e-4)


def test_descriptors_plain_matches_jnp_route(images):
    img = images["noise"]
    rng = np.random.default_rng(4)
    pts = np.stack([rng.integers(20, 256 - 20, 64), rng.integers(20, 160 - 20, 64)],
                   1).astype(np.float32)
    sign, m = orb._descriptors_plain(torch.from_numpy(img), torch.from_numpy(pts))
    imgj = jnp.asarray(img)
    cent = jnp.asarray(jorb._CENT)
    vals = jinterp.bilinear_at(imgj, (jnp.asarray(pts)[:, None, :] + cent[None])
                               .reshape(-1, 2)).reshape(64, -1)
    m10 = np.asarray(jnp.sum(vals * cent[None, :, 0], axis=1))
    m01 = np.asarray(jnp.sum(vals * cent[None, :, 1], axis=1))
    np.testing.assert_allclose(m.numpy(), np.stack([m10, m01], 1), atol=1e-3, rtol=1e-5)
    # the jnp route's bits, from its own _level_features arithmetic
    ang = np.arctan2(m01, m10)
    ca, sa = np.cos(ang), np.sin(ang)
    rot = jnp.asarray(np.stack([np.stack([ca, -sa], -1), np.stack([sa, ca], -1)], -2))
    rp = jnp.einsum("nij,bj->nbi", rot, jnp.asarray(jorb._PAT_P)) + jnp.asarray(pts)[:, None]
    rq = jnp.einsum("nij,bj->nbi", rot, jnp.asarray(jorb._PAT_Q)) + jnp.asarray(pts)[:, None]
    vp = np.asarray(jinterp.bilinear_at(imgj, rp.reshape(-1, 2))).reshape(64, 256)
    vq = np.asarray(jinterp.bilinear_at(imgj, rq.reshape(-1, 2))).reshape(64, 256)
    ref = np.where(vp < vq, 1.0, -1.0)
    assert (sign.numpy() == ref).mean() >= 0.995


@pytest.mark.parametrize("name,budget", [("frame", 96), ("noise", 64)])
def test_level_describe_plain_folds_the_epilogue(images, name, budget):
    img = torch.from_numpy(images[name])
    pts, valid = orb._level_corners(img, budget, 12.0 / 255.0)
    valid = valid.clone()
    valid[::5] = False  # invalid corners whatever the detector found
    sign, m, packed = orb._level_describe_plain(img, pts, valid)
    s0, m0 = orb._descriptors_plain(img, pts)
    assert torch.equal(sign, s0 * valid[:, None]) and torch.equal(m, m0)
    assert torch.equal(packed, orb.pack_bits((s0 > 0) & valid[:, None]))
    assert not sign[~valid].any() and not packed[~valid].any()
    assert torch.equal(orb.sign_of_packed(packed)[valid], sign[valid])
    # the wrapper on CPU tensors takes this plain version, launching nothing
    before = (orb_cuda.LAUNCHES, orb_cuda.BATCH_LAUNCHES)
    for x, y in zip(orb_cuda.level_describe(img, pts, valid), (sign, m, packed)):
        assert torch.equal(x, y)
    # lanes: lane b is the single-image result
    img2 = torch.stack([img, img.flip(1).contiguous()])
    pts2 = torch.stack([pts, pts])
    valid2 = torch.stack([valid, ~valid])
    lanes = orb_cuda.level_describe(img2, pts2, valid2)
    assert (orb_cuda.LAUNCHES, orb_cuda.BATCH_LAUNCHES) == before
    for b in range(2):
        for x, y in zip(lanes, orb._level_describe_plain(img2[b], pts2[b], valid2[b])):
            assert torch.equal(x[b], y)


@pytest.mark.parametrize("name,budget", [("frame", 96), ("noise", 64)])
def test_level_features_matches_jnp_route(images, name, budget):
    img = images[name]
    pj, aj, bj, sj, vj = (np.asarray(a) for a in jorb._level_features(
        jnp.asarray(img), budget, 12.0 / 255.0, "jnp"))
    ft = orb.detect_and_compute(torch.from_numpy(img), budget, 12.0 / 255.0)
    pt, at, bt, st, vt = (a.numpy() for a in (ft.pts, ft.angle, ft.desc_bits, ft.desc_sign,
                                              ft.valid))
    np.testing.assert_array_equal(pt, pj)
    np.testing.assert_array_equal(vt, vj)
    assert vj.sum() > budget // 2
    assert (st[vj] == sj[vj]).mean() >= 0.995
    assert not st[~vj].any() and not bt[~vj].any()
    same_rows = (st == sj).all(axis=1)
    np.testing.assert_array_equal(bt.view(np.uint32)[same_rows], bj[same_rows])
    np.testing.assert_allclose(at[vj & same_rows], aj[vj & same_rows], atol=1e-4)


@pytest.mark.parametrize("name,n_features", [("frame", 128), ("noise", 96)])
def test_desc_bits_are_the_packed_signs(images, name, n_features):
    """What the vocabulary descent reads: ``desc_bits`` is ``pack_bits(desc_sign
    > 0)`` on valid rows and 0 on invalid ones, so descending the words with
    ``valid`` gives the words of the sign rows (plain route, CPU)."""
    ft = orb.detect_and_compute(torch.from_numpy(images[name]), n_features, 12.0 / 255.0,
                                n_levels=4)
    v = ft.valid
    assert 0 < int(v.sum()) < v.numel()  # both kinds of rows
    assert torch.equal(ft.desc_bits[v], orb.pack_bits(ft.desc_sign[v] > 0))
    assert not ft.desc_bits[~v].any() and not ft.desc_sign[~v].any()
    assert bool(((ft.desc_sign[v] == 1) | (ft.desc_sign[v] == -1)).all())


def test_pack_unpack_and_hamming_match_reference():
    rng = np.random.default_rng(9)
    bits = rng.random((12, 256)) > 0.5
    pj = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    pt = orb.pack_bits(torch.from_numpy(bits))
    np.testing.assert_array_equal(pt.numpy().view(np.uint32), pj)
    np.testing.assert_array_equal(orb.unpack_bits(pt).numpy(), bits)
    np.testing.assert_array_equal(orb.sign_of_packed(pt).numpy(),
                                  np.asarray(jorb.sign_of_packed(jnp.asarray(pj))))
    sa, sb = orb.sign_of_packed(pt[:5]), orb.sign_of_packed(pt[5:])
    np.testing.assert_array_equal(
        orb.hamming_mxu(sa, sb).numpy(),
        np.asarray(jorb.hamming_packed(jnp.asarray(pj[:5]), jnp.asarray(pj[5:]))))


def test_f3_pallas_tile_clamp_shifts_border_corners(images):
    """Fault F3: orb_pallas clamps the 44x44 tile into the image but keeps
    the patch centre at 21, so a corner 18 px from the left border (valid:
    the margin is 17) is described from a patch shifted by 3 px.  Its
    moments differ from the jnp route's; a corner away from the border
    agrees.  The port's plain version follows the jnp route."""
    from ros_stereo_slam_tpu.ops import orb_pallas

    img = images["noise"]
    pts = np.array([[18.0, 60.0], [100.0, 60.0]], np.float32)
    _, m_pallas = orb_pallas.orb_descriptors(jnp.asarray(img), jnp.asarray(pts),
                                             select_dtype="f32", interpret=True)
    m_pallas = np.asarray(m_pallas)
    _, m_port = orb._descriptors_plain(torch.from_numpy(img), torch.from_numpy(pts))
    cent = jnp.asarray(jorb._CENT)
    vals = jinterp.bilinear_at(jnp.asarray(img), (jnp.asarray(pts)[:, None, :] + cent[None])
                               .reshape(-1, 2)).reshape(2, -1)
    m_jnp = np.stack([np.asarray(jnp.sum(vals * cent[None, :, 0], 1)),
                      np.asarray(jnp.sum(vals * cent[None, :, 1], 1))], 1)
    # away from the border the kernel agrees with the jnp route...
    np.testing.assert_allclose(m_pallas[1], m_jnp[1], atol=1e-2)
    # ... at x = 18 it does not (a shifted patch, not rounding)
    assert np.abs(m_pallas[0] - m_jnp[0]).max() > 10.0, (m_pallas[0], m_jnp[0])
    np.testing.assert_allclose(m_port.numpy(), m_jnp, atol=1e-3, rtol=1e-5)


def test_hamming_packed_matches_reference():
    """Exact Hamming distances of packed sets, as the JAX package's
    popcount form; and equal to the sign-vector form."""
    rng = np.random.default_rng(19)
    bits = rng.random((23, 256)) > 0.5
    bits[3] = bits[20]  # a zero distance
    bits[4] = ~bits[21]  # the full 256
    pj = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    pt = orb.pack_bits(torch.from_numpy(bits))
    ht = orb.hamming_packed(pt[:12], pt[12:])
    assert ht.dtype == torch.int32
    np.testing.assert_array_equal(
        ht.numpy(), np.asarray(jorb.hamming_packed(jnp.asarray(pj[:12]), jnp.asarray(pj[12:]))))
    np.testing.assert_array_equal(
        ht.numpy(), orb.hamming_mxu(orb.sign_of_packed(pt[:12]),
                                    orb.sign_of_packed(pt[12:])).numpy().astype(np.int32))
    assert int(ht[3, 8]) == 0 and int(ht[4, 9]) == 256


@pytest.mark.parametrize("n_features,n_levels,lanes", [(128, 4, 0), (96, 1, 0), (128, 4, 2)])
def test_orb_family_runs_the_corner_stage_eagerly_on_the_cpu(images, n_features, n_levels,
                                                             lanes):
    """On the CPU the corner stage runs eagerly through ORB's family, one
    eager call a ``detect_and_compute``, no capture; the stage gives the
    pyramid's levels 1.. and each level's ``_level_corners`` at its
    budget, and the features' level-0 rows are level 0's corners."""
    img = torch.from_numpy(images["frame"])
    if lanes:
        img = torch.stack([img, img.flip(-1)])
    fam = cuda_graph.ORB
    before = fam.eager
    f = orb.detect_and_compute(img, n_features, 12.0 / 255.0, n_levels=n_levels)
    assert fam.eager == before + 1
    assert fam.captures == 0 and fam.replays == 0 and not fam.graphs
    stage = orb._corner_stage(img, n_features, n_levels, 1.25, 12.0 / 255.0)
    levels = orb.level_images(img, n_levels, 1.25)
    budgets = orb._level_budgets(n_features, n_levels, 1.25) if n_levels > 1 else [n_features]
    assert len(stage.images) == n_levels - 1 and len(stage.pts) == len(stage.valid) == n_levels
    for l, (lvl, budget) in enumerate(zip(levels, budgets)):
        if l:
            assert torch.equal(stage.images[l - 1], lvl)
        pts, valid = orb._level_corners(lvl, budget, 12.0 / 255.0)
        assert pts.shape == img.shape[:-2] + (budget, 2)
        assert torch.equal(stage.pts[l], pts) and torch.equal(stage.valid[l], valid)
    assert f.pts.shape == img.shape[:-2] + (n_features, 2)
    assert torch.equal(f.pts[..., :budgets[0], :], stage.pts[0])
    assert torch.equal(f.valid[..., :budgets[0]], stage.valid[0])


def _orb_key(monkeypatch, shape=(96, 128), lanes=0, **kw):
    """The key of ORB's family for the arguments ``detect_and_compute``
    gives it."""
    seen = []

    def family(fn, mesh=None, **args):
        seen.append(cuda_graph.GraphFamily.key(args))
        return fn(**args)

    monkeypatch.setattr(cuda_graph, "ORB", family)
    img = torch.zeros(((lanes,) if lanes else ()) + shape)
    orb.detect_and_compute(img, **{"n_features": 64, "n_levels": 4, **kw})
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("change", [
    {}, {"shape": (96, 127)}, {"shape": (95, 128)}, {"lanes": 1}, {"lanes": 2},
    {"n_levels": 1}, {"n_levels": 3}, {"fast_thresh": 20.0 / 255.0}, {"n_features": 96},
    {"scale_factor": 1.2},
])
def test_orb_graph_key_separates_shape_lanes_levels_and_threshold(monkeypatch, change):
    """Equal arguments (a fresh image of the same signature) share one key;
    another image shape, lane count, or ORB parameter gives another."""
    assert (_orb_key(monkeypatch, **change) == _orb_key(monkeypatch)) == (not change)


def test_span_report_reads_the_orb_family_beside_detect_orb():
    """The span tool's reader of the graph families: ORB's calls in the
    session, replays among them and the ``detect.orb`` spans."""
    path = Path(__file__).resolve().parents[1] / "tools" / "torch_span_report.py"
    spec = importlib.util.spec_from_file_location("torch_span_report", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rows = {"detect.orb": {"calls": 129}, "step.pnp": {"calls": 257}}
    before = {"orb": {"captures": 2, "replays": 81, "eager": 0}}
    after = {"orb": {"captures": 2, "replays": 210, "eager": 0}}
    assert tool.graph_solves(before, after, rows) == {
        "orb": {"solves": 129, "detect_orb_calls": 129, "captures_before_session": 2,
                "captures_session": 0, "replays": 129, "eager_solves": 0,
                "replayed_share": 1.0}}
