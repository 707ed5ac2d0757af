"""Port parity: PnP-RANSAC, triangulation, SOR and the keyframe ring.

The PnP solve is compared on the SAME minimal sets: JAX draws them with its
own ``_sample_minimal_sets`` (exactly as its ``pnp_ransac`` does from the
key), and the port's ``_solve`` (one lane of ``_pnp_from_sets``) takes them
as given.  Tolerances:
pose entries 1e-4 (rotation) and 1e-3 m (translation) after 2 x 4 float32
Gauss-Newton rounds; inlier sets and counts must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu.models import step as jstep
from ros_stereo_slam_tpu.models.state import KeyframeStore as JKeyframeStore
from ros_stereo_slam_tpu.models.state import TrackState as JTrackState
from ros_stereo_slam_tpu.ops import pnp as jpnp
from ros_stereo_slam_tpu.ops import ransac as jransac
from ros_stereo_slam_tpu.ops import sor as jsor
from ros_stereo_slam_tpu.ops import triangulate as jtri
from ros_stereo_slam_tpu.utils import camera as jcam
from ros_stereo_slam_tpu.utils import lie as jlie
from ros_stereo_slam_tpu_torch.models import step as tstep
from ros_stereo_slam_tpu_torch.models.state import KeyframeStore, TrackState
from ros_stereo_slam_tpu_torch.ops import pnp as tpnp
from ros_stereo_slam_tpu_torch.ops import ransac as transac
from ros_stereo_slam_tpu_torch.ops import sor as tsor
from ros_stereo_slam_tpu_torch.ops import triangulate as ttri
from ros_stereo_slam_tpu_torch.parallel.mesh import Mesh
from ros_stereo_slam_tpu_torch.utils import camera as tcam
from ros_stereo_slam_tpu_torch.utils import cuda_graph

CAM = dict(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157)
CAM_T = tcam.Pinhole(**CAM)
CAM_J = jcam.Pinhole(**{k: jnp.float32(v) for k, v in CAM.items()})


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene(seed=0, n=400, noise_px=0.3, outlier_frac=0.2):
    """World points in front of a camera, a GT cam-from-world pose, noisy
    observations with gross outliers, and a validity mask."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 60, n)], 1).astype(np.float32)
    xi = np.concatenate([rng.normal(scale=0.3, size=3),
                         rng.normal(scale=0.02, size=3)]).astype(np.float32)
    T = np.array(jlie.exp_se3(jnp.asarray(xi)))
    pc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([CAM["fx"] * pc[:, 0] / pc[:, 2] + CAM["cx"],
                   CAM["fy"] * pc[:, 1] / pc[:, 2] + CAM["cy"]], 1)
    uv += rng.normal(scale=noise_px, size=uv.shape)
    bad = rng.random(n) < outlier_frac
    uv[bad] += rng.uniform(15, 60, (bad.sum(), 2)) * rng.choice([-1, 1], (bad.sum(), 2))
    mask = rng.random(n) > 0.1
    prior = np.array(jlie.exp_se3(jnp.asarray(xi + 0.01)))  # a nearby prior
    return X, uv.astype(np.float32), mask, T, prior


@pytest.mark.parametrize("case", ["dlt_only", "with_prior", "starved_retry"])
def test_pnp_from_jax_sets_matches_jax(case):
    X, uv, mask, T_gt, prior = _scene(seed={"dlt_only": 1, "with_prior": 2,
                                          "starved_retry": 3}[case])
    kw = dict(thresh_px=1.0, refine_iters=4, retry_thresh_px=8.0, min_inliers=10,
              huber_px=0.5)
    T_init = None
    if case != "dlt_only":
        T_init = prior
    if case == "starved_retry":
        kw.update(thresh_px=0.02, min_inliers=300)
    iters = 128
    key = jax.random.PRNGKey(7)
    jres = jpnp.pnp_ransac(
        key, CAM_J, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(mask), iters=iters,
        T_init=None if T_init is None else jnp.asarray(T_init), **kw)
    k_dlt, k_gn = jax.random.split(key)
    idx = jransac._sample_minimal_sets(k_dlt, jnp.asarray(mask), iters, 6)
    idx2 = (jransac._sample_minimal_sets(k_gn, jnp.asarray(mask), max(iters // 4, 16), 8)
            if T_init is not None else None)
    tres = tpnp._solve(
        torch.from_numpy(np.array(idx)).long(),
        None if idx2 is None else torch.from_numpy(np.array(idx2)).long(),
        CAM_T, torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(mask),
        T_init=None if T_init is None else torch.from_numpy(T_init), **kw)
    assert bool(tres.used_retry) == bool(jres.used_retry) == (case == "starved_retry")
    np.testing.assert_array_equal(tres.inliers.numpy(), np.asarray(jres.inliers))
    assert int(tres.n_inliers) == int(jres.n_inliers)
    Tt, Tj = tres.T_cw.numpy(), np.asarray(jres.T_cw)
    np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-3)
    np.testing.assert_allclose(Tt[:3, 3], T_gt[:3, 3], atol=0.05)  # and it is right


def test_pnp_ransac_generator_recovers_pose_deterministically():
    X, uv, mask, T_gt, prior = _scene(seed=4)
    args = (CAM_T, torch.from_numpy(X), torch.from_numpy(uv), torch.from_numpy(mask))
    kw = dict(thresh_px=1.0, iters=128, refine_iters=4, T_init=torch.from_numpy(prior),
              retry_thresh_px=8.0, min_inliers=10)
    a = tpnp.pnp_ransac(torch.Generator().manual_seed(3), *args, **kw)
    b = tpnp.pnp_ransac(torch.Generator().manual_seed(3), *args, **kw)
    assert torch.equal(a.T_cw, b.T_cw) and torch.equal(a.inliers, b.inliers)
    np.testing.assert_allclose(a.T_cw.numpy()[:3, 3], T_gt[:3, 3], atol=0.05)
    np.testing.assert_allclose(a.T_cw.numpy()[:3, :3], T_gt[:3, :3], atol=2e-3)
    assert int(a.n_inliers) > 0.6 * mask.sum()


def test_sample_minimal_sets_rows_are_distinct_valid_points():
    mask = torch.from_numpy(np.random.default_rng(5).random(300) > 0.5)
    idx = transac._sample_minimal_sets(torch.Generator().manual_seed(0), mask, 64, 8)
    assert idx.shape == (64, 8)
    assert bool(mask[idx].all())
    assert all(len(set(row.tolist())) == 8 for row in idx)


def _solve_inputs(lanes: int, prior: bool, K: int = 32, K2: int = 16):
    """`_pnp_from_sets`' tensors for `lanes` scenes (0: single-lane form)."""
    scenes = [_scene(seed=10 + b) for b in range(max(lanes, 1))]
    gen = torch.Generator().manual_seed(5)
    X, uv, mask, prior_T = (torch.from_numpy(np.stack([s[i] for s in scenes]))
                            for i in (0, 1, 2, 4))
    idx = torch.stack([transac._sample_minimal_sets(gen, m, K, 6) for m in mask])
    idx2 = torch.stack([transac._sample_minimal_sets(gen, m, K2, 8) for m in mask])
    out = (idx, idx2 if prior else None, X, uv, mask, prior_T if prior else None)
    return out if lanes else tuple(None if t is None else t[0] for t in out)


@pytest.mark.parametrize("lanes,prior", [(0, True), (0, False), (2, True), (2, False)])
def test_solve_on_cpu_is_the_eager_solve_bitwise(lanes, prior):
    idx, idx2, X, uv, mask, T_init = _solve_inputs(lanes, prior)
    kw = dict(thresh_px=1.0, refine_iters=4, T_init=T_init, retry_thresh_px=8.0,
              min_inliers=10, huber_px=0.5)
    fam = cuda_graph.PNP
    before = fam.eager
    got = tpnp._solve(idx, idx2, CAM_T, X, uv, mask, **kw)
    assert fam.eager == before + 1
    assert fam.captures == 0 and fam.replays == 0 and not fam.graphs
    if lanes:
        want = tpnp._pnp_from_sets(idx, idx2, CAM_T, X, uv, mask, **kw)
    else:  # the single-lane form is lane 0 of a B = 1 solve
        one = [None if t is None else t[None] for t in (idx, idx2, X, uv, mask, T_init)]
        want = tpnp._pnp_from_sets(*one[:2], CAM_T, *one[2:5], **dict(kw, T_init=one[5]))
        want = tpnp.PnPResult(*(t[0] for t in want))
    for a, b in zip(got, want, strict=True):
        assert a.shape == b.shape and torch.equal(a, b)
    assert int(got.n_inliers.min()) > 100


@pytest.mark.parametrize("prior", [True, False])
def test_single_lane_solve_is_lane_0_of_two_bitwise(prior):
    """A single-lane solve and lane 0 of a two-lane solve of the same sets
    give the same bits: a lane's result does not depend on the lanes beside
    it (the float64 Gauss-Newton steps, ``_gn_refine``)."""
    idx, idx2, X, uv, mask, T_init = _solve_inputs(2, prior)
    kw = dict(thresh_px=1.0, refine_iters=4, retry_thresh_px=8.0, min_inliers=10,
              huber_px=0.5)
    two = tpnp._solve(idx, idx2, CAM_T, X, uv, mask, T_init=T_init, **kw)
    lane0 = [None if t is None else t[0] for t in (idx, idx2, X, uv, mask, T_init)]
    one = tpnp._solve(*lane0[:2], CAM_T, *lane0[2:5], T_init=lane0[5], **kw)
    for name, a, b in zip(one._fields, one, two, strict=True):
        assert a.shape == b[0].shape and torch.equal(a, b[0]), name
    assert int(one.n_inliers) > 100


_KEY_KW = dict(thresh_px=1.0, refine_iters=8, retry_thresh_px=8.0, min_inliers=15,
               huber_px=0.5)


def _key(lanes=1, N=400, K=32, K2=16, prior=True, cam=CAM_T, **kw):
    return cuda_graph.PNP.key(dict(
        idx=torch.zeros((lanes, K, 6), dtype=torch.long),
        idx2=torch.zeros((lanes, K2, 8), dtype=torch.long) if prior else None, cam=cam,
        pts3d=torch.zeros((lanes, N, 3)), uv=torch.zeros((lanes, N, 2)),
        mask=torch.zeros((lanes, N), dtype=torch.bool),
        T_init=torch.eye(4).expand(lanes, 4, 4) if prior else None, **{**_KEY_KW, **kw}))


@pytest.mark.parametrize("change", [
    {}, {"thresh_px": 2.0}, {"retry_thresh_px": None}, {"retry_thresh_px": 4.0},
    {"min_inliers": 16}, {"refine_iters": 4}, {"huber_px": 1.0},
    {"cam": CAM_T._replace(fx=700.0)}, {"cam": CAM_T._replace(cy=180.0)},
    {"lanes": 2}, {"N": 768}, {"K": 128}, {"K2": 32}, {"prior": False},
])
def test_graph_key_separates_every_baked_in_scalar_and_shape(change):
    """Equal inputs (fresh tensors of the same signature) share one key;
    any scalar or shape the graph bakes in gives another."""
    assert (_key(**change) == _key()) == (not change)


@pytest.mark.parametrize("device,lanes,mesh,graph", [
    ("cuda", True, None, True),
    ("cuda", True, Mesh(rank=0, size=1, device=torch.device("cuda:0")), False),
    ("cuda", False, None, True),
    ("cpu", True, None, False),
])
def test_graph_engages_only_for_lanes_on_the_card_without_a_mesh(device, lanes, mesh, graph,
                                                                 monkeypatch):
    """Every solve reaches PnP's family in lane form (a single-lane call as
    B = 1), so the family's rule, which sees the device and the mesh only,
    replays single-lane solves on the card too."""
    seen = []

    def family(fn, mesh=None, **args):
        seen.append(tuple(args["mask"].shape))
        return fn(mesh=mesh, **args)

    monkeypatch.setattr(cuda_graph, "PNP", family)
    idx, idx2, X, uv, mask, T_init = _solve_inputs(2 if lanes else 0, True)
    tpnp._solve(idx, idx2, CAM_T, X, uv, mask, T_init=T_init, **_KEY_KW)
    assert seen == [(2 if lanes else 1, 400)]
    assert cuda_graph.GraphFamily().replays_on(torch.device(device), mesh) is graph


def test_triangulate_rectified_matches_jax():
    rng = np.random.default_rng(6)
    uvl = np.stack([rng.uniform(0, 1241, 300), rng.uniform(0, 376, 300)], 1)
    d = rng.uniform(-1, 60, 300)
    uvr = uvl - np.stack([d, rng.normal(scale=1.5, size=300)], 1)
    mask = rng.random(300) > 0.2
    args = [a.astype(np.float32) for a in (uvl, uvr)]
    t = ttri.triangulate_rectified(CAM_T, 0.54, *map(torch.from_numpy, args),
                                   torch.from_numpy(mask))
    j = jtri.triangulate_rectified(CAM_J, jnp.float32(0.54), *map(jnp.asarray, args),
                                   jnp.asarray(mask))
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    v = t.valid.numpy()
    np.testing.assert_allclose(t.points.numpy()[v], np.asarray(j.points)[v], rtol=1e-5)


def test_sor_filter_matches_jax():
    rng = np.random.default_rng(7)
    pts = rng.normal(scale=2.0, size=(768, 3)) + np.array([0.0, 0.0, 20.0])
    pts[:40] += rng.uniform(20, 60, (40, 3))  # isolated outliers
    pts[40:45, 2] = -3.0  # behind the camera
    pts[45:50, 2] = 900.0  # past max depth
    mask = rng.random(768) > 0.1
    pts = pts.astype(np.float32)
    t = tsor.sor_filter(torch.from_numpy(pts), torch.from_numpy(mask), mean_k=32)
    j = jsor.sor_filter(jnp.asarray(pts), jnp.asarray(mask), mean_k=32)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert not t.numpy()[:50].any() and t.numpy().sum() > 600


def test_keyframe_ring_matches_jax():
    cap, n = 4, 16
    tkf = KeyframeStore.empty(cap, n, "cpu")
    jkf = JKeyframeStore.empty(cap, n)
    rng = np.random.default_rng(8)
    for frame in range(6):  # wraps the ring
        p3 = rng.normal(size=(n, 3)).astype(np.float32)
        col = rng.random((n, 3)).astype(np.float32)
        m = rng.random(n) > 0.3
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = frame
        tkf = tstep._insert_keyframe(
            tkf, TrackState(torch.zeros(n, 2), torch.from_numpy(p3),
                            torch.from_numpy(col), torch.from_numpy(m)),
            torch.from_numpy(T), 10 * frame)
        jkf = jstep._insert_keyframe(
            jkf, JTrackState(jnp.zeros((n, 2)), jnp.asarray(p3), jnp.asarray(col),
                             jnp.asarray(m)),
            jnp.asarray(T), jnp.int32(10 * frame))
    for name in KeyframeStore._fields:
        np.testing.assert_array_equal(getattr(tkf, name).numpy(),
                                      np.asarray(getattr(jkf, name)), err_msg=name)


def test_triangulate_dlt_matches_jax():
    """The JAX package's DLT case (tests/test_geometry.py): a rectified pair
    at b = 0.54 m; both packages recover the points, and agree."""
    rng = np.random.default_rng(2)
    n, b = 64, 0.54
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n),
                  rng.uniform(5, 60, n)], 1).astype(np.float32)
    K = np.array([[CAM["fx"], 0, CAM["cx"]], [0, CAM["fy"], CAM["cy"]], [0, 0, 1]], np.float32)

    def project(t):
        pc = X + t
        return np.stack([K[0, 0] * pc[:, 0] / pc[:, 2] + K[0, 2],
                         K[1, 1] * pc[:, 1] / pc[:, 2] + K[1, 2]], 1).astype(np.float32)

    uv_l, uv_r = project(np.zeros(3, np.float32)), project(np.array([-b, 0, 0], np.float32))
    P1 = (K @ np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)).astype(np.float32)
    P2 = (K @ np.concatenate([np.eye(3), np.array([[-b], [0], [0]])], axis=1)).astype(np.float32)
    jout = np.asarray(jtri.triangulate_dlt(*(jnp.asarray(a) for a in (P1, P2, uv_l, uv_r))))
    tout = ttri.triangulate_dlt(*(torch.from_numpy(a) for a in (P1, P2, uv_l, uv_r))).numpy()
    np.testing.assert_allclose(tout, X, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(tout, jout, rtol=2e-3, atol=2e-2)


def test_trajectory_store_matches_jax():
    from ros_stereo_slam_tpu.models.state import TrajectoryStore as JTrajectoryStore
    from ros_stereo_slam_tpu_torch.models.state import TrajectoryStore

    t, j = TrajectoryStore.empty(5, "cpu"), JTrajectoryStore.empty(5)
    assert t._fields == j._fields
    for a, b in zip(t, j):
        assert a.dtype == {"float32": torch.float32, "bool": torch.bool,
                           "int32": torch.int32}[str(b.dtype)]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def frontend_pair():
    return _frontend_pair()


def _frontend_pair():
    """Frames 0 and 1 of the quarter-size world, both packages' pyramids and
    the config's profiles."""
    from ros_stereo_slam_tpu.config import PipelineConfig as JPipelineConfig
    from ros_stereo_slam_tpu.models import frontend as jfe
    from ros_stereo_slam_tpu_torch.config import PipelineConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import small_world
    from ros_stereo_slam_tpu_torch.models import frontend as tfe
    from ros_stereo_slam_tpu_torch.ops import grid

    world = small_world(n_frames=2, seed=3)
    c = world.camera
    frames = [world.render(i)[:2] for i in range(2)]
    fe = PipelineConfig().frontend
    jfe_cfg = JPipelineConfig().frontend
    levels = fe.lk_levels
    pyr_t = [[tfe.preprocess(torch.from_numpy(img), levels) for img in f] for f in frames]
    pyr_j = [[jfe.preprocess(jnp.asarray(img), levels) for img in f] for f in frames]
    pts, mask = grid.grid_points(c.height, c.width, 12, 1024)
    cam_t = tcam.Pinhole(fx=c.fx, fy=c.fy, cx=c.cx, cy=c.cy)
    cam_j = jcam.Pinhole(**{k: jnp.float32(getattr(c, k)) for k in ("fx", "fy", "cx", "cy")})
    return dict(jfe=jfe, tfe=tfe, fe=fe, jfe_cfg=jfe_cfg, pyr_t=pyr_t, pyr_j=pyr_j, pts=pts,
                mask=mask, cam_t=cam_t, cam_j=cam_j, baseline=c.baseline, frames=frames)


def _feeder(sets):
    """A draw callable that hands out index sets drawn by JAX, in order."""
    it = iter(sets)
    return lambda mask, k_hyp, m: torch.from_numpy(np.array(next(it))).long()


def _f1_band(d, levels: int) -> float:
    """How far from the top/left border JAX's jnp LK can read a wrapped
    patch (ROADMAP F1: ``lax.dynamic_slice`` wraps a negative start, the
    port clamps): a coarse-level window of 2^(levels-1) (window // 2 + 1) px."""
    return 2 ** (levels - 1) * (d["fe"].lk_window // 2 + 1)


def _only_f1_differences(mask_t, mask_j, pts, tracked, band: float) -> None:
    """Masks equal except at <= 3 points, each with its point or JAX's
    track within the F1 band of the top or left border."""
    diff = np.nonzero(mask_t != mask_j)[0]
    near = np.minimum(pts[diff].min(axis=1), tracked[diff].min(axis=1))
    assert len(diff) <= 3 and np.all(near < band), (diff, pts[diff], tracked[diff])


def _jax_bootstrap(d, key):
    """JAX's stereo_bootstrap and the F-gate sets it drew (its own LK mask)."""
    from ros_stereo_slam_tpu.ops import lk as jlk

    jfe, fe = d["jfe"], d["jfe_cfg"]
    lp, rp = d["pyr_j"][0]
    pts, mask = jnp.asarray(d["pts"]), jnp.asarray(d["mask"])
    res = jlk.track(lp, rp, pts, None, jfe._lk_stereo_params(fe))
    fidx = jransac._sample_minimal_sets(key, mask & res.valid, fe.fmat_iters, 8)
    out = jfe.stereo_bootstrap(lp, rp, pts, mask, jnp.eye(4, dtype=jnp.float32), key,
                               d["cam_j"], jnp.float32(d["baseline"]), jnp.float32(500.0), fe)
    return out, fidx


def test_preprocess_matches_jax(frontend_pair):
    d = frontend_pair
    for ft, fj in zip(d["pyr_t"], d["pyr_j"]):
        for pt_, pj_ in zip(ft, fj):
            assert len(pt_) == len(pj_) == d["fe"].lk_levels
            for a, b in zip(pt_, pj_):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_stereo_bootstrap_from_jax_sets_matches_jax(frontend_pair):
    """Stereo LK -> F-gate on JAX's index sets -> triangulation -> world:
    the same valid set but for F1's reach, points within 1e-3 m (float32
    LK tracks)."""
    from ros_stereo_slam_tpu.ops import lk as jlk

    d = frontend_pair
    (jstate_, jn), fidx = _jax_bootstrap(d, jax.random.PRNGKey(3))
    lp, rp = d["pyr_t"][0]
    T = torch.eye(4)
    tstate, tn = d["tfe"].bootstrap_from_sets(
        lp, rp, torch.from_numpy(d["pts"]), torch.from_numpy(d["mask"]), T, _feeder([fidx]),
        d["cam_t"], d["baseline"], 500.0, d["fe"])
    jtrack = np.asarray(jlk.track(*d["pyr_j"][0], jnp.asarray(d["pts"]), None,
                                  d["jfe"]._lk_stereo_params(d["jfe_cfg"])).points)
    mt, mj = tstate.mask.numpy(), np.asarray(jstate_.mask)
    _only_f1_differences(mt, mj, d["pts"], jtrack, _f1_band(d, d["fe"].lk_stereo_levels))
    assert abs(int(tn) - int(jn)) <= 3 and int(jn) > 100
    m = mt & mj
    np.testing.assert_allclose(tstate.pts3d.numpy()[m], np.asarray(jstate_.pts3d)[m],
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(tstate.colors.numpy(), np.asarray(jstate_.colors), atol=1e-6)
    # the generator form runs the same stages from its own draws
    gstate, gn = d["tfe"].stereo_bootstrap(
        lp, rp, torch.from_numpy(d["pts"]), torch.from_numpy(d["mask"]), T,
        torch.Generator().manual_seed(0), d["cam_t"], d["baseline"], 500.0, d["fe"])
    assert abs(int(gn) - int(jn)) <= 0.05 * int(jn)


def _jax_odometry_after_lk(d, jstate_, points, valid, key, pc):
    """JAX's odometry_step after its LK, recomposed from the JAX package's
    own F-gate and PnP on given LK output; also the index sets they draw."""
    cfg = d["jfe_cfg"]
    k_f, k_pnp = jax.random.split(key)
    m = jstate_.mask & valid
    fidx = jransac._sample_minimal_sets(k_f, m, cfg.fmat_iters, 8)
    fres = jransac.fmat_ransac(k_f, jstate_.pts2d, points, m, thresh_px=cfg.fmat_thresh_px,
                               iters=cfg.fmat_iters)
    m = m & fres.inliers
    pidx = jransac._sample_minimal_sets(jax.random.split(k_pnp)[0], m, pc.iters, 6)
    pres = jpnp.pnp_ransac(k_pnp, d["cam_j"], jstate_.pts3d, points, m, thresh_px=2.0,
                           iters=pc.iters, refine_iters=pc.refine_iters,
                           huber_px=pc.refine_huber_px)
    return pres, int(m.sum()), fidx, pidx


def test_odometry_step_from_jax_sets_matches_jax(frontend_pair):
    """Temporal LK -> F-gate -> PnP.  First, the JAX package's stages
    recomposed after its LK give its odometry_step bitwise (so the
    recomposition is the reference).  Then the port's stage, on the index
    sets JAX draws from its split key over the PORT's LK output, against
    that recomposition on the same LK output: equal tracked and inlier sets
    and counts, pose within 1e-4 / 1e-3 m.  (The LK outputs themselves
    differ only at F1's reach, where JAX reads a wrapped patch; LK parity
    is tests/test_torch_lk.py's.)"""
    from ros_stereo_slam_tpu.config import PnPConfig as JPnPConfig
    from ros_stereo_slam_tpu.ops import lk as jlk
    from ros_stereo_slam_tpu_torch.config import PnPConfig
    from ros_stereo_slam_tpu_torch.ops import lk as tlk

    d = frontend_pair
    (jstate_, _), _ = _jax_bootstrap(d, jax.random.PRNGKey(3))
    fe, jfe_cfg, pc = d["fe"], d["jfe_cfg"], PnPConfig()
    ref_j, cur_j = d["pyr_j"][0][0], d["pyr_j"][1][0]
    key = jax.random.PRNGKey(5)
    jout = d["jfe"].odometry_step(ref_j, cur_j, jstate_, key, d["cam_j"], jnp.float32(2.0),
                                  jfe_cfg, JPnPConfig())
    jres = jlk.track(ref_j, cur_j, jstate_.pts2d, None, d["jfe"]._lk_params(jfe_cfg))
    pres, n_trk, _, _ = _jax_odometry_after_lk(d, jstate_, jres.points, jres.valid, key, pc)
    np.testing.assert_array_equal(np.asarray(pres.T_cw), np.asarray(jout.T_cw))
    np.testing.assert_array_equal(np.asarray(pres.inliers), np.asarray(jout.mask))
    assert n_trk == int(jout.n_tracked)

    track = TrackState(*(torch.from_numpy(np.array(x)) for x in jstate_))
    tres = tlk.track(d["pyr_t"][0][0], d["pyr_t"][1][0], track.pts2d, None,
                     d["tfe"]._lk_params(fe))
    pres, n_trk, fidx, pidx = _jax_odometry_after_lk(
        d, jstate_, jnp.asarray(tres.points.numpy()), jnp.asarray(tres.valid.numpy()), key, pc)
    tout = d["tfe"].odometry_from_sets(d["pyr_t"][0][0], d["pyr_t"][1][0], track,
                                       _feeder([fidx, pidx]), d["cam_t"], 2.0, fe, pc)
    np.testing.assert_array_equal(tout.tracked.numpy(), tres.points.numpy())
    assert int(tout.n_tracked) == n_trk > 100
    assert int(tout.n_inliers) == int(pres.n_inliers)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(pres.inliers))
    Tj = np.asarray(pres.T_cw)
    np.testing.assert_allclose(tout.T_cw.numpy()[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(tout.T_cw.numpy()[:3, 3], Tj[:3, 3], atol=1e-3)
    np.testing.assert_allclose(tout.T_wc.numpy(), np.linalg.inv(tout.T_cw.numpy()), atol=1e-5)
    # the generator form: its own draws, the same pose to 2 cm
    gout = d["tfe"].odometry_step(d["pyr_t"][0][0], d["pyr_t"][1][0], track,
                                  torch.Generator().manual_seed(1), d["cam_t"], 2.0, fe, pc)
    np.testing.assert_allclose(gout.T_wc.numpy()[:3, 3], np.asarray(jout.T_wc)[:3, 3],
                               atol=0.02)
