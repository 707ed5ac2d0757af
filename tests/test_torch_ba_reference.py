"""Windowed Schur BA (config 4) against the benchmark's plain dense
reference (``slambench/reference/ba.py``), the sampled site's numbers
(``slambench/sites/ba.py``) and the BA spans and counters.

Windows: W poses 0.8 m apart along the optical axis (seq. 08's camera),
N landmarks 6-36 m deep, 0.5 px of noise, 5 % of the observations moved
25 px (Huber outliers), 15 % unobserved, the first 4 landmarks seen by no
view, poses 0 and W // 2 fixed, the rest perturbed.  The "guard" window
starts at its least-squares optimum (30 undamped-kernel steps of the
reference) and is solved with a 0.05 px Huber threshold: the kernel
moves it away from the optimum, the RMS rises, and the solve must keep
its input.

Tolerances, program (float32 out) against the float64 reference:

- camera centres of free poses within 1e-6 m: the outputs are float32,
  whose spacing at the window's 7 m is 4.8e-7 m (measured: at most
  3.5e-7);
- landmarks observed in 2 or more views within 5e-5 of their depth (the
  least z of the views that observe them): the depth of a landmark 36 m
  away seen over 0.8-6.4 m of forward motion is so poorly conditioned
  that two float64 eliminations part by 1e-5 of it (measured: at most
  1.8e-5);
- final RMS within 2e-6 px, two float32 spacings at 8-16 px (measured:
  at most 7.7e-7);
- the same keep-or-refine decision.

The reference computed in float32 fails at least one of them on every
window (measured: centres 1.3e-6 - 7.0e-6 m, landmarks 9.8e-6 - 6.8e-4,
RMS 2.6e-6 - 0.87 px).
"""

import numpy as np
import pytest
import torch

from ros_stereo_slam_tpu_torch.config import BAConfig, FrontendConfig, KeyframeConfig, preset_ba
from ros_stereo_slam_tpu_torch.data.synthetic import small_world
from ros_stereo_slam_tpu_torch.models import bundle_adjust, pipeline
from ros_stereo_slam_tpu_torch.utils import profiling
from ros_stereo_slam_tpu_torch.utils.camera import Pinhole
from slambench import manifest
from slambench.reference import ba as ba_ref
from slambench.tests.conftest import ROOT

POSE_TOL_M = 1e-6
LANDMARK_TOL = 5e-5
RMS_TOL_PX = 2e-6
CAM = Pinhole(707.0912, 707.0912, 601.8873, 183.1104)
SITE = manifest.load(ROOT / "slambench" / "sites" / "ba.py")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _window(W, N, seed):
    g = torch.Generator().manual_seed(seed)
    X = torch.stack([torch.rand(N, generator=g) * 24 - 12, torch.rand(N, generator=g) * 6 - 3,
                     torch.rand(N, generator=g) * 30 + 6], 1).double()
    xi = torch.zeros(W, 6, dtype=torch.float64)
    xi[:, 2] = -torch.arange(W) * 0.8
    xi[:, 0] = torch.randn(W, generator=g).double() * 0.1
    xi[:, 3:] = torch.randn(W, 3, generator=g).double() * 0.01
    T = ba_ref.exp(xi)
    p = torch.einsum("wij,nj->wni", T[:, :3, :3], X) + T[:, None, :3, 3]
    uv = (p[..., :2] / p[..., 2:3] * torch.tensor([CAM.fx, CAM.fy]).double()
          + torch.tensor([CAM.cx, CAM.cy]).double())
    uv = uv + torch.randn(uv.shape, generator=g).double() * 0.5
    uv[torch.rand(W, N, generator=g) < 0.05] += 25.0
    mask = torch.rand(W, N, generator=g) < 0.85
    mask[:, :4] = False
    fixed = torch.zeros(W, dtype=torch.bool)
    fixed[0] = fixed[W // 2] = True
    Tp = ba_ref.exp(torch.randn(W, 6, generator=g).double() * 0.02) @ T
    Tp[fixed] = T[fixed]
    Xp = X + torch.randn(N, 3, generator=g).double() * 0.1
    return Tp.float(), Xp.float(), uv.float(), mask, fixed


def _case(W, N, kind):
    T, X, uv, mask, fixed = _window(W, N, seed=W * 1000 + N)
    kw = dict(iters=10, damping=1e-4, huber_px=2.0)
    if kind == "guard":
        ls = ba_ref.solve(tuple(CAM), T, X, uv, mask, fixed, iters=30, huber_px=1e9)
        T, X = ls.T_cw.float(), ls.landmarks.float()
        kw["huber_px"] = 0.05
    return T, X, uv, mask, fixed, kw


def _centres(T):
    T = T.double()
    return -(T[:, :3, :3].transpose(1, 2) @ T[:, :3, 3:])[..., 0]


def _gaps(T, X, rms_after, ref, mask, fixed):
    """(centre gap m, landmark gap over depth, RMS gap px) against `ref`."""
    z = (torch.einsum("wij,nj->wni", ref.T_cw[:, :3, :3], ref.landmarks)
         + ref.T_cw[:, None, :3, 3])[..., 2]
    depth = torch.where(mask, z, torch.inf).min(0).values
    seen = mask.sum(0) >= 2  # one view leaves a landmark's depth to the damping
    return (float((_centres(T) - _centres(ref.T_cw))[~fixed].norm(dim=1).max()),
            float(((X.double() - ref.landmarks).norm(dim=1) / depth)[seen].max()),
            abs(float(rms_after) - float(ref.rms_after)))


@pytest.mark.parametrize("kind", ["refined", "guard"])
@pytest.mark.parametrize("W,N", [(4, 32), (4, 128), (9, 32), (9, 128)])
def test_ba_solve_matches_the_dense_reference(W, N, kind):
    T, X, uv, mask, fixed, kw = _case(W, N, kind)
    got = bundle_adjust.ba_solve(CAM, T, X, uv, mask, fixed, **kw)
    ref = ba_ref.solve(tuple(CAM), T, X, uv, mask, fixed, **kw)
    kept = torch.equal(got.T_cw, T) and torch.equal(got.landmarks, X)
    assert kept == (not ref.accepted) == (kind == "guard")
    if kind == "guard":
        assert float(ref.rms_after) == float(ref.rms_before)
        assert float(got.rms_after) == pytest.approx(float(ref.rms_before), rel=1e-6)
        return
    # the unseen landmarks and the fixed poses are held by both
    assert torch.equal(got.landmarks[:4], X[:4]) and torch.equal(got.T_cw[fixed], T[fixed])
    assert torch.equal(ref.landmarks[:4], X[:4].double())
    assert float(ref.rms_after) < float(ref.rms_before)
    pose, lm, rms = _gaps(got.T_cw, got.landmarks, got.rms_after, ref, mask, fixed)
    assert pose <= POSE_TOL_M and lm <= LANDMARK_TOL and rms <= RMS_TOL_PX, (pose, lm, rms)
    r32 = ba_ref.solve(tuple(CAM), T, X, uv, mask, fixed, dtype=torch.float32, **kw)
    pose, lm, rms = _gaps(r32.T_cw, r32.landmarks, r32.rms_after, ref, mask, fixed)
    assert pose > POSE_TOL_M or lm > LANDMARK_TOL or rms > RMS_TOL_PX, (pose, lm, rms)


def _item(T, X, uv, mask, fixed, kw, out):
    return dict(cam=tuple(CAM), T_cw=T, landmarks=X, obs=uv, obs_mask=mask, fixed=fixed,
                out=tuple(out[:4]), **kw)


@pytest.mark.parametrize("fault", ["sound", "input_returned", "iters_1"])
def test_the_site_numbers_hold_the_program_and_catch_the_faults(fault):
    """The site's numbers over two sampled solves: within the tolerances
    above for the program; a solve that returns its input flips the
    accept decision; one Gauss-Newton step in place of ten leaves the
    poses centimetres off."""
    T, X, uv, mask, fixed, kw = _case(9, 128, "refined")
    if fault == "input_returned":
        out = bundle_adjust.BAResult(T, X, torch.tensor(1.0), torch.tensor(1.0))
    else:
        out = bundle_adjust.ba_solve(CAM, T, X, uv, mask, fixed,
                                     **dict(kw, iters=1 if fault == "iters_1" else 10))
    item = _item(T, X, uv, mask, fixed, kw, out)
    guard = _case(4, 32, "guard")
    kept = _item(*guard, bundle_adjust.ba_solve(CAM, *guard[:5], **guard[5]))
    got = SITE.numbers([item, kept], None)
    assert set(got) == {"ba_pose_gap_m", "ba_landmark_gap_rel", "ba_rms_gap_px",
                        "ba_accept_flips"}
    if fault == "sound":
        assert got["ba_accept_flips"] == 0
        assert got["ba_pose_gap_m"] <= POSE_TOL_M and got["ba_landmark_gap_rel"] <= LANDMARK_TOL
        assert got["ba_rms_gap_px"] <= RMS_TOL_PX
    elif fault == "input_returned":
        assert got["ba_accept_flips"] == 1 and got["ba_pose_gap_m"] > 1e-3
    else:
        assert got["ba_accept_flips"] == 0 and got["ba_pose_gap_m"] > 1e-3


def _tiny_ba_run(frames=5, iters=3):
    world = small_world(n_frames=frames, seed=21, scale=4)
    cfg = preset_ba().replace(
        camera=world.camera, frontend=FrontendConfig(grid_step=12, max_points=256),
        keyframes=KeyframeConfig(max_keyframes=8, min_pnp_inliers=60, map_block_points=256),
        ba=BAConfig(window=4, iters=iters))
    imgs = [world.render(i) for i in range(frames)]
    L, R = np.stack([f[0] for f in imgs]), np.stack([f[1] for f in imgs])
    return cfg, L, R


def test_ba_spans_and_counters_of_a_run():
    """One run_offline under preset_ba(): with a profiler capture every
    ``step.ba`` span holds its solve's ``ba.*`` spans, the three step
    spans once an iteration and ``ba.accept`` once; the counters count
    one solve a stepped frame and `iters` iterations a solve; without a
    capture nothing is recorded and the counters still count."""
    cfg, L, R = _tiny_ba_run()
    iters, frames = cfg.ba.iters, len(L)
    profiling.reset(profiling.CAPACITY)
    solves, its = bundle_adjust.SOLVES, bundle_adjust.ITERATIONS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        pipeline.run_offline(cfg, L, R, device="cpu")
    got = profiling.spans()
    assert bundle_adjust.SOLVES - solves == frames - 1
    assert bundle_adjust.ITERATIONS - its == iters * (frames - 1)
    steps = [s for s in got if s.name == "step.ba"]
    frame_ids = {s.id for s in got if s.name == "step.frame"}
    assert len(steps) == frames - 1 and all(s.parent in frame_ids for s in steps)
    for s in steps:
        assert s.attrs == {"lanes": 1, "W": cfg.ba.window + 1, "N": cfg.frontend.max_points,
                           "iters": iters}
        kids = [c for c in got if c.parent == s.id]
        names = [c.name for c in sorted(kids, key=lambda c: c.start_ns)]
        assert names == ["ba.linearize", "ba.reduce", "ba.factor"] * iters + ["ba.accept"]
        assert all(s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns for c in kids)
    assert {s.name for s in got if s.name.startswith("ba.")} == {
        "ba.linearize", "ba.reduce", "ba.factor", "ba.accept"}

    profiling.reset(profiling.CAPACITY)
    solves = bundle_adjust.SOLVES
    pipeline.run_offline(cfg, L, R, device="cpu")
    assert profiling.spans() == [] and profiling.summary() == {}
    assert bundle_adjust.SOLVES - solves == frames - 1


def test_a_solve_of_no_iteration_records_only_its_accept():
    T, X, uv, mask, fixed, kw = _case(4, 32, "refined")
    profiling.reset(profiling.CAPACITY)
    its = bundle_adjust.ITERATIONS
    with profiling.tracing():
        got = bundle_adjust.ba_solve(CAM, T, X, uv, mask, fixed, **dict(kw, iters=0))
    assert [s.name for s in profiling.spans()] == ["ba.accept"]
    assert bundle_adjust.ITERATIONS == its
    assert torch.equal(got.T_cw, T) and torch.equal(got.landmarks, X)
    assert float(got.rms_after) == float(got.rms_before)
    profiling.reset(profiling.CAPACITY)
