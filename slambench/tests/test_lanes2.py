"""The two-lane SLAM cell (``slam.revisit.lanes2``) on the CPU at the small
camera: a whole run is correct and counts every lane's frames, a lane-1
image altered inside K1b or K2b fails that site's limit, and lane 1 handed
lane 0's session fails the lane-session site's."""

import json

import pytest
import torch

from slambench import run
from slambench.tests.conftest import small_root
from slambench.tests.test_runs import SEED, SMALL

CELL = "slam.revisit.lanes2"
FRAMES = 72  # the small revisit world's
LIMITS = dict(SMALL, **{CELL: {"step_err_p50_m": 0.3, "pgo_cost_left": 0.01,
                               "k1b_gap_px": 0.01, "k1b_ok_flips": 0.01,
                               "k2b_bits_differ": 0.01, "k2b_corner_bits_max": 16}})


def _run(tmp_path, capsys, fault=None):
    args = run.parse(["--workload", CELL, "--seed", str(SEED), "--seconds", "0", "--trace", "0"])
    assert run.run(args, "cpu", root=small_root(tmp_path, LIMITS), faults=fault) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def plant_k1b_lane1_altered(mp) -> None:
    """K1b tracks lane 1 on its current image moved a pixel to the right."""
    from ros_stereo_slam_tpu_torch.ops import lk_cuda

    orig = lk_cuda.track_level_batch

    def track_level_batch(ref_imgs, cur_imgs, ref_pts, guesses, params):
        cur = cur_imgs.clone()
        cur[1] = torch.roll(cur_imgs[1], 1, dims=-1)
        return orig(ref_imgs, cur, ref_pts, guesses, params)

    mp.setattr(lk_cuda, "track_level_batch", track_level_batch)


def plant_k2b_lane1_altered(mp) -> None:
    """K2b describes lane 1 on its image's negative."""
    from ros_stereo_slam_tpu_torch.ops import orb_cuda

    orig = orb_cuda.level_describe

    def level_describe(img, pts, valid):
        if img.dim() == 3:
            img = img.clone()
            img[1] = 1.0 - img[1]
        return orig(img, pts, valid)

    mp.setattr(orb_cuda, "level_describe", level_describe)


def plant_lane1_epilogue_skipped(mp) -> None:
    """Lane 1's host epilogue is skipped: it is handed lane 0's result."""
    from ros_stereo_slam_tpu_torch.models import slam_scan

    orig, held = slam_scan._epilogue_one, []

    def _epilogue_one(cfg, lc, top_ids, top_scores, ns, fstats, keyframes, frame_of, phase=0):
        if held:  # every second call is lane 1's
            return held.pop()
        held.append(orig(cfg, lc, top_ids, top_scores, ns, fstats, keyframes, frame_of,
                         phase=phase))
        return held[0]

    mp.setattr(slam_scan, "_epilogue_one", _epilogue_one)


def plant_lane1_returns_lane0(mp) -> None:
    """Every lane's epilogue runs, and lane 1 returns lane 0's result."""
    from ros_stereo_slam_tpu_torch.models import slam_scan

    orig = slam_scan.run_offline_slam_batched

    def run_offline_slam_batched(*args, **kwargs):
        out = orig(*args, **kwargs)
        return [out[0]] * len(out)

    mp.setattr(slam_scan, "run_offline_slam_batched", run_offline_slam_batched)


def test_a_run_is_correct_and_counts_both_lanes(tmp_path, capsys):
    out = _run(tmp_path, capsys)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["attempted"] % (2 * FRAMES) == 0
    assert set(out["metrics"]) == {"fps", "setup_s"}
    for name in ("k1b_gap_px", "k2b_corner_bits_max", "k3_words_differ", "pgo_cost_left",
                 "lane_sessions_unmatched", "lane_sessions_twins"):
        assert out["checks"][name]["value"] is not None, name
    assert not any(k.startswith(("k1_", "k2_")) for k in out["checks"])  # no single-lane site


@pytest.mark.parametrize("plant,number", [(plant_k1b_lane1_altered, "k1b_gap_px"),
                                          (plant_k2b_lane1_altered, "k2b_corner_bits_max")])
def test_a_lane_1_image_altered_in_a_kernel_is_not_correct(tmp_path, capsys, monkeypatch, plant,
                                                           number):
    out = _run(tmp_path, capsys, fault=lambda: plant(monkeypatch))
    assert out["correct"] is False
    c = out["checks"][number]
    assert c["value"] > c["limit"], out["checks"]


@pytest.mark.parametrize("plant", [plant_lane1_epilogue_skipped, plant_lane1_returns_lane0])
def test_lane_1_handed_lane_0s_session_is_not_correct(tmp_path, capsys, monkeypatch, plant):
    out = _run(tmp_path, capsys, fault=lambda: plant(monkeypatch))
    assert out["correct"] is False
    for name in ("lane_sessions_unmatched", "lane_sessions_twins"):
        c = out["checks"][name]
        assert c["value"] > c["limit"], out["checks"]
