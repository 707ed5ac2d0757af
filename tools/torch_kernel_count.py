#!/usr/bin/env python3
"""Device kernels and PyTorch ops per frame of the port's single-lane
odometry (``run_offline``) and full SLAM (``run_offline_slam``).

    python3 tools/torch_kernel_count.py render --out build/kc_frames.npz
    python3 tools/torch_kernel_count.py count --frames-file build/kc_frames.npz \
        [--preset odometry|mapping|ba|anms|orb_stereo] [--root TREE] [--label NAME] \
        [--out-dir DIR]

``render`` draws the frames once, with the port's renderer at full KITTI
geometry (1241x376): the first ``--odo-frames`` + 1 frames of the bench
corridor and the first ``--slam-frames`` + 1 frames of ``chip_smoke.py``'s
revisit world A.  ``count`` imports ``ros_stereo_slam_tpu_torch`` from
TREE (default: this checkout), so one frames file can be counted at two
commits of the port (unpack the other with ``git archive``).  Per path it
makes one cold run, one timed warm run, one warm run under
``torch.profiler`` (every device-side event: kernels, memcpy, memset; the
device busy share is their summed time over the run's wall time) and one
warm run under a dispatch mode that counts every PyTorch op that is not a
view.  It prints one JSON line per path and writes the per-name counts
(and, on the card, each kernel name's summed device microseconds) to
``--out-dir``.  ``--preset`` picks the configurations: ``odometry``
(default) runs ``preset_odometry()`` and full SLAM at
``preset_loop_closure()``; ``mapping`` runs ``preset_mapping()`` through
``run_offline`` with the corridor's RGB frames staged as uint8 (config 2;
no full-SLAM path: the preset has no loop closure); ``ba`` runs
``preset_ba()`` through both (config 4: windowed BA on every frame);
``anms`` and ``orb_stereo`` run ``preset_odometry()`` with the frontends of
``chip_smoke.py``'s phases reference_frontend (FAST + ANMS keypoints, both
F-matrix gates) and orb_stereo (ORB stereo matching, the temporal F-gate)
through ``run_offline`` only.  Full SLAM uses a vocabulary trained on the
card from every 2nd frame.

``pieces`` counts, on the CPU, the PyTorch ops that one call of each
piece of the frontend choices dispatches at full size: ``fmat_ransac``
(768 points, 128 hypotheses), the FAST + ANMS sampler, one ORB detection
(its K2 runs as the plain version here) and the descriptor match.

``--small`` renders at 416x160 for a rehearsal on the CPU (``count
--device cpu``, a k = 4, L = 3 vocabulary); only ops are counted there.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import multiprocessing
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]


def _camera_kw(small: bool) -> dict:
    if not small:
        return {}
    s = 416 / 1241
    return dict(fx=718.856 * s, fy=718.856 * s, cx=607.1928 * s, cy=185.2157 * 160 / 376,
                width=416, height=160)


def _render_job(cam_kw: dict, world_kw: dict, idx: list, rgb: bool) -> list:
    sys.path.insert(0, str(HERE))
    from ros_stereo_slam_tpu_torch.config import CameraConfig
    from ros_stereo_slam_tpu_torch.data.synthetic import SyntheticWorld

    world = SyntheticWorld(camera=CameraConfig(**cam_kw), **world_kw)
    return [world.render(i)[:2] + ((world.render_rgb(i) * 255.0 + 0.5).astype(np.uint8),)
            if rgb else world.render(i)[:2] for i in idx]


def render(args) -> None:
    sys.path.insert(0, str(HERE))
    import chip_smoke

    cam_kw = _camera_kw(args.small)
    corridor = (dict(n_frames=args.odo_frames + 1, seed=11, half_w=18.0),
                list(range(args.odo_frames + 1)))
    # world A's first lap: no jitter, brightness or noise before frame LAP
    jobs, _, _ = chip_smoke._revisit_plan(chip_smoke.SLAM_FRAMES + 1, (1, 1),
                                          *chip_smoke.REVISIT_SEEDS["A"])
    kw, idx = jobs[0]
    revisit = (kw, idx[:args.slam_frames + 1])
    chunks = [(cam_kw, w, ix[i:i + 4], w is corridor[0]) for w, ix in (corridor, revisit)
              for i in range(0, len(ix), 4)]
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        parts = pool.starmap(_render_job, chunks)
    frames = [f for p in parts for f in p]
    odo, slam = frames[:args.odo_frames + 1], frames[args.odo_frames + 1:]
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    np.savez(args.out, camera=json.dumps(cam_kw),
             odo_left=np.stack([f[0] for f in odo]), odo_right=np.stack([f[1] for f in odo]),
             odo_rgb=np.stack([f[2] for f in odo]),
             slam_left=np.stack([f[0] for f in slam]),
             slam_right=np.stack([f[1] for f in slam]))
    print(f"rendered {len(odo)} corridor + {len(slam)} revisit frames into {args.out}",
          flush=True)


def _op_counter(torch):
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCounter(TorchDispatchMode):
        """Counts every dispatched op that is not a view."""

        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                self.counts[str(func.overloadpacket.__name__)] += 1
            return func(*args, **(kwargs or {}))

    return OpCounter


def _measure(torch, fn, n_frames: int, cuda: bool) -> tuple[dict, dict]:
    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    sync()
    t0 = time.perf_counter()
    fn()
    sync()
    wall = time.perf_counter() - t0
    with _op_counter(torch)() as oc:
        fn()
        sync()
    ops = sum(oc.counts.values())
    row = {"frames": n_frames, "wall_s": wall, "fps": n_frames / wall, "ops": ops,
           "ops_per_frame": ops / n_frames}
    names = {"ops": dict(oc.counts.most_common())}
    if cuda:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall_p = time.perf_counter() - t0
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        copies = [e for e in dev if e.name.startswith(("Memcpy", "Memset"))]
        busy_us = sum(e.time_range.elapsed_us() for e in dev)
        row.update(device_events=len(dev), kernels=len(dev) - len(copies),
                   kernels_per_frame=(len(dev) - len(copies)) / n_frames,
                   copies=len(copies), wall_profiled_s=wall_p,
                   device_busy=busy_us * 1e-6 / wall_p)
        names["kernels"] = dict(collections.Counter(e.name for e in dev).most_common())
        us = collections.Counter()
        for e in dev:
            us[e.name] += e.time_range.elapsed_us()
        names["kernel_us"] = dict(us.most_common())
    return row, names


def count(args) -> None:
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    import ros_stereo_slam_tpu_torch  # noqa: F401  (sets the float policy)
    from ros_stereo_slam_tpu_torch.config import (
        CameraConfig, preset_ba, preset_loop_closure, preset_mapping, preset_odometry,
    )
    from ros_stereo_slam_tpu_torch.models import pipeline

    cuda = args.device.startswith("cuda")
    if cuda and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu for a rehearsal")
    dev = torch.device(args.device)
    data = np.load(args.frames_file)
    cam_kw = json.loads(str(data["camera"]))
    cam = CameraConfig(**cam_kw)
    out = {}

    odo_preset, slam_preset = {"odometry": (preset_odometry, preset_loop_closure),
                               "mapping": (preset_mapping, None),
                               "ba": (preset_ba, preset_ba),
                               "anms": (preset_odometry, None),
                               "orb_stereo": (preset_odometry, None)}[args.preset]
    odo_cfg = odo_preset().replace(camera=cam)
    if args.preset in ("anms", "orb_stereo"):
        sys.path.insert(0, str(HERE))
        import chip_smoke

        fe = {"anms": chip_smoke.REFERENCE_FRONTEND, "orb_stereo": chip_smoke.ORB_STEREO}
        odo_cfg = odo_cfg.replace(
            frontend=dataclasses.replace(odo_cfg.frontend, **fe[args.preset]))
    L = torch.from_numpy(data["odo_left"]).to(dev)
    R = torch.from_numpy(data["odo_right"]).to(dev)
    # rgb_seq only for mapping: an older tree's run_offline has no such argument
    kw = dict(rgb_seq=torch.from_numpy(data["odo_rgb"]).to(dev)) if args.preset == "mapping" else {}
    out["odometry"] = _measure(
        torch, lambda: pipeline.run_offline(odo_cfg, L, R, device=dev, **kw), L.shape[0] - 1, cuda)
    if slam_preset is not None:
        out["slam"] = _slam(torch, slam_preset().replace(camera=cam), cam_kw, data, dev, cuda)

    if args.out_dir:
        Path(args.out_dir).mkdir(parents=True, exist_ok=True)
        path = Path(args.out_dir) / f"kernel_count_{args.label}_{args.preset}.json"
        path.write_text(json.dumps({k: names for k, (_, names) in out.items()}, indent=1))
    for name, (row, _) in out.items():
        print(json.dumps({"label": args.label, "preset": args.preset, "path": name,
                          "device": str(dev), **row}), flush=True)


def _slam(torch, cfg, cam_kw: dict, data, dev, cuda: bool) -> tuple[dict, dict]:
    """Full SLAM over the revisit frames, with a vocabulary trained on them."""
    from ros_stereo_slam_tpu_torch.models import slam_scan, vocab
    from ros_stereo_slam_tpu_torch.ops import orb

    if cam_kw:  # the CPU rehearsal: a vocabulary small enough to train here
        cfg = cfg.replace(loop=dataclasses.replace(cfg.loop, vocab_k=4, vocab_levels=3))
    lcc = cfg.loop
    SL = torch.from_numpy(data["slam_left"]).to(dev)
    SR = torch.from_numpy(data["slam_right"]).to(dev)
    descs, docs = [], []
    for i in range(0, SL.shape[0], 2):
        f = orb.detect_and_compute(SL[i], lcc.orb_features, cfg.frontend.fast_thresh / 255.0,
                                   n_levels=lcc.orb_levels)
        descs.append(f.desc_sign[f.valid])
        docs.append(np.full(int(f.valid.sum()), i))
    voc = vocab.train_batched(torch.cat(descs), k=lcc.vocab_k, levels=lcc.vocab_levels,
                              doc_ids=np.concatenate(docs), device=dev)
    return _measure(torch, lambda: slam_scan.run_offline_slam(cfg, voc, SL, SR, device=dev),
                    SL.shape[0] - 1, cuda)


def pieces(args) -> None:
    """Ops dispatched by one call of each frontend piece (CPU, seeded inputs)."""
    sys.path.insert(0, str(HERE))
    import torch

    import ros_stereo_slam_tpu_torch  # noqa: F401  (sets the float policy)
    from ros_stereo_slam_tpu_torch.config import FrontendConfig
    from ros_stereo_slam_tpu_torch.models import step
    from ros_stereo_slam_tpu_torch.ops import match, orb, ransac

    gen = torch.Generator().manual_seed(0)
    p1 = torch.rand(768, 2, generator=gen) * 400
    p2 = p1 + torch.randn(768, 2, generator=gen)
    valid = torch.rand(768, generator=gen) < 0.9
    img = torch.rand(1, 376, 1241, generator=gen)
    signs = torch.sign(torch.randn(1152, 256, generator=gen))
    ones = torch.ones(1152, dtype=torch.bool)
    calls = {
        "fmat_ransac": lambda: ransac.fmat_ransac(gen, p1, p2, valid, 1.0, 128),
        "anms_sampler": lambda: step._sample_keypoints(img, None, None,
                                                       FrontendConfig(sampler="anms")),
        "orb_detect_1152": lambda: orb.detect_and_compute(img[0], 1152, 12 / 255.0),
        "orb_plain_k2_1152": lambda: orb._level_describe_plain(
            img[0], torch.full((1152, 2), 100.0), ones),
        "match_1152": lambda: match.mutual_hamming_match(signs, ones, signs, ones),
    }
    for name, fn in calls.items():
        with _op_counter(torch)() as oc:
            fn()
        print(json.dumps({"piece": name, "ops": sum(oc.counts.values())}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("render")
    r.add_argument("--out", required=True)
    r.add_argument("--odo-frames", type=int, default=16)
    r.add_argument("--slam-frames", type=int, default=32)
    r.add_argument("--workers", type=int, default=8)
    r.add_argument("--small", action="store_true")
    c = sub.add_parser("count")
    c.add_argument("--frames-file", required=True)
    c.add_argument("--root", default=str(HERE))
    c.add_argument("--label", default="this")
    c.add_argument("--device", default="cuda")
    c.add_argument("--preset", choices=("odometry", "mapping", "ba", "anms", "orb_stereo"),
                   default="odometry")
    c.add_argument("--out-dir", default="")
    sub.add_parser("pieces")
    args = ap.parse_args()
    {"render": render, "count": count, "pieces": pieces}[args.cmd](args)


if __name__ == "__main__":
    main()
