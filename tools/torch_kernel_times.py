#!/usr/bin/env python3
"""Times of the port's CUDA kernels alone and behind their wrappers, on
seeded noise images at the main path's shapes, for this checkout or for
another unpacked commit of the port.

    python3 tools/torch_kernel_times.py [--root TREE] [--label NAME]

It is the quick way to compare two commits' kernels on one card inside
one call: unpack the other commit with ``git archive`` into a git-ignored
directory and run the tool in turns (parent, change, change, parent); each
run takes a few seconds after the build.  Per kernel it prints one JSON
line: ``device_ms`` (200 bare launches of the C entry point back to back
between two CUDA events, the least of 7 rounds: the kernel alone), ``ms``
(median of 25 event windows around the wrapper call: checks, allocation
and the host's launch work included) and, once, an empty kernel's time
taken as ``device_ms`` is (the launch floor).  K3 also gets each launch
timed behind a spacer that keeps the queue ahead of the card
(``chip_smoke.device_ms_spaced``): a spin (``device_ms_spaced_hot``) and
a 64 MB scratch write, so the tables are not in L2 (``device_ms_cold``);
and one more row,
``descent``: the wrapper window of the whole descent, 512 sign
descriptors -> word ids through ``vocab._descend`` (whatever the tree
does inside: dense levels plus the deep kernel, or packing plus one
kernel), and, where the tree has the packed descent, the main path's
call on packed words (``main_path_ms``).  The timing functions are ``chip_smoke.py``'s;
TREE must offer ``bare_launch`` in its wrappers.

Shapes: K1 768 points, window 15, 6 iterations on a 1241x376 level (the
seeded temporal track), K1b the same on 2 lanes; K2 the corners FAST + ANMS
pick on a 1241x376 noise image (budget 173), every corner valid, through
``level_describe``, K2b on 2 lanes; K3 512 random sign descriptors (every ninth
invalid) through random +-1 tables of k = 9, L = 6 (the old kernel: the
59,049- and 531,441-row levels from the nodes the dense levels reach; the
packed kernel: all six levels).  The images are smooth noise, not
rendered frames, so the times are comparable between trees, not with
``chip_smoke.py``'s.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
SHAPE, N_PTS, BUDGET, LANES, K, LEVELS = (376, 1241), 768, 173, 2, 9, 6


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default="this")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    import chip_smoke  # this checkout's timing functions, whatever TREE holds

    sys.path.insert(0, str(Path(args.root).resolve()))  # the package under test
    import torch

    import ros_stereo_slam_tpu_torch  # noqa: F401  (sets the float policy)
    from ros_stereo_slam_tpu_torch.data.synthetic import _smooth_noise_2d
    from ros_stereo_slam_tpu_torch.models import vocab
    from ros_stereo_slam_tpu_torch.ops import lk, lk_cuda, orb, orb_cuda, vocab_cuda

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: kernel times come from a card only")
    dev = torch.device("cuda:0")
    rng = np.random.default_rng(0)
    H, W = SHAPE
    ref = np.stack([_smooth_noise_2d(SHAPE, rng, octaves=5, base_period=24)
                    for _ in range(LANES)]).astype(np.float32)
    cur = np.roll(ref, (-2, 3), axis=(1, 2))
    pts = np.stack([rng.uniform(40, W - 40, (LANES, N_PTS)),
                    rng.uniform(40, H - 40, (LANES, N_PTS))], -1).astype(np.float32)
    guess = (pts + np.array([3.0, -2.0]) + rng.uniform(-1, 1, pts.shape)).astype(np.float32)
    ref, cur, pts, guess = (torch.from_numpy(a).to(dev) for a in (ref, cur, pts, guess))
    params = lk.LKParams(window=15, levels=4, iters=6)
    corners, _ = orb._level_corners(ref, BUDGET, 12.0 / 255.0)
    every = torch.ones(corners.shape[:-1], dtype=torch.bool, device=dev)  # all corners valid
    centers = [torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), size=(K ** l, 256)))
               .to(dev) for l in range(1, LEVELS + 1)]
    q = rng.choice(np.array([-1.0, 1.0], np.float32), size=(512, 256))
    q[::9] = 0.0
    q = torch.from_numpy(q).to(dev)
    packed = hasattr(vocab, "pack_centers")
    if packed:
        tree = vocab.pack_centers(centers, K)
        bits, valid = vocab._pack_signs(q)
        k3 = (lambda: vocab_cuda.bare_launch(bits, valid, tree, K, LEVELS),
              lambda: vocab_cuda.descend(bits, valid, tree, K, LEVELS))
        descent = lambda: vocab._descend(tree, q, K, LEVELS)  # noqa: E731
    else:  # the int8 kernel of the two deep levels, from the dense levels' nodes
        first = LEVELS - 2
        node = vocab._descend(centers, q, K, first)
        deep = centers[first:]
        k3 = (lambda: vocab_cuda.bare_launch(q, node, deep, K),
              lambda: vocab_cuda.deep_descend(q, node, deep, K))
        descent = lambda: vocab._descend(centers, q, K, LEVELS)  # noqa: E731

    cases = {
        "lk_level": (lambda: lk_cuda.bare_launch(ref[0], cur[0], pts[0], guess[0], params),
                     lambda: lk_cuda.track_level(ref[0], cur[0], pts[0], guess[0], params)),
        "lk_level_batch": (lambda: lk_cuda.bare_launch(ref, cur, pts, guess, params),
                           lambda: lk_cuda.track_level_batch(ref, cur, pts, guess, params)),
        "orb_desc": (lambda: orb_cuda.bare_launch(ref[0], corners[0]),
                     lambda: orb_cuda.level_describe(ref[0], corners[0], every[0])),
        "orb_desc_batch": (lambda: orb_cuda.bare_launch(ref, corners),
                           lambda: orb_cuda.level_describe(ref, corners, every)),
        "vocab_descend": k3,
    }
    card = chip_smoke.run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"]).splitlines()[0].strip()
    floor = chip_smoke.device_ms(torch, lk_cuda.empty_launch())
    print(json.dumps({"label": args.label, "card": card, "launch_floor_ms": floor}), flush=True)
    scratch = torch.empty(64 << 20, dtype=torch.uint8, device=dev)


    for name, (bare, wrapper) in cases.items():
        wrapper()
        torch.cuda.synchronize()
        launch = bare()
        row = {"label": args.label, "name": name,
               "device_ms": chip_smoke.device_ms(torch, launch),
               "ms": chip_smoke.cuda_ms(torch, wrapper)}
        if name == "vocab_descend":
            row["device_ms_spaced_hot"] = chip_smoke.device_ms_spaced(
                torch, launch, lambda: torch.cuda._sleep(chip_smoke.SPIN_CYCLES))
            row["device_ms_cold"] = chip_smoke.device_ms_spaced(
                torch, launch, lambda: scratch.fill_(1))
        print(json.dumps(row), flush=True)
    row = {"label": args.label, "name": "descent", "ms": chip_smoke.cuda_ms(torch, descent)}
    if packed:
        row["main_path_ms"] = chip_smoke.cuda_ms(torch, k3[1])
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
