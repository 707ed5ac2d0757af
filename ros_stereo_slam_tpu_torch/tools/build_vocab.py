"""Offline ORB vocabulary trainer (reference C10 — the ``BoWtest`` tool,
``reference/src/bagOfWordsDetector.cpp:109-135``).

Port of ``tools/build_vocab.py``: extracts ORB descriptors from every Nth
left image of a sequence (KITTI or synthetic), trains the hierarchical
binary vocabulary (``vocab.build_vocab``: the host-recursive ``train`` up
to 4,096 words, the level-synchronous ``train_batched`` above) and saves
it as ``.npz`` in the reference's layout, which either package loads.

  python -m ros_stereo_slam_tpu_torch.tools.build_vocab --root /data/kitti \
      --seq 00 --out vocab_00.npz
  python -m ros_stereo_slam_tpu_torch.tools.build_vocab --synthetic --frames 64 \
      --out vocab_syn.npz
"""

from __future__ import annotations

import argparse
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m ros_stereo_slam_tpu_torch.tools.build_vocab")
    ap.add_argument("--root", default=None)
    ap.add_argument("--seq", default="00")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--stride", type=int, default=4)
    ap.add_argument("--k", type=int, default=9, help="branching (reference: 9)")
    ap.add_argument("--levels", type=int, default=6,
                    help="depth (reference: 6 = 531,441 words; the sparse "
                         "BoW database scores any size in O(features))")
    ap.add_argument("--orb_levels", type=int, default=None,
                    help="ORB pyramid octaves; defaults to "
                         "LoopClosureConfig.orb_levels so vocabulary "
                         "training sees the SAME descriptor distribution "
                         "the detector extracts at query time")
    ap.add_argument("--features", type=int, default=512)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    import numpy as np
    import torch

    from ros_stereo_slam_tpu_torch.config import LoopClosureConfig
    from ros_stereo_slam_tpu_torch.data import kitti
    from ros_stereo_slam_tpu_torch.data.synthetic import small_world
    from ros_stereo_slam_tpu_torch.models import vocab as vocab_mod
    from ros_stereo_slam_tpu_torch.ops import orb
    from ros_stereo_slam_tpu_torch.tools import device_of

    dev = device_of(args.device)
    if dev is None:
        return 2
    if args.orb_levels is None:
        args.orb_levels = LoopClosureConfig().orb_levels

    if args.synthetic:
        world = small_world(n_frames=args.frames, seed=3)

        def frame(i):
            return world.render(i)[0]
        n = args.frames
    else:
        root = args.root or kitti.find_kitti_root()
        if root is None:
            print("ERROR: no KITTI root", file=sys.stderr)
            return 2
        seq = kitti.KittiSequence(root, args.seq)

        def frame(i):
            return seq.frame(i)[0]
        n = min(len(seq), args.frames)
        print(f"[vocab] sequence {args.seq}: frames read by the {seq.route} decoder")

    descs, docs = [], []
    for i in range(0, n, args.stride):
        f = orb.detect_and_compute(torch.as_tensor(frame(i)).to(dev), args.features,
                                   n_levels=args.orb_levels)
        v = f.valid.cpu().numpy()
        descs.append(f.desc_sign.cpu().numpy()[v])
        docs.append(np.full(int(v.sum()), i))
        if i % 40 == 0:
            print(f"[vocab] {i}/{n} ({sum(len(d) for d in descs)} descriptors)")
    X = np.concatenate(descs)
    print(f"[vocab] training k={args.k} L={args.levels} on {len(X)} descriptors on {dev}...")
    voc = vocab_mod.build_vocab(X, k=args.k, levels=args.levels,
                                doc_ids=np.concatenate(docs), device=dev)
    voc.save(args.out)
    print(f"[vocab] saved {voc.n_words}-word vocabulary to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
