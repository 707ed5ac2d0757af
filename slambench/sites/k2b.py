"""Kernel K2 on lane stacks, ORB descriptors of one level of every lane in
one launch (``ops/orb_cuda.level_describe`` on (B, H, W) images).

Sampled: one lane of a call on full-size images (pyramid level 0), the
lanes taken in turn over those calls; the reference traces the lane's image
back to that lane's frames (``check.FrameIndex`` over
:func:`slambench.reference.lanes.lane_stacks`).
Numbers, as K2's site gives them for single-image calls:

- ``k2b_unmatched``: sampled lanes whose image is none of that lane's
  frames (0);
- ``k2b_bits_differ``: the share of the valid corners' descriptor bits
  that differ from the reference's;
- ``k2b_corner_bits_max``: the most bits of any one corner that differ.

A lane's result does not depend on the other lanes of its call, so the
reference describes the sampled lane alone.  The reference follows the
program's corners: which corners K2 is given is not the benchmark's
choice.
"""

from slambench import check
from slambench.check import unit
from slambench.record import copy
from slambench.reference import lanes as lanes_ref
from slambench.reference import orb as orb_ref

TARGET = ("ops.orb_cuda", "level_describe")


def wrap(orig, tap):
    def level_describe(img, pts, valid):
        out = orig(img, pts, valid)
        if tap.active and img.dim() == 3:
            tap.calls += 1
            if tap.full(img[0]):
                b = tap.sample.seen % img.shape[0]
                tap.offer(lambda: dict(lane=b, img=copy(img[b]), pts=copy(pts[b]),
                                       valid=copy(valid[b]), out=tuple(copy(t[b]) for t in out)))
        return out
    return level_describe


def numbers(items, ctx) -> dict:
    left, right = ctx.index.stacks["left"], ctx.index.stacks["right"]
    index = [check.FrameIndex(lanes_ref.lane_stacks(left, right, b))
             for b in range(1 + max(s["lane"] for s in items))]
    unmatched, differ, bits, worst = 0, 0, 0, 0
    for s in items:
        img = index[s["lane"]].find(s["img"])
        if img is None:
            unmatched += 1
            continue
        dev = s["pts"].device
        ref = orb_ref.signs(unit(img, dev), s["pts"], s["valid"])
        v = s["valid"]
        per_corner = (ref[v] != s["out"][0][v]).sum(1)
        if per_corner.numel():
            differ += int(per_corner.sum())
            worst = max(worst, int(per_corner.max()))
        bits += int(v.sum()) * orb_ref.N_BITS
    return {"k2b_unmatched": unmatched, "k2b_bits_differ": differ / max(bits, 1),
            "k2b_corner_bits_max": worst}
