"""Kernel K2, ORB descriptors of one level (``ops/orb_cuda.level_describe``).

Sampled: single-lane calls on full-size images (pyramid level 0), whose
image the reference can trace back to a frame.  Numbers:

- ``k2_unmatched``: sampled calls whose image is none of the session's
  frames as the benchmark made them (0);
- ``k2_bits_differ``: the share of the valid corners' descriptor bits
  that differ from the reference's;
- ``k2_corner_bits_max``: the most bits of any one corner that differ.

The reference follows the program's corners: which corners K2 is given
is not the benchmark's choice.
"""

from slambench.check import unit
from slambench.record import copy
from slambench.reference import orb as orb_ref

TARGET = ("ops.orb_cuda", "level_describe")


def wrap(orig, tap):
    def level_describe(img, pts, valid):
        out = orig(img, pts, valid)
        if tap.active:
            tap.calls += 1
            if tap.full(img):
                tap.offer(lambda: dict(img=copy(img), pts=copy(pts), valid=copy(valid),
                                       out=tuple(copy(t) for t in out)))
        return out
    return level_describe


def numbers(items, ctx) -> dict:
    unmatched, differ, bits, worst = 0, 0, 0, 0
    for s in items:
        img = ctx.index.find(s["img"])
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
    return {"k2_unmatched": unmatched, "k2_bits_differ": differ / max(bits, 1),
            "k2_corner_bits_max": worst}
