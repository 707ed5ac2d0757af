"""Kernel K1, one pyramidal LK level (``ops/lk_cuda.track_level``).

Sampled: single-lane calls on full-size images (pyramid level 0), whose
images the reference can trace back to a frame.  In a traced session
every call is also kept, with its inputs, for the operation and byte
counts of ``k1_roofline_pct`` (:func:`work`).  Numbers:

- ``k1_unmatched``: sampled calls whose full-size image is none of the
  session's frames as the benchmark made them (0): the start of the chain
  the reference does not follow;
- ``k1_gap_px``: the widest gap between a sampled call's tracked points
  and the reference's on the same frames, points and guesses, over points
  both tracked, that keep `reference.lk.BORDER_PX` inside the image and
  that converged in the reference (a point still moving after the last
  step walks where rounding takes it, on either side);
- ``k1_ok_flips``: the share of the points inside whose gate differs.

The reference follows the program's points and guesses: which points K1
is given is not the benchmark's choice.
"""

from slambench.check import unit
from slambench.record import copy
from slambench.reference import lk as lk_ref

TARGET = ("ops.lk_cuda", "track_level")


def wrap(orig, tap):
    def track_level(ref_img, cur_img, ref_pts, guesses, params):
        out = orig(ref_img, cur_img, ref_pts, guesses, params)
        if tap.active:
            tap.calls += 1
            tap.keep(lambda: tuple(copy(t) for t in (ref_img, cur_img, ref_pts, guesses, out[0]))
                     + (params,))
            if tap.full(ref_img):
                tap.offer(lambda: dict(
                    ref_img=copy(ref_img), cur_img=copy(cur_img), ref_pts=copy(ref_pts),
                    guesses=copy(guesses), params=params, out=tuple(copy(t) for t in out)))
        return out
    return track_level


def numbers(items, ctx) -> dict:
    unmatched, gaps, flips, n = 0, [0.0], 0, 0
    for s in items:
        ref, cur = ctx.index.find(s["ref_img"]), ctx.index.find(s["cur_img"])
        if ref is None or cur is None:
            unmatched += 1
            continue
        dev = s["ref_pts"].device
        p = s["params"]
        pts, _, ok, conv = lk_ref.track_level(unit(ref, dev), unit(cur, dev), s["ref_pts"],
                                              s["guesses"], p.window, p.iters, p.walk_iters,
                                              p.eps, p.min_eig)
        kp, _, kok = s["out"]
        H, W = ref.shape
        inner = (lk_ref.interior(pts, H, W) & lk_ref.interior(kp, H, W)
                 & lk_ref.interior(s["guesses"], H, W) & lk_ref.interior(s["ref_pts"], H, W))
        both = inner & ok & kok & conv
        if bool(both.any()):
            gaps.append(float((pts - kp)[both].abs().max()))
        flips += int((ok != kok)[inner].sum())
        n += int(inner.sum())
    return {"k1_unmatched": unmatched, "k1_gap_px": max(gaps),
            "k1_ok_flips": flips / max(n, 1)}


def work(orig, call):
    """The bound of one kept call (:mod:`slambench.work`), or None for a
    call with no point (it launches nothing)."""
    from slambench import work as work_mod

    if call[2].numel() == 0:
        return None
    return work_mod.k1_call_work(orig, call)
