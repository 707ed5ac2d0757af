"""Kernel K1 on lane stacks, one pyramidal LK level of every lane in one
launch (``ops/lk_cuda.track_level_batch``: (B, H, W) images, B > 1).

Sampled: one lane of a call on full-size images (pyramid level 0), the
lanes taken in turn over those calls; the reference traces the lane's images
back to that lane's frames (``check.FrameIndex`` over
:func:`slambench.reference.lanes.lane_stacks`).
In a traced session every call is also kept, with its inputs, for the
operation and byte counts of ``k1b_roofline_pct`` (:func:`work`).
Numbers, as K1's site gives them for single-lane calls:

- ``k1b_unmatched``: sampled lanes whose full-size image is none of that
  lane's frames (0);
- ``k1b_gap_px``: the widest gap between a sampled lane's tracked points
  and the reference's on the same frames, points and guesses, over points
  both tracked, that keep `reference.lk.BORDER_PX` inside the image and
  that converged in the reference;
- ``k1b_ok_flips``: the share of the points inside whose gate differs.

A lane's result does not depend on the other lanes of its call, so the
reference runs the sampled lane alone.  The reference follows the
program's points and guesses: which points K1 is given is not the
benchmark's choice.
"""

from slambench import check
from slambench.check import unit
from slambench.record import copy
from slambench.reference import lanes as lanes_ref
from slambench.reference import lk as lk_ref

TARGET = ("ops.lk_cuda", "track_level_batch")


def wrap(orig, tap):
    def track_level_batch(ref_imgs, cur_imgs, ref_pts, guesses, params):
        out = orig(ref_imgs, cur_imgs, ref_pts, guesses, params)
        if tap.active:
            tap.calls += 1
            tap.keep(lambda: tuple(copy(t) for t in (ref_imgs, cur_imgs, ref_pts, guesses, out[0]))
                     + (params,))
            if tap.full(ref_imgs[0]):
                b = tap.sample.seen % ref_imgs.shape[0]
                tap.offer(lambda: dict(
                    lane=b, ref_img=copy(ref_imgs[b]), cur_img=copy(cur_imgs[b]),
                    ref_pts=copy(ref_pts[b]), guesses=copy(guesses[b]), params=params,
                    out=tuple(copy(t[b]) for t in out)))
        return out
    return track_level_batch


def numbers(items, ctx) -> dict:
    left, right = ctx.index.stacks["left"], ctx.index.stacks["right"]
    index = [check.FrameIndex(lanes_ref.lane_stacks(left, right, b))
             for b in range(1 + max(s["lane"] for s in items))]
    unmatched, gaps, flips, n = 0, [0.0], 0, 0
    for s in items:
        ref, cur = index[s["lane"]].find(s["ref_img"]), index[s["lane"]].find(s["cur_img"])
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
    return {"k1b_unmatched": unmatched, "k1b_gap_px": max(gaps),
            "k1b_ok_flips": flips / max(n, 1)}


def work(orig, call):
    """The bound of one kept call of B lanes (:mod:`slambench.work`'s
    ``lk_work``, the Gauss-Newton steps counted by ``lk_evals``), or None
    for a call with no point (it launches nothing)."""
    from slambench import work as work_mod

    ref_imgs, cur_imgs, ref_pts, guesses, out_pts, params = call
    if ref_pts.numel() == 0:
        return None
    H, W = ref_imgs.shape[-2:]

    def track(k):
        return orig(ref_imgs, cur_imgs, ref_pts, guesses,
                    params._replace(iters=k, walk_iters=min(k, params.walk_iters)))

    evals = work_mod.lk_evals(track, guesses, out_pts, params.iters)
    return work_mod.lk_work(ref_pts, guesses, out_pts, H, W, params.window, evals)
