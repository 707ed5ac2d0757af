"""What the timed path's kernels produced, taken where they are called.

:class:`Recorder` wraps the three kernel entry points of the program under
test (``ops/lk_cuda.track_level`` for K1, ``ops/orb_cuda.level_describe``
for K2, ``ops/vocab_cuda.descend`` for K3) in place, for the measured
window only.  Each wrapper calls the original and keeps a sample of its
calls, inputs and outputs copied: a reservoir of ``quota`` calls per
kernel drawn from the run's seed, so a run holds the same number of
samples however long it is and the choice does not depend on timing.  K1
and K2 samples are single-lane calls on full-size images (pyramid level
0), whose images the reference can trace back to a frame.

With ``trace_k1`` on (traced runs only) every K1 call is also kept, with
its inputs, up to ``TRACE_K1_CAP`` calls, for the operation and byte
counts of ``k1_roofline_pct``.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

PKG = "ros_stereo_slam_tpu_torch"
TRACE_K1_CAP = 512
SITES = {"k1": ("ops.lk_cuda", "track_level"), "k2": ("ops.orb_cuda", "level_describe"),
         "k3": ("ops.vocab_cuda", "descend")}


def _copy(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


class Reservoir:
    """A uniform sample of `quota` items from a stream, drawn by `rng`;
    `offer` makes an item only when it enters the sample."""

    def __init__(self, quota: int, rng: np.random.Generator):
        self.quota, self.rng, self.seen, self.items = quota, rng, 0, []

    def offer(self, make) -> None:
        self.seen += 1
        if len(self.items) < self.quota:
            self.items.append(make())
        else:
            j = int(self.rng.integers(self.seen))
            if j < self.quota:
                self.items[j] = make()


class Recorder:
    """Install with :meth:`install`, take out with :meth:`uninstall`."""

    def __init__(self, shape: tuple[int, int], seed: int, quota: dict):
        rng = np.random.default_rng(seed)
        self.shape = tuple(shape)
        self.samples = {k: Reservoir(int(quota.get(k, 0)), rng) for k in SITES}
        self.trace_k1 = False  # on while a traced session runs
        self.k1_calls: list = []  # every K1 call in a traced window (inputs, iters)
        self.calls = {k: 0 for k in SITES}  # calls made in the window
        self._saved: dict = {}
        self.active = False

    def _full(self, img) -> bool:
        return img.dim() == 2 and tuple(img.shape) == self.shape

    def _k1(self, orig):
        def track_level(ref_img, cur_img, ref_pts, guesses, params):
            out = orig(ref_img, cur_img, ref_pts, guesses, params)
            if self.active:
                self.calls["k1"] += 1
                if self.trace_k1 and len(self.k1_calls) < TRACE_K1_CAP:
                    self.k1_calls.append(tuple(_copy(t) for t in
                                               (ref_img, cur_img, ref_pts, guesses, out[0]))
                                         + (params,))
                if self._full(ref_img):
                    self.samples["k1"].offer(lambda: dict(
                        ref_img=_copy(ref_img), cur_img=_copy(cur_img), ref_pts=_copy(ref_pts),
                        guesses=_copy(guesses), params=params,
                        out=tuple(_copy(t) for t in out)))
            return out
        return track_level

    def _k2(self, orig):
        def level_describe(img, pts, valid):
            out = orig(img, pts, valid)
            if self.active:
                self.calls["k2"] += 1
                if self._full(img):
                    self.samples["k2"].offer(lambda: dict(
                        img=_copy(img), pts=_copy(pts), valid=_copy(valid),
                        out=tuple(_copy(t) for t in out)))
            return out
        return level_describe

    def _k3(self, orig):
        def descend(q_bits, valid, tree, k, upto):
            out = orig(q_bits, valid, tree, k, upto)
            if self.active:
                self.calls["k3"] += 1
                self.samples["k3"].offer(lambda: dict(
                    q_bits=_copy(q_bits), valid=_copy(valid), k=k, upto=upto, out=_copy(out)))
            return out
        return descend

    def install(self) -> None:
        wrap = {"k1": self._k1, "k2": self._k2, "k3": self._k3}
        for key, (mod, name) in SITES.items():
            m = importlib.import_module(f"{PKG}.{mod}")
            orig = getattr(m, name)
            self._saved[key] = (m, name, orig)
            setattr(m, name, wrap[key](orig))

    def uninstall(self) -> None:
        for m, name, orig in self._saved.values():
            setattr(m, name, orig)
        self._saved.clear()

    def original(self, key: str):
        """The unwrapped entry point of `key` (installed or not)."""
        if key in self._saved:
            return self._saved[key][2]
        mod, name = SITES[key]
        return getattr(importlib.import_module(f"{PKG}.{mod}"), name)
