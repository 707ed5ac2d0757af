"""What the timed path's calls produced, taken where they are called.

A cell's file names, under ``samples``, the call sites it samples, each a
file ``slambench/sites/<name>.py`` (found by :mod:`slambench.manifest`)
that holds:

- ``TARGET``: (module under ``ros_stereo_slam_tpu_torch``, function name),
  the entry point the site wraps;
- ``wrap(orig, tap)``: the wrapper put in its place.  It calls `orig`
  and, while ``tap.active``, counts the call (``tap.calls``), offers a
  copy of its inputs and outputs to the site's sample (``tap.offer``;
  ``tap.full(img)`` says whether an image is full-size, pyramid level 0)
  and, in a traced session, may keep every call (``tap.keep``);
- ``numbers(items, ctx)``: the compared numbers of the sampled items
  (:func:`slambench.check.compare`; ``ctx`` is a ``check.Context``);
- optionally ``work(orig, call)``: the operations and bytes of one kept
  call (or None), which a roofline reader takes as ``<name>_work``.

:class:`Recorder` installs every named site in place, for the measured
window only.  Each sample is a reservoir of the cell's ``quota`` calls,
drawn from the run's seed (one generator for all sites, in the order the
calls come), so a run holds the same number of samples however long it
is and the choice does not depend on timing.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

PKG = "ros_stereo_slam_tpu_torch"
KEEP_CAP = 512  # calls a site keeps of a traced session


def copy(x):
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


class Tap:
    """One installed site: its module, the function it wraps, its sample,
    its calls in the window and what it kept of a traced session."""

    def __init__(self, recorder: Recorder, site, sample: Reservoir):
        self.recorder, self.site, self.sample = recorder, site, sample
        self.orig = None
        self.calls = 0
        self.kept: list = []

    @property
    def active(self) -> bool:
        return self.recorder.active

    def full(self, img) -> bool:
        return img.dim() == 2 and tuple(img.shape) == self.recorder.shape

    def offer(self, make) -> None:
        self.sample.offer(make)

    def keep(self, make) -> None:
        if self.recorder.tracing and len(self.kept) < KEEP_CAP:
            self.kept.append(make())

    def target(self):
        mod, name = self.site.TARGET
        return importlib.import_module(f"{PKG}.{mod}"), name


class Recorder:
    """Install with :meth:`install`, take out with :meth:`uninstall`.
    `sites` maps a site's name to its module, `quota` to its sample size;
    `shape` is a full-size frame's (H, W)."""

    def __init__(self, shape: tuple[int, int], seed: int, sites: dict, quota: dict):
        rng = np.random.default_rng(seed)
        self.shape = tuple(shape)
        self.taps = {k: Tap(self, site, Reservoir(int(quota.get(k, 0)), rng))
                     for k, site in sites.items()}
        self.tracing = False  # on while a traced session runs
        self.active = False

    @property
    def calls(self) -> dict:
        """Calls made in the window, by site."""
        return {k: t.calls for k, t in self.taps.items()}

    def install(self) -> None:
        for tap in self.taps.values():
            m, name = tap.target()
            tap.orig = getattr(m, name)
            setattr(m, name, tap.site.wrap(tap.orig, tap))

    def uninstall(self) -> None:
        for tap in self.taps.values():
            if tap.orig is not None:
                m, name = tap.target()
                setattr(m, name, tap.orig)
