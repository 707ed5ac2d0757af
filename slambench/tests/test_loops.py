"""The closed loop, on a stub."""

import time

import numpy as np

from slambench import drivers, loops
from slambench.drivers import Session


class Stub:
    """A driver whose sessions take 10 ms."""

    def session(self, left, right):
        time.sleep(0.01)
        return Session(np.tile(np.eye(4), (len(left), 1, 1)), np.ones(len(left), bool))


def _nohook(i=None):
    import contextlib

    return contextlib.nullcontext()


def test_closed_loop_ends_at_the_first_session_end_past_the_window():
    w = loops.closed_loop(Stub(), [None] * 5, [None] * 5, 0.035, _nohook)
    assert len(w.sessions) == len(w.session_ends) >= 2
    assert w.session_ends[-2] < 0.035 <= w.session_ends[-1] <= w.seconds


def test_a_session_that_raises_counts_as_failed():
    class Raises(Stub):
        def session(self, left, right):
            raise RuntimeError("boom")

    w = loops.closed_loop(Raises(), [None] * 5, [None] * 5, 0.0, _nohook)
    s = w.sessions[0]
    assert "boom" in s.error and len(s.trajectory) == 0 and not s.tracking_ok.any()


def test_a_lane_driver_that_raises_fails_every_lane():
    class RaisesLanes(Stub):
        lanes = 3

        def session(self, left, right):
            raise RuntimeError("boom")

    w = loops.closed_loop(RaisesLanes(), [None] * 5, [None] * 5, 0.0, _nohook)
    lanes = drivers.flatten(w.sessions)
    assert len(w.sessions) == 1 and len(lanes) == 3
    assert all("boom" in s.error and not s.tracking_ok.any() for s in lanes)
