"""How a mix offers frames: a closed loop of whole sessions.

Sessions run back to back, each a fresh run of the driver over the mix's
frames; the window ends at the first session end at or after `seconds`,
so it always holds whole sessions.  A session that raises counts as a
failed session for each of the driver's lanes.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    sessions: list  # each session's drivers.Session (a lane driver's: a list of them), in order
    seconds: float  # from the first session's start to the last one's end
    session_ends: list = field(default_factory=list)  # seconds at each end


def closed_loop(driver, left, right, seconds: float, hooks) -> Window:
    """Sessions of `driver.session(left, right)` until `seconds` have passed.
    `hooks(i)` gives a context manager around session i (tracing)."""
    from slambench.drivers import Session

    sessions, ends = [], []
    t0 = time.perf_counter()
    while True:
        with hooks(len(sessions)):
            try:
                s = driver.session(left, right)
            except Exception:  # the session's frames count as failed
                n, lanes = len(left), getattr(driver, "lanes", 1)
                s = Session(np.zeros((0, 4, 4)), np.zeros(n, bool), [],
                            traceback.format_exc(limit=8))
                if lanes > 1:
                    s = [s] * lanes
        sessions.append(s)
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    return Window(sessions, time.perf_counter() - t0, ends)
