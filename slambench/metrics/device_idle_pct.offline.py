"""The share of the traced session in which no operation ran on the
device: 100 minus the union of all device activity over the session."""

from slambench import example

EXAMPLE = example.record
EXPECTED = 70.0  # busy 30 ms of 100


def read(rec):
    t = rec["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] > 0 else None
