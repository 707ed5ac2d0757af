"""Kernel K1's share of its roofline over the traced session: the least
time its launches could take at the card's published peaks (bytes and
operations by ``slambench/work.py``'s counts for each call the K1 site
kept, ``k1_work``; the bound that rules is bytes for every call measured
so far) over the device time the trace gives the ``lk_level_kernel``
launches, matched in order."""

from slambench import example

KERNEL = "lk_level_kernel"
EXAMPLE = example.record
EXPECTED = 10.0  # 2 x 0.5 ms of bound over 2 x 5 ms of device time


def read(rec):
    durs = [d for name, _, d in rec["trace"]["kernels"] if KERNEL in name]
    work = rec.get("k1_work") or []
    n = min(len(durs), len(work))
    if n == 0 or len(durs) != len(work):
        return None
    device_s = sum(durs[:n]) * 1e-9
    return 100.0 * sum(w["bound_s"] for w in work[:n]) / device_s if device_s > 0 else None
