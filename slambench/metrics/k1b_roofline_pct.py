"""Kernel K1's share of its roofline over a lane driver's traced session:
the least time of every ``lk_level_kernel`` launch at the card's published
peaks (bytes and operations by ``slambench/work.py``'s ``lk_work`` for each
call the K1b site kept on lane stacks, ``k1b_work``, and the K1 site kept
on single lanes, ``k1_work``) over the device time the trace gives those
launches.  None unless the kept calls and the launches count the same."""

from slambench import example

KERNEL = "lk_level_kernel"


def EXAMPLE():
    """The shared record's two K1 launches, one kept by each site."""
    rec = example.record()
    rec["k1b_work"], rec["k1_work"] = rec["k1_work"][:1], rec["k1_work"][1:]
    return rec


EXPECTED = 10.0  # 2 x 0.5 ms of bound over 2 x 5 ms of device time


def read(rec):
    durs = [d for name, _, d in rec["trace"]["kernels"] if KERNEL in name]
    work = (rec.get("k1b_work") or []) + (rec.get("k1_work") or [])
    if not durs or len(durs) != len(work):
        return None
    device_s = sum(durs) * 1e-9
    return 100.0 * sum(w["bound_s"] for w in work) / device_s if device_s > 0 else None
