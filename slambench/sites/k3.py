"""Kernel K3, the vocabulary descent (``ops/vocab_cuda.descend``).

Sampled: every call.  Number: ``k3_words_differ``, sampled words that
differ from the reference descent over the benchmark's vocabulary tables
(0).  The reference follows the program's descriptors: which descriptors
K3 is given is not the benchmark's choice.
"""

from slambench.record import copy
from slambench.reference import vocab as vocab_ref

TARGET = ("ops.vocab_cuda", "descend")


def wrap(orig, tap):
    def descend(q_bits, valid, tree, k, upto):
        out = orig(q_bits, valid, tree, k, upto)
        if tap.active:
            tap.calls += 1
            tap.offer(lambda: dict(q_bits=copy(q_bits), valid=copy(valid), k=k, upto=upto,
                                   out=copy(out)))
        return out
    return descend


def numbers(items, ctx) -> dict:
    if ctx.centers is None:
        return {}
    differ = 0
    for s in items:
        cs = [c.to(s["q_bits"].device) for c in ctx.centers[: s["upto"]]]
        ref = vocab_ref.words(s["q_bits"], s["valid"], cs, s["k"])
        differ += int((ref != s["out"]).sum())
    return {"k3_words_differ": differ}
