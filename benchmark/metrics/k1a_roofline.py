"""k1a_roofline: K1a (bf16 split-S decode attention) against its roofline in
the traced call: the sum of its launches' bounds (each decode step's live
KV slots, ``counts.k1a_step``) over the sum of their device times, in %."""

from benchmark.metrics_common import k1_share


def read(run):
    return k1_share(run, int8=False)
