"""k1cd_roofline: K1c+d (int8 KV cache with the exact bf16 tail) against its
roofline in the traced call, as ``k1a_roofline`` (``counts.k1cd_step``)."""

from benchmark.metrics_common import k1_share


def read(run):
    return k1_share(run, int8=True)
