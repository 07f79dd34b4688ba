"""P4: the int8 KV-cache fragments of ``scripts/probe_int8_cache.py`` on the
card, each checked against its plain version and timed.

    python -m chatterbox_tpu_torch.probes.int8_cache [--device cpu]

The six cases (``ops.probes.INT8_CASES``) are the operations an int8 cache
read needs (load + convert, dequantize and q.K, p.V, an int8 x f32 dot, the
f32 -> int8 store, the (8, D) tail . q), on the probe's inputs: K8 (64, 128)
int8, SC (8, 128) f32, Q (8, 64) f32 and KSD8 (8, 64) int8 from
``numpy.random.default_rng(0)`` in the script's order; ``wide_inputs`` is
a second set over the int8 range and signed scales.

On the card each case is one launch with programmatic dependent launch,
its inputs read in coalesced 16-byte vectors, and the probe's two grid
steps (which write the same block) computed once: what bounds it is the
launch, one round trip to L2 and, for dequant_matmul, the work of the one
SM that sums all of K8 (``csrc/probes.cu``).
"""

import numpy as np
import torch

from ..ops.probes import INT8_CASES, PD, SB, int8_probe, int8_probe_plain
from . import device_name, graph_ms, main

# the fp32 sums of each case: terms summed into one output element
_TERMS = {"i8_dequant_matmul": PD * SB, "i8_pv": SB, "i8_matmul_direct": PD * SB,
          "i8_sd_tail": 8 * PD}


def inputs(device):
    """(K8, SC, Q, KSD8) of the probe (probe_int8_cache.py:32-36)."""
    rng = np.random.default_rng(0)
    k8 = rng.integers(-127, 128, (PD, SB)).astype(np.int8)
    sc = rng.uniform(0.01, 0.02, (8, SB)).astype(np.float32)
    q = rng.standard_normal((8, PD)).astype(np.float32)
    t8 = rng.integers(-127, 128, (8, PD)).astype(np.int8)
    return tuple(torch.from_numpy(a).to(device) for a in (k8, sc, q, t8))


def wide_inputs(device):
    """A second (K8, SC, Q, KSD8), from ``numpy.random.default_rng(7)``: K8
    and KSD8 over the whole int8 range and SC signed, |SC * 100| < 127, so
    that the store truncates toward zero on both signs and stays in range."""
    rng = np.random.default_rng(7)
    k8 = rng.integers(-128, 128, (PD, SB)).astype(np.int8)
    sc = rng.uniform(-1.26, 1.26, (8, SB)).astype(np.float32)
    q = rng.standard_normal((8, PD)).astype(np.float32)
    t8 = rng.integers(-128, 128, (8, PD)).astype(np.int8)
    return tuple(torch.from_numpy(a).to(device) for a in (k8, sc, q, t8))


def limit(case, ins):
    """(per-element limit of |kernel - plain|, as text); None for the exact
    cases (a convert by 0.5, a truncating store). The others are fp32 sums
    of n products of two or three factors, taken in another order: within
    (n + 2) 2^-24 A, A the plain version on |inputs| (the sum of |terms|;
    the worst case of fp32 summation in any order)."""
    if case not in _TERMS:
        return None, "exact"
    a = int8_probe_plain(case, *(x.abs() for x in ins))
    return (_TERMS[case] + 2) * 2.0 ** -24 * a, "(n + 2) 2^-24 sum|terms|"


def run(device, iters: int = 200):
    """Each case: the kernel against its plain version (raises past its
    limit), then its device time (CUDA only). Returns the results."""
    ins = inputs(device)
    out = {"probe": "P4 int8 cache fragments", "device": device_name(device), "cases": {}}
    for case in INT8_CASES:
        before = int8_probe.launches
        got, want = int8_probe(case, *ins), int8_probe_plain(case, *ins)
        lim, tol = limit(case, ins)
        err = float((got.float() - want.float()).abs().max())
        if (lim is None and not torch.equal(got, want)) or (
                lim is not None and not bool(((got - want).abs() <= lim).all())):
            raise AssertionError(f"P4 {case}: the kernel differs from its plain version by {err}")
        r = {"max_abs_err": err, "tol": tol}
        if device.type == "cuda":
            r["ms"] = graph_ms(lambda c=case: int8_probe(c, *ins), iters)
        r["launches"] = int8_probe.launches - before
        out["cases"][case] = r
    return out


if __name__ == "__main__":
    main(run, __doc__.splitlines()[0])
