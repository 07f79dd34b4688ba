"""P5: the online-softmax fragments of ``scripts/probe_ops.py`` on the card,
each checked against its plain version and timed.

    python -m chatterbox_tpu_torch.probes.ops [--device cpu]

The nine cases A-I (``ops.probes.SOFTMAX_CASES``) are the pieces of the
decode kernel's online softmax (max, sum and exp of a 128-slot row,
broadcast stores into a (1, 64) scratch, q.k^T, bf16 dots) on the probe's
inputs: x (8, 128) and v (128, 64) f32 from ``numpy.random.default_rng(0)``
and ``default_rng(1)``. Each runs the probe's two grid steps over one
persistent scratch, which starts at zero here (``scr0``). The kernel
computes the work the two steps share once (both read the same x and v)
and applies case H's scratch update twice; the plain version runs the two
steps as the probe does.
"""

import numpy as np
import torch

from ..ops.probes import PD, SB, SOFTMAX_CASES, softmax_probe, softmax_probe_plain
from . import device_name, graph_ms, main

# |kernel - plain| <= 2^-14 (|plain| + A): fp32 sums of at most 128 terms in
# another order and expf within 2 ulps, through exps whose arguments carry
# the same round-off; A is the plain version on |x|, |v|, |scr0|, the scale
# of the terms summed (case I adds a term: see ``limit``)
REL_LIMIT = 2.0 ** -14


def inputs(device):
    """(x, v) of the probe (probe_ops.py:24-25)."""
    x = np.random.default_rng(0).standard_normal((8, SB)).astype(np.float32)
    v = np.random.default_rng(1).standard_normal((SB, PD)).astype(np.float32)
    return torch.from_numpy(x).to(device), torch.from_numpy(v).to(device)


def limit(case, x, v, scr0):
    """(per-element limit of |kernel - plain|, as text); see REL_LIMIT.
    Case I also rounds its exps to bf16 on both sides, where an exp that
    differs in its last fp32 bits can round to the neighbouring bf16 value:
    2^-7 (e |k|) more, e the exps and k the bf16 values."""
    want = softmax_probe_plain(case, x, v, scr0)
    a = softmax_probe_plain(case, x.abs(), v.abs(), scr0.abs())
    lim = REL_LIMIT * (want.abs() + a.abs())
    if case != "I_bf16_dots":
        return lim, "2^-14 (|want| + A)"
    k2 = v.to(torch.bfloat16).float()
    scores = x[0:1, :v.shape[1]].to(torch.bfloat16).float() @ k2.T
    return lim + 2.0 ** -7 * (torch.exp(scores - scores.max()) @ k2.abs()), \
        "2^-14 (|want| + A) + 2^-7 e|k|"


def run(device, iters: int = 200):
    """Each case from a zero scratch: the kernel against its plain version
    (raises past its limit), then its device time (CUDA only)."""
    x, v = inputs(device)
    scr0 = torch.zeros((1, PD), dtype=torch.float32, device=device)
    out = {"probe": "P5 online-softmax fragments", "device": device_name(device), "cases": {}}
    for case in SOFTMAX_CASES:
        before = softmax_probe.launches
        got, want = softmax_probe(case, x, v, scr0), softmax_probe_plain(case, x, v, scr0)
        lim, tol = limit(case, x, v, scr0)
        err = float((got - want).abs().max())
        if not bool(((got - want).abs() <= lim).all()):
            raise AssertionError(f"P5 {case}: the kernel differs from its plain version by {err}")
        r = {"max_abs_err": err, "tol": tol}
        if device.type == "cuda":
            r["ms"] = graph_ms(lambda c=case: softmax_probe(c, x, v, scr0), iters)
        r["launches"] = softmax_probe.launches - before
        out["cases"][case] = r
    return out


if __name__ == "__main__":
    main(run, __doc__.splitlines()[0])
