"""k1a_gqa_roofline: K1a with query-head groups (the Granite backbone's
attention layers, 4 query heads a KV head) against its roofline in the
traced call: the sum of its launches' bounds (``counts_hybrid.k1a_gqa_step``:
each decode step's live KV slots, counted by KV heads) over the sum of their
device times, in %. None where the call launched none, or not one an
attention layer a decode step."""

from benchmark import counts_hybrid as ch


def read(run):
    c, tr = run.traced_call(), run.trace
    if c is None or tr is None or "t3_steps" not in c.stages:
        return None
    ks = tr.kernels_named("flash_decode_kernel")
    bounds = ch.k1a_gqa_call_bounds(c.shapes["text_lens"], c.shapes["text_bucket"],
                                    int(c.stages["t3_steps"]), ch.granite(run.config))
    if not ks or len(ks) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(d for _, _, d in ks)
