"""The share of K1's roofline, for the two K1 readers."""

from . import counts

KERNELS = {False: "flash_decode_kernel", True: "flash_decode_int8_kernel"}


def k1_share(run, int8: bool):
    """Sum of the traced call's K1 launch bounds over their device time, in
    %; None when the call launched none of this variant, or not one a
    layer a decode step (the schedule ``counts.k1_call_bounds`` assumes)."""
    c, tr = run.traced_call(), run.trace
    if c is None or tr is None or bool(c.shapes.get("kv_int8")) != int8:
        return None
    ks = tr.kernels_named(KERNELS[int8])
    t3 = run.config["t3"]
    bounds = counts.k1_call_bounds(c.shapes["text_lens"], c.shapes["text_bucket"],
                                   int(c.stages["t3_steps"]), t3["llama"], int8)
    if not ks or len(ks) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(d for _, _, d in ks)
