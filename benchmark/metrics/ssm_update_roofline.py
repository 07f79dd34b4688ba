"""ssm_update_roofline: the Mamba-2 decode update (``ssm_update_kernel``)
against its roofline in the traced call: the sum of its launches' bounds
(``counts_hybrid.ssm_update_launch``: each row's fp32 state read and
written once) over the sum of their device times, in %. None where the call
launched none, or not one a Mamba layer a decode step."""

from benchmark import counts_hybrid as ch


def read(run):
    c, tr = run.traced_call(), run.trace
    if c is None or tr is None or "t3_steps" not in c.stages:
        return None
    ks = tr.kernels_named("ssm_update_kernel")
    bounds = ch.ssm_update_call_bounds(c.shapes["rows"] * 2, int(c.stages["t3_steps"]),
                                       ch.granite(run.config))
    if not ks or len(ks) != len(bounds):
        return None
    return 100.0 * sum(bounds) / sum(d for _, _, d in ks)
