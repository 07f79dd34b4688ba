"""ssm_update_ms_per_step: the Mamba-2 decode update's device milliseconds
a decode step in the traced call: its launches' summed device time over the
steps that ran the layers (its launches over the Mamba layers a step)."""

from benchmark import counts_hybrid as ch


def read(run):
    tr = run.trace
    if run.traced_call() is None or tr is None:
        return None
    ks = tr.kernels_named("ssm_update_kernel")
    layers = ch.n_layers(ch.granite(run.config), "mamba")
    if not ks or len(ks) % layers:
        return None
    return 1e3 * sum(d for _, _, d in ks) / (len(ks) // layers)
