"""The port's hand-written kernels, each beside its plain PyTorch version.

``kernels()`` names every wrapper that launches a kernel: the twelve of the
TTS and VC paths (the Mamba-2 decode update on the Granite backbone's T3
only; the decode step's three glue kernels on the Llama's) and the five of
the probes (``probes/``); a wrapper counts
its own launches in ``fn.launches`` (CPU calls, which take the plain
version, do not count; T3's captured decode step adds the launches it
captured at each replay, ``models/t3/t3.py``).
"""

PROBE_KERNELS = ("noop_copy", "cache_column_write", "cache_block_rmw", "int8_probe",
                 "softmax_probe")


def kernels():
    """{name: wrapper} for the seventeen kernels: the TTS and VC paths'
    twelve, then ``PROBE_KERNELS``."""
    from . import probes
    from .decode_glue import add_rms_norm, rope_split_kv, silu_mul
    from .flash_attention import (
        flash_relpos_attention,
        flash_self_attention,
        flash_self_attention_packed,
    )
    from .flash_decode import (
        flash_decode_layer_attention,
        flash_decode_layer_attention_int8,
        flash_decode_layer_attention_stats,
        kv_cache_append,
        kv_cache_quantize_write,
    )
    from .ssm_decode import ssm_decode_update

    return {
        "flash_decode_layer_attention": flash_decode_layer_attention,
        "flash_decode_layer_attention_stats": flash_decode_layer_attention_stats,
        "flash_decode_layer_attention_int8": flash_decode_layer_attention_int8,
        "kv_cache_append": kv_cache_append,
        "kv_cache_quantize_write": kv_cache_quantize_write,
        "flash_self_attention_packed": flash_self_attention_packed,
        "flash_self_attention": flash_self_attention,
        "flash_relpos_attention": flash_relpos_attention,
        "ssm_decode_update": ssm_decode_update,
        "add_rms_norm": add_rms_norm,
        "rope_split_kv": rope_split_kv,
        "silu_mul": silu_mul,
        **{name: getattr(probes, name) for name in PROBE_KERNELS},
    }


def reset_launch_counts():
    for fn in kernels().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in kernels().items()}
