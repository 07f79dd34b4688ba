"""The port's hand-written kernels, each beside its plain PyTorch version.

``kernels()`` names every wrapper that launches a kernel of a TTS or VC
path; a wrapper counts its own launches in ``fn.launches`` (CPU calls, which
take the plain version, do not count).
"""


def kernels():
    """{name: wrapper} for the eight kernels of the TTS and VC paths."""
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

    return {
        "flash_decode_layer_attention": flash_decode_layer_attention,
        "flash_decode_layer_attention_stats": flash_decode_layer_attention_stats,
        "flash_decode_layer_attention_int8": flash_decode_layer_attention_int8,
        "kv_cache_append": kv_cache_append,
        "kv_cache_quantize_write": kv_cache_quantize_write,
        "flash_self_attention_packed": flash_self_attention_packed,
        "flash_self_attention": flash_self_attention,
        "flash_relpos_attention": flash_relpos_attention,
    }


def reset_launch_counts():
    for fn in kernels().values():
        fn.launches = 0


def launch_counts():
    return {name: fn.launches for name, fn in kernels().items()}
