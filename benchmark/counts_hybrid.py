"""The yardstick's arithmetic for T3 on the Granite 4.0-H backbone: the
backbone's widths from a configuration file, the bytes and operations of
its two decode kernels (the Mamba-2 update and K1a with query-head groups),
their launches' bounds over a call, and the model FLOPs of T3 over a call.

As in ``counts.py``: a bound counts each input byte read once and each
output byte written once, only what the inputs need (live KV slots), over
the card's peaks; model FLOPs count the matrix products, the attention
products and the recurrence's products (2 a multiply-add), and leave out
elementwise work.
"""

from benchmark.counts import bound_s, t3_prefix_lens

# the configuration file's top-level keys (the published config.json's) ->
# the backbone's widths, as the program's ``GraniteHybridConfig`` names them
KEYS = {"hidden_size": "hidden_size", "intermediate_size": "shared_intermediate_size",
        "num_hidden_layers": "num_hidden_layers", "layer_types": "layer_types",
        "num_attention_heads": "num_attention_heads",
        "num_key_value_heads": "num_key_value_heads",
        "attention_multiplier": "attention_multiplier", "mamba_n_heads": "mamba_n_heads",
        "mamba_d_head": "mamba_d_head", "mamba_d_state": "mamba_d_state",
        "mamba_n_groups": "mamba_n_groups", "mamba_d_conv": "mamba_d_conv",
        "mamba_chunk_size": "mamba_chunk_size", "embedding_multiplier": "embedding_multiplier",
        "residual_multiplier": "residual_multiplier", "logits_scaling": "logits_scaling",
        "rms_norm_eps": "rms_norm_eps"}


def granite(config: dict) -> dict:
    """The backbone's widths from a configuration's top-level keys, with
    ``layer_types`` a tuple."""
    g = {k: config[src] for k, src in KEYS.items()}
    g["layer_types"] = tuple(g["layer_types"])
    return g


def _dims(g: dict):
    h, p, n = g["mamba_n_heads"], g["mamba_d_head"], g["mamba_d_state"]
    d_inner = h * p
    conv_dim = d_inner + 2 * g["mamba_n_groups"] * n
    return h, p, n, d_inner, conv_dim


def n_layers(g: dict, kind: str) -> int:
    return sum(1 for t in g["layer_types"] if t == kind)


def ssm_update_launch(rows: int, g: dict, itemsize: int = 2):
    """(bytes, flops) of one launch of the Mamba-2 update (one layer, one
    step, ``rows`` rows): each row's fp32 state read and written, its conv
    inputs read and written, its xBC and dt read and y (fp32) written, in
    the working dtype's ``itemsize`` where not fp32; the layer's conv
    weights and head vectors once. Operations: 5 a state value (decay,
    input, update, the product with C and its sum) and 9 a conv channel."""
    h, p, n, d_inner, conv_dim = _dims(g)
    k = g["mamba_d_conv"]
    per_row = (2 * h * p * n * 4 + 2 * conv_dim * (k - 1) * itemsize
               + (conv_dim + h) * itemsize + d_inner * 4)
    n_bytes = rows * per_row + conv_dim * (k + 1) * 4 + 3 * h * 4
    return n_bytes, rows * (5 * h * p * n + 9 * conv_dim)


def k1a_gqa_step(prefix, gap_end: int, write_pos: int, q_heads: int, kv_heads: int,
                 head_dim: int):
    """(bytes, flops) of one K1a launch with ``q_heads / kv_heads`` query
    heads a KV head on the bf16 cache: each row's live slots [0, prefix)
    and [gap_end, write_pos), K and V of each KV head read once; q and the
    output of each query head, k_new and v_new of each KV head, the row
    prefix. Operations: q.k and p.v for each query head and live slot."""
    live = sum(p + write_pos - gap_end for p in prefix)
    rows = len(prefix)
    vecs = rows * head_dim * 2 * (2 * q_heads + 2 * kv_heads) + rows * 4
    return (2 * live * kv_heads * head_dim * 2 + vecs,
            4 * (live + rows) * q_heads * head_dim)


def _decode_slots(text_bucket: int, steps: int):
    """The cache slot each decode step writes (and reads up to): s0 + i for
    i < steps - 1, s0 = 34 + text bucket + 2."""
    s0 = 34 + text_bucket + 2
    return [s0 + i for i in range(steps - 1)]


def ssm_update_call_bounds(rows: int, steps: int, g: dict):
    """The bound (s) of each Mamba update launch of one call, in launch
    order: one a Mamba layer each decode step that runs the layers."""
    b = bound_s(*ssm_update_launch(rows, g))
    return [b] * ((steps - 1) * n_layers(g, "mamba"))


def k1a_gqa_call_bounds(text_lens, text_bucket: int, steps: int, g: dict):
    """The bound (s) of each K1a launch of one call, in launch order: one
    an attention layer a decode step."""
    prefix = t3_prefix_lens(text_lens)
    hq, hkv = g["num_attention_heads"], g["num_key_value_heads"]
    d = g["hidden_size"] // hq
    out = []
    for pos in _decode_slots(text_bucket, steps):
        b = bound_s(*k1a_gqa_step(prefix, 34 + text_bucket, pos, hq, hkv, d))
        out.extend([b] * n_layers(g, "attention"))
    return out


def token_flops(g: dict) -> int:
    """The backbone's matrix-product FLOPs for one token: in_proj and
    out_proj of each Mamba layer, q/k/v/o of each attention layer, the MLP
    of every layer, and each Mamba layer's recurrence (the input's outer
    product with B and the state's product with C, 2 a multiply-add each)."""
    c, f = g["hidden_size"], g["intermediate_size"]
    h, p, n, d_inner, conv_dim = _dims(g)
    d = c // g["num_attention_heads"]
    hq, hkv = g["num_attention_heads"] * d, g["num_key_value_heads"] * d
    mamba = 2 * c * (d_inner + conv_dim + h) + 2 * d_inner * c + 4 * h * p * n
    attention = 2 * c * (hq + 2 * hkv) + 2 * hq * c
    return (n_layers(g, "mamba") * mamba + n_layers(g, "attention") * attention
            + g["num_hidden_layers"] * 2 * 3 * c * f)


def t3_flops(text_lens, n_tokens, g: dict, vocab: int, n_cond: int = 34) -> float:
    """Model FLOPs of T3 on the Granite backbone over one call: for each
    text, both CFG streams' prefill of [cond; text; BOS; BOS] and a decode
    step for every served token but the last, through the backbone
    (``token_flops``), the attention layers' causal products (4 a query
    head dim a key) and the speech head; the perceiver is left out."""
    c = g["hidden_size"]
    hq_d = g["num_attention_heads"] * (c // g["num_attention_heads"])
    per_token = token_flops(g)
    n_attn = n_layers(g, "attention")
    total = 0.0
    for n_text, n in zip(text_lens, n_tokens):
        p0 = n_cond + int(n_text) + 2
        steps = max(int(n) - 1, 0)
        keys = p0 * (p0 + 1) // 2 + sum(p0 + i + 1 for i in range(steps))
        total += 2 * (per_token * (p0 + steps) + 4 * n_attn * hq_d * keys
                      + 2 * c * vocab * (1 + steps))
    return total
