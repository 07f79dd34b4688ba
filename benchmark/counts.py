"""The yardstick's arithmetic: the card's published peaks, the least time a
kernel launch could take (its roofline bound), and the model FLOPs a call's
inputs need.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the 700 W limit. A
bound counts each input byte read once and each output byte written once,
and only what the inputs need: live KV slots, valid rows and frames, not
padding. Model FLOPs count the matrix products and convolutions (2 per
multiply-add) and the attention products; elementwise work, the STFTs and
the mel frontends are left out, so ``mfu`` never counts more than was
needed.
"""

PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
TAIL_W = 8  # the int8 KV cache's exact tail: its last TAIL_W slots in bf16


def bound_s(n_bytes: float, flops: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least seconds a launch moving ``n_bytes`` and doing ``flops``
    could take: the larger of the two over the card's peaks."""
    return max(n_bytes / PEAK_BYTES, flops / peak_flops)


# --------------------------------------------------------------- T3 decode


def t3_prefix_lens(text_lens, n_cond: int = 34):
    """Each CFG row's [cond; text] slots (the K1 ``row_prefix``), both
    streams of each text."""
    return [n_cond + int(n) for n in text_lens for _ in (0, 1)]


def _k1_vec_bytes(rows: int, heads: int, head_dim: int) -> int:
    return 4 * rows * heads * head_dim * 2 + rows * 4  # q, k_new, v_new, out; row_prefix


def k1a_step(prefix, gap_end: int, write_pos: int, heads: int, head_dim: int):
    """(bytes, flops) of one K1a launch (one layer, one decode step) on the
    bf16 cache: each row's live slots [0, prefix) and [gap_end, write_pos),
    K and V of each read once, plus the step's own token."""
    live = sum(p + write_pos - gap_end for p in prefix)
    rows = len(prefix)
    return (2 * live * heads * head_dim * 2 + _k1_vec_bytes(rows, heads, head_dim),
            4 * (live + rows) * heads * head_dim)


def k1cd_step(prefix, gap_end: int, write_pos: int, heads: int, head_dim: int):
    """(bytes, flops) of one K1c+d launch on the int8 cache: slots below
    merge_base int8 with an fp32 scale each for K and V, the rest of the
    live slots from the bf16 tail."""
    mb = write_pos // TAIL_W * TAIL_W
    live8 = tail = 0
    for p in prefix:
        live8 += min(p, mb) + max(0, mb - gap_end)
        tail += max(0, min(p, write_pos) - mb) + max(0, write_pos - max(mb, gap_end))
    rows = len(prefix)
    n_bytes = (2 * heads * head_dim * (live8 + 2 * tail) + 2 * heads * 4 * live8
               + _k1_vec_bytes(rows, heads, head_dim))
    return n_bytes, 4 * (live8 + tail + rows) * heads * head_dim


def k1_call_bounds(text_lens, text_bucket: int, steps: int, llama: dict, int8: bool):
    """The bound (s) of each decode step's K1 launch of one call, in launch
    order (one launch a layer a step, so a step's entry repeats for each
    layer): the decode loop feeds token i at cache slot s0 + i for i <
    steps - 1, s0 = 34 + text bucket + 2."""
    prefix = t3_prefix_lens(text_lens)
    gap_end = 34 + text_bucket
    s0 = gap_end + 2
    fn = k1cd_step if int8 else k1a_step
    out = []
    for i in range(steps - 1):
        b = bound_s(*fn(prefix, gap_end, s0 + i, llama["num_attention_heads"], llama["head_dim"]))
        out.extend([b] * llama["num_hidden_layers"])
    return out


def llama_token_flops(llama: dict) -> int:
    """The Llama layers' matrix-product FLOPs for one token."""
    c, f = llama["hidden_size"], llama["intermediate_size"]
    hd = llama["num_attention_heads"] * llama["head_dim"]
    kvd = llama["num_key_value_heads"] * llama["head_dim"]
    return 2 * llama["num_hidden_layers"] * (c * (hd + 2 * kvd) + hd * c + c * 2 * f + f * c)


def t3_flops(text_lens, n_tokens, llama: dict, vocab: int, n_cond: int = 34) -> float:
    """Model FLOPs of T3 over one call: for each text, both CFG streams'
    prefill of [cond; text; BOS; BOS] (causal attention) and a decode step
    for every served token but the last (its logits are never read), the
    Llama layers and the speech head; the perceiver is left out."""
    c, n_l = llama["hidden_size"], llama["num_hidden_layers"]
    hd = llama["num_attention_heads"] * llama["head_dim"]
    per_token = llama_token_flops(llama)
    total = 0.0
    for n_text, n in zip(text_lens, n_tokens):
        p0 = n_cond + int(n_text) + 2
        steps = max(int(n) - 1, 0)
        keys = p0 * (p0 + 1) // 2 + sum(p0 + i + 1 for i in range(steps))
        total += 2 * (per_token * (p0 + steps) + 4 * n_l * hd * keys
                      + 2 * c * vocab * (1 + steps))
    return total


# --------------------------------------------------------------- S3Gen


def conformer_flops(t_tok: int, enc: dict) -> float:
    """The flow's encoder on one row of ``t_tok`` tokens: the input
    projection, the lookahead convs, ``num_blocks`` rel-pos blocks at t_tok,
    the x2 upsample conv, ``num_up_blocks`` blocks at 2 t_tok."""
    c, f = enc["output_size"], enc["linear_units"]

    def blocks(t, n):
        per = 2 * t * (4 * c * c + 2 * c * f) + 2 * (2 * t - 1) * c * c + 6 * t * t * c
        return n * per

    t2 = enc["up_stride"] * t_tok
    k1 = enc["pre_lookahead_len"] + 1
    return (2 * t_tok * enc["input_size"] * c + 2 * t_tok * c * c * (k1 + 3)
            + blocks(t_tok, enc["num_blocks"]) + 2 * t2 * c * c * (2 * enc["up_stride"] + 1)
            + 2 * t2 * c * c + blocks(t2, enc["num_up_blocks"]))


def unet_flops(t: int, est: dict) -> float:
    """One velocity estimate of the UNet on one row of ``t`` mel frames."""
    c = est["channels"]
    inner = est["num_heads"] * est["attention_head_dim"]
    tf = 2 * t * (c * 3 * inner + inner * c + 2 * c * 4 * c) + 4 * t * t * inner

    def resnet(cin):
        return 2 * t * (cin * c * 3 + c * c * 3 + cin * c)

    n_tf = est["n_blocks"] * (2 + est["num_mid_blocks"])
    return (resnet(est["in_channels"]) + resnet(c) * est["num_mid_blocks"] + resnet(2 * c)
            + n_tf * tf + 3 * 2 * t * c * c * 3 + 2 * t * c * est["out_channels"])


def flow_flops(prompt_tokens: int, n_tokens: int, flow: dict) -> float:
    """The flow on one row: the encoder over [prompt; tokens], its output
    projection, and the Euler steps' UNet on both CFG streams."""
    t_tok = prompt_tokens + n_tokens
    t_mel = flow["token_mel_ratio"] * t_tok
    return (conformer_flops(t_tok, flow["encoder"]) + 2 * t_mel * flow["encoder"]["output_size"]
            * flow["output_size"] + 2 * flow["n_timesteps"] * unet_flops(t_mel, flow["estimator"]))


def hift_flops(t_mel: int, hift: dict) -> float:
    """HiFT on one row of ``t_mel`` generated mel frames: the f0 predictor,
    conv_pre, each stage's transposed conv, source conv and resblocks, and
    conv_post."""
    base, f0c = hift["base_channels"], hift["f0_cond_channels"]
    n_stft = hift["istft_n_fft"] + 2
    total = 2 * t_mel * (hift["in_channels"] * f0c * 3 + 4 * f0c * f0c * 3 + f0c)
    total += 2 * t_mel * hift["in_channels"] * base * 7
    t_in, mult = t_mel, 1
    rates, kernels = hift["upsample_rates"], hift["upsample_kernel_sizes"]
    for i, (u, k) in enumerate(zip(rates, kernels)):
        cin, ch = base // 2 ** i, base // 2 ** (i + 1)
        total += 2 * t_in * cin * ch * k
        mult *= u
        t_out = t_mel * mult + (1 if i == len(rates) - 1 else 0)
        u_src = _down_stride(rates, i)
        down_k = 2 * u_src if u_src > 1 else 1
        total += 2 * t_out * n_stft * ch * down_k
        res = [hift["source_resblock_kernel_sizes"][i]] + list(hift["resblock_kernel_sizes"])
        total += sum(2 * t_out * ch * ch * k * 2 * 3 for k in res)
        t_in = t_out
    return total + 2 * t_in * (base // 2 ** len(rates)) * n_stft * 7


def _down_stride(rates, i: int) -> int:
    """The stride of stage i's source conv: the product of the later
    stages' rates."""
    s = 1
    for r in rates[i + 1:]:
        s *= r
    return s


def s3tok_flops(t_mel: int, tok: dict) -> float:
    """The S3 tokenizer on one source of ``t_mel`` 100 Hz frames: the two
    stride-2 convs, the attention blocks at 25 Hz with their FSMN memory,
    and the FSQ projection."""
    c = tok["n_state"]
    t2, t4 = t_mel // 2, t_mel // 4
    blk = 2 * t4 * (4 * c * c + 2 * c * 4 * c + c * tok["fsmn_kernel"]) + 4 * t4 * t4 * c
    return (2 * t2 * tok["n_mels"] * c * 3 + 2 * t4 * c * c * 3 + tok["n_layer"] * blk
            + 2 * t4 * c * tok["fsq_dim"])


# --------------------------------------------------------------- K3


def k3_launch(row_frames, est: dict, padded: int):
    """(bytes, flops) of one K3 launch (one UNet self-attention over both
    CFG streams): each row's valid frames attend to its valid frames; q, k
    and v read once, the output written once, in bf16, and the fp32 key
    bias of the padded length."""
    hd = est["num_heads"] * est["attention_head_dim"]
    rows = [t for t in row_frames for _ in (0, 1)]
    n_bytes = sum(4 * t * hd * 2 for t in rows) + len(rows) * padded * 4
    return n_bytes, sum(4 * t * t * hd for t in rows)
