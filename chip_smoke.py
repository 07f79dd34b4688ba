"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles every kernel of ``chatterbox_tpu_torch/csrc`` with nvcc;
  3. kernels: runs K1a, K1b, K1c+d, K2, K2b, K3, K4 and K5 at the full-width
     shapes of the TTS and VC paths (K1b, K1c+d and K2b at the default
     budget's cache length, S = 1152; K5 at T = 1024 and 2560), holds each
     against its plain PyTorch version on the same inputs (the limits are
     stated at ``OUT_RTOL``) and times the kernel, the plain version and,
     as a yardstick only, one PyTorch library call for the same function,
     each as device time from a replayed CUDA graph; then the probe kernels
     P1-P5 at the probes' own shapes, each against its plain version and
     timed the same way (``probe_kernel_phase``), K2 beside the P2/P3
     column writes;
  4. probes: the entry points of ``chatterbox_tpu_torch/probes/`` with the
     launch counters set to 0 just before and read just after: P1's four
     30-layer chains at full width, eager and as a CUDA graph, with bf16
     and with int8 weights, then P2/P3, P4 and P5 (``probe_phase``);
  5. reference: a small model with the main path's head width, through the
     port on the card against the port's plain versions on the CPU (T3 with
     dense and with int8 weights, the flow at 10 and at 4 Euler steps), and
     the full-width conditioning modules on the card against the CPU (see
     ``reference_phase`` and ``conditioning_reference`` for each comparison
     and its tolerance);
  6. the TTS paths, on ``ChatterboxTTS.from_random(seed=0)`` at full width
     (T3 and flow in bf16, HiFT and the conditioning modules in fp32), each
     ``generate_batch`` on the same 8 texts, each first call run with the
     launch counters set to 0 just before it and read just after, the wavs
     checked, and the kernels its path must (and must not) launch checked:
       A. ``max_new_tokens=250`` on seeded random conditionals: the bf16 KV
          cache (K1a, K2, K3, K4);
       B. the default ``max_new_tokens`` (1000): the int8 KV cache (K1c+d,
          K2 into the tail, K2b, K3, K4; no K1a); random weights never
          sample EOS, so T3 decodes all 1000 steps and the flow runs at
          T = 2560 mel frames;
       C. ``max_new_tokens=250, alignment=True``: the watchdog on the bf16
          cache (K1b at the alignment layer, K1a at the others);
       D. path A's call on conditionals from ``prepare_conditionals`` of a
          seeded 10 s synthetic reference WAV (timed first and warm);
       F. path A's call after ``apply_tts_precision(tts, weight_quant=True)``:
          int8 T3 weights with fused q/k/v (``bench.py``'s tts_b8_wquant);
       G. path F with ``flow_steps=4`` (tts_b8_turbo): T3's tokens and the
          wav lengths must equal F's, and the flow launches K3 exactly
          4 x 56 times;
     after each first call a second, warm call is timed (audio seconds per
     second, per stage) and a third profiled (device time by kernel, the
     busy share), except on path D, whose device work is path A's; no TTS
     path launches K5;
  7. the VC path E: ``ChatterboxVC.from_random(seed=0)`` (the same S3Gen
     weights), ``generate_batch`` of 8 seeded 3-12 s sources written as
     16 kHz WAVs, with ``target_voice_path`` the reference of path D: in
     the fused attention layout (K3 and K4, no K5), then with the UNet's
     ``to_qkv`` split into ``to_q``/``to_k``/``to_v`` (K5 in every
     transformer block at every Euler step, K4, no K3), each a first and a
     warm call, the unfused one profiled; then the two layouts' flow mels
     on one batch against each other;
  8. prints the kernel table as one JSON line (K1a-K5 and one row for each
     probe, its variants under it), the card line, and then
     ``{"ok": true, "device": {...}}`` as the last line.

Numerics: fp32 matmuls and convolutions run in full fp32 (TF32 off) so the
fp32 vocoder matches its reference arithmetic; the kernels are compared in
their working dtype (bf16).
"""

import itertools
import json
import math
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published peaks (dense): bf16 tensor cores, fp32 outside the
# tensor cores (the probes' fp32 fragments), and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# K1, K3, K4 and K5 against their plain versions in bf16 (8 significant
# bits), element by element:
#     |got - want| <= 2^-7 |want| + 2^-7 (P|v|) + 1e-5
# Both sides carry fp32 to the end and round the output once to bf16, which
# parts them by at most one bf16 ulp (<= 2^-7 |want|). K3, K4 and K5 also
# round the softmax probabilities to bf16 before the value product, the
# kernel the unnormalised ones of its online softmax and the plain version
# the normalised ones (K5's plain version, as its Pallas kernel, the
# unnormalised ones under the row's final max): each rounding moves p_i by
# at most 2^-8 of itself, so the
# two outputs part by at most 2^-7 sum_i p_i |v_i| (P|v|: the plain version
# run on |v|). K1 keeps its probabilities in fp32 on both sides, so that term
# is absent. 1e-5 covers fp32 summation order. K2 is a copy and must be exact.
OUT_RTOL = 2.0 ** -7
P_ROUND = 2.0 ** -7
FP32_ATOL = 1e-5

# full-width main-path shapes (T3 Llama-520M, flow UNet 8x64, conformer 512/8)
N_TEXTS = 8
ROWS = 2 * N_TEXTS  # CFG doubles the T3 rows and the UNet batch
MAX_NEW = 250
MAX_NEW_DEFAULT = 1000  # generate_batch's default budget: path B, the int8 cache
TAIL_W = 8
PROMPT_TOKENS = 250  # flow prompt: 250 tokens / 500 mel frames
T3_LAYERS, T3_HEADS, HEAD_DIM = 30, 16, 64
N_COND, TEXT_BUCKET, N_BOS = 34, 64, 2
FLOW_HEADS, CONF_HEADS, CONF_C = 8, 8, 512
# K5's (padded T, valid mel frames): path A's flow (250 + 250 tokens) and
# path B's (250 + 1000)
K5_T = ((1024, 1000), (2560, 2500))
TURBO_STEPS = 4  # path G's per-call flow_steps

TEXTS = [
    "The quick brown fox jumps over the lazy dog.",
    "She sells sea shells by the sea shore.",
    "A journey of a thousand miles begins with one step.",
    "Please call Stella and ask her to bring these things.",
    "The rain in Spain stays mainly in the plain.",
    "How vexingly quick daft zebras jump!",
    "Every good boy deserves fudge, they say.",
    "Speech synthesis on one card, end to end.",
]


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters, warmup=3):
    """Mean device milliseconds of one ``fn()``: ``iters`` calls captured in
    one CUDA graph, replayed once to warm and once between CUDA events. The
    replay issues no host work between launches, so the figure is the card's
    time, not the host's launch rate."""
    from chatterbox_tpu_torch.probes import graph_ms

    return graph_ms(fn, iters, warmup)


def rotating(fn, n):
    """A callable that runs fn(0), fn(1), ..., fn(n - 1), fn(0), ... on
    successive calls, so that timed launches read other memory each time,
    as the main path's launches do, and not the same lines from L2."""
    calls = itertools.count()
    return lambda: fn(next(calls) % n)


def bound(n_bytes, flops, peak_flops=PEAK_BF16_FLOPS):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_kernel(name, got, want, p_abs_v=None, exact=False):
    """Hold a kernel's output against its plain version's: equal when
    ``exact``, else within the bf16 limit above (``p_abs_v`` is P|v|, or None
    where the probabilities stay fp32). Returns (max |err|, the limit as
    text, the worst element's share of its limit)."""
    import torch

    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        fail(f"{name}: kernel output is not finite")
    diff = (got - want).abs()
    err = float(diff.max())
    if exact:
        tol, share = "exact", 0.0 if err == 0 else math.inf
    else:
        limit = OUT_RTOL * want.abs() + FP32_ATOL
        tol = "2^-7|want| + 1e-5"
        if p_abs_v is not None:
            limit = limit + P_ROUND * p_abs_v.float()
            tol = "2^-7|want| + 2^-7 P|v| + 1e-5"
        share = float((diff / limit).max())
    print(f"kernel {name}: max_abs_err={err:.3e}, worst element at {share:.3f} of its limit "
          f"|err| <= {tol}", flush=True)
    if not share <= 1.0:
        fail(f"{name}: an element exceeds its limit ({tol}) by {share:.3f}x")
    return err, tol, share


def library_err(name, got, want):
    """Max |err| of the library yardstick against the plain version: shows
    that the timed library call computes the same function."""
    import torch

    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    print(f"library {name}: max_abs_err against the plain version {err:.3e}", flush=True)
    return err


def kernel_phase():
    """Every kernel at its path's full-width shapes: check, then time."""
    import torch
    import torch.nn.functional as F

    from chatterbox_tpu_torch.ops import flash_attention as fa
    from chatterbox_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    rows = {}

    # ---- K1: decode attention, 16 CFG rows x 16 heads, mid-decode length
    s0 = N_COND + TEXT_BUCKET + N_BOS
    s_cache = -(-(s0 + MAX_NEW) // 128) * 128
    cur_len = s0 + MAX_NEW // 2
    cache = randn(T3_LAYERS, 2, ROWS, T3_HEADS, s_cache, HEAD_DIM)
    q, kn, vn = (randn(ROWS, T3_HEADS, HEAD_DIM) for _ in range(3))
    text_lens = torch.randint(20, TEXT_BUCKET, (N_TEXTS,), generator=g, device=dev)
    row_prefix = (N_COND + text_lens).repeat(2).to(torch.int32).contiguous()
    gap_end = N_COND + TEXT_BUCKET
    args = (cache, 7, cur_len, row_prefix, gap_end, q, kn, vn)
    want = fd.flash_decode_layer_attention_plain(*args)
    err, tol, share = check_kernel("flash_decode_layer_attention",
                                   fd.flash_decode_layer_attention(*args), want)
    n_valid = int((row_prefix.long() + (cur_len - gap_end)).sum()) * T3_HEADS  # (row, head, slot)
    k1_bytes = 2 * n_valid * HEAD_DIM * 2 + 4 * ROWS * T3_HEADS * HEAD_DIM * 2 + ROWS * 4
    k1_flops = 4 * (n_valid + ROWS * T3_HEADS) * HEAD_DIM
    idx = torch.arange(cur_len, device=dev)
    valid = (idx[None] < row_prefix[:, None]) | (idx[None] >= gap_end)
    # the library call takes each layer's K/V with the new token appended
    new = torch.stack([kn, vn])[None, :, :, :, None].expand(T3_LAYERS, 2, -1, -1, -1, -1)
    kv_lib = torch.cat([cache[:, :, :, :, :cur_len], new], dim=4)
    m_lib = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)[:, None, None, :]

    def k1_library(i):
        return F.scaled_dot_product_attention(q[:, :, None], kv_lib[i, 0], kv_lib[i, 1],
                                              attn_mask=m_lib)[:, :, 0]

    # each timed launch reads the next layer, as a decode step does: the 30
    # layers' live K/V (~0.4 GB) do not stay in the 50 MB L2
    rows["flash_decode_layer_attention"] = dict(
        err=err, tol=tol, share=share,
        library_err=library_err("flash_decode_layer_attention", k1_library(7), want),
        ms=timed(rotating(lambda i: fd.flash_decode_layer_attention(
            cache, i, cur_len, row_prefix, gap_end, q, kn, vn), T3_LAYERS), 300),
        plain_ms=timed(rotating(lambda i: fd.flash_decode_layer_attention_plain(
            cache, i, cur_len, row_prefix, gap_end, q, kn, vn), T3_LAYERS), 60),
        library_ms=timed(rotating(k1_library, T3_LAYERS), 300),
        bound=bound(k1_bytes, k1_flops),
    )
    del kv_lib

    # ---- K2: per-step append of all 30 layers' K/V at one slot
    new_kv = randn(T3_LAYERS, 2, ROWS, T3_HEADS, HEAD_DIM)
    c_kernel, c_plain = cache.clone(), cache.clone()
    fd.kv_cache_append(c_kernel, new_kv, cur_len)
    fd.kv_cache_append_plain(c_plain, new_kv, cur_len)
    err, tol, share = check_kernel("kv_cache_append", c_kernel, c_plain, exact=True)
    c_lib = cache.clone()
    c_lib.index_copy_(4, torch.tensor([cur_len], device=dev), new_kv[:, :, :, :, None])
    lib_err = library_err("kv_cache_append", c_lib, c_plain)
    del c_plain, c_lib
    # each timed launch writes the next decode step's slot
    pos = [s0 + i for i in range(MAX_NEW)]
    pos_idx = [torch.tensor([p], device=dev) for p in pos]
    rows["kv_cache_append"] = dict(
        err=err, tol=tol, share=share, library_err=lib_err,
        ms=timed(rotating(lambda i: fd.kv_cache_append(c_kernel, new_kv, pos[i]), MAX_NEW), 500),
        plain_ms=timed(rotating(lambda i: fd.kv_cache_append_plain(c_kernel, new_kv, pos[i]),
                                MAX_NEW), 500),
        library_ms=timed(rotating(lambda i: c_kernel.index_copy_(
            4, pos_idx[i], new_kv[:, :, :, :, None]), MAX_NEW), 500),
        bound=bound(2 * new_kv.numel() * 2, 0),
    )
    del cache, c_kernel

    # ---- K1b, K1c+d, K2b: 16 CFG rows at the default budget's cache length
    # (S = 1152), mid-decode; each timed launch reads the next layer at the
    # next of 8 live lengths (tails of 1-7 slots and 0), as decode steps do
    s_1000 = -(-(s0 + MAX_NEW_DEFAULT) // 128) * 128
    c_mid = s0 + MAX_NEW_DEFAULT // 2 + 1  # 601: merge_base 600, a tail of 1
    curs = [c_mid + j for j in range(TAIL_W)]
    kv = randn(T3_LAYERS, 2, ROWS, T3_HEADS, s_1000, HEAD_DIM)  # the bf16 cache
    cache8, scales = fd.quantize_kv(kv)
    # each decode step's tail: the bf16 slots from its merge_base on
    tails = {mb: kv[:, :, :, :, mb:mb + TAIL_W].contiguous() for mb in {c // TAIL_W * TAIL_W
                                                                        for c in curs}}

    def live(cur):
        """(valid int8 slots, valid tail slots) over all rows at cur_len cur."""
        mb = cur // TAIL_W * TAIL_W
        idx = torch.arange(cur, device=dev)
        valid = (idx[None] < row_prefix[:, None]) | (idx[None] >= gap_end)
        return int(valid[:, :mb].sum()), int(valid[:, mb:].sum())

    def step_args(i):
        return i % T3_LAYERS, curs[i % TAIL_W]

    rows_h = ROWS * T3_HEADS
    vec_bytes = 4 * rows_h * HEAD_DIM * 2 + ROWS * 4  # q, k_new, v_new, out; row_prefix

    def mean_bound(bytes_of, flops_of):
        b = [bound(bytes_of(c), flops_of(c)) for c in curs]
        return sum(x[0] for x in b) / len(b), b[0][1]

    def k1_flops(c):
        return 4 * (sum(live(c)) * T3_HEADS + rows_h) * HEAD_DIM

    # the library call for K1b and K1c+d, at cur_len c_lib over the layers,
    # on a bf16 K/V with the new token appended, prepared outside the timing
    c_lib = curs[TAIL_W // 2]
    idx = torch.arange(c_lib, device=dev)
    valid = (idx[None] < row_prefix[:, None]) | (idx[None] >= gap_end)
    m_lib = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)[:, None, None, :]

    def sdpa_library(kv_src):
        new = torch.stack([kn, vn])[None, :, :, :, None].expand(T3_LAYERS, 2, -1, -1, -1, -1)
        kv_lib = torch.cat([kv_src[:, :, :, :, :c_lib], new], dim=4)
        return kv_lib, lambda i: F.scaled_dot_product_attention(
            q[:, :, None], kv_lib[i, 0], kv_lib[i, 1], attn_mask=m_lib)[:, :, 0]

    # K1b: K1a plus (m, l) on the bf16 cache; m and l are held to fp32
    # summation order: m is one scaled dot of 64 terms (1e-5 |m| + 1e-5), l
    # sums ~600 positive terms each off by m's error (2 n 2^-24 < 1e-4 |l|)
    args = (kv, 7, c_mid + 3, row_prefix, gap_end, q, kn, vn)
    out, m, l = fd.flash_decode_layer_attention_stats(*args)
    want, want_m, want_l = fd.flash_decode_layer_attention_stats_plain(*args)
    err, tol, share = check_kernel("flash_decode_layer_attention_stats", out, want)
    m_share = float(((m - want_m).abs() / (1e-5 * want_m.abs() + 1e-5)).max())
    l_share = float(((l - want_l).abs() / (1e-4 * want_l)).max())
    print(f"kernel flash_decode_layer_attention_stats: m at {m_share:.3f} of |err| <= "
          f"1e-5|m| + 1e-5, l at {l_share:.3f} of |err| <= 1e-4|l|", flush=True)
    if not (m_share <= 1.0 and l_share <= 1.0):
        fail("flash_decode_layer_attention_stats: m or l exceeds its limit")
    kv_lib, lib = sdpa_library(kv)
    lib_err = library_err("flash_decode_layer_attention_stats", lib(7),
                          fd.flash_decode_layer_attention_plain(kv, 7, c_lib, row_prefix, gap_end,
                                                                q, kn, vn))
    rows["flash_decode_layer_attention_stats"] = dict(
        err=err, tol=tol + "; m 1e-5|m| + 1e-5, l 1e-4|l|", share=max(share, m_share, l_share),
        library_err=lib_err,
        ms=timed(rotating(lambda i: fd.flash_decode_layer_attention_stats(
            kv, *step_args(i), row_prefix, gap_end, q, kn, vn), T3_LAYERS * TAIL_W), 240),
        plain_ms=timed(rotating(lambda i: fd.flash_decode_layer_attention_stats_plain(
            kv, *step_args(i), row_prefix, gap_end, q, kn, vn), T3_LAYERS * TAIL_W), 60),
        library_ms=timed(rotating(lib, T3_LAYERS), 300),
        library_note="SDPA gives no (m, l)",
        bound=mean_bound(lambda c: 2 * sum(live(c)) * T3_HEADS * HEAD_DIM * 2 + vec_bytes
                         + rows_h * 8, k1_flops),
    )
    # K1a at the same live lengths, for the int8 kernel's comparison
    k1a_same_ms = timed(rotating(lambda i: fd.flash_decode_layer_attention(
        kv, *step_args(i), row_prefix, gap_end, q, kn, vn), T3_LAYERS * TAIL_W), 240)
    del kv_lib

    # K1c+d: the int8 cache below merge_base, the bf16 tail from there on;
    # the main cache slots at and past merge_base are never read
    def k1c(i, fn=fd.flash_decode_layer_attention_int8):
        layer, cur = step_args(i)
        mb = cur // TAIL_W * TAIL_W
        return fn(cache8, scales, tails[mb], mb, layer, cur, row_prefix, gap_end, q, kn, vn)

    want = k1c(TAIL_W // 2, fd.flash_decode_layer_attention_int8_plain)  # layer 4 at c_lib
    err, tol, share = check_kernel("flash_decode_layer_attention_int8", k1c(TAIL_W // 2), want)
    deq = (cache8.float() * scales[..., None]).to(bf)  # the library's input, made once
    mb_lib = c_lib // TAIL_W * TAIL_W
    deq[:, :, :, :, mb_lib:mb_lib + TAIL_W] = tails[mb_lib]
    kv_lib, lib = sdpa_library(deq)
    del deq
    lib_err = library_err("flash_decode_layer_attention_int8", lib(TAIL_W // 2), want)
    rows["flash_decode_layer_attention_int8"] = dict(
        err=err, tol=tol, share=share, library_err=lib_err,
        ms=timed(rotating(k1c, T3_LAYERS * TAIL_W), 240),
        plain_ms=timed(rotating(lambda i: k1c(i, fd.flash_decode_layer_attention_int8_plain),
                                T3_LAYERS * TAIL_W), 60),
        library_ms=timed(rotating(lib, T3_LAYERS), 300),
        library_note="SDPA over a dequantized bf16 copy made outside the timing",
        k1a_ms_same_live_lengths=k1a_same_ms,
        bound=mean_bound(lambda c: 2 * T3_HEADS * HEAD_DIM * (live(c)[0] + 2 * live(c)[1])
                         + 2 * T3_HEADS * 4 * live(c)[0] + vec_bytes, k1_flops),
    )
    print(f"kernel flash_decode_layer_attention_int8: "
          f"{rows['flash_decode_layer_attention_int8']['ms']:.5f} ms against K1a's "
          f"{k1a_same_ms:.5f} ms at the same live lengths {curs[0]}-{curs[-1]}", flush=True)
    del kv_lib

    # K2b: every 8th step's merge of the full tail into the int8 cache (the
    # prefill takes the same kernel with n = s0 tokens); bit-exact
    tail = next(iter(tails.values()))
    merge_pos = [s0 // TAIL_W * TAIL_W + TAIL_W * j for j in range(MAX_NEW_DEFAULT // TAIL_W)]
    a = (cache8.clone(), scales.clone())
    b = (cache8.clone(), scales.clone())
    fd.kv_cache_quantize_write(*a, tail, merge_pos[7])
    fd.kv_cache_quantize_write_plain(*b, tail, merge_pos[7])
    err, tol, share = check_kernel("kv_cache_quantize_write", a[0], b[0], exact=True)
    check_kernel("kv_cache_quantize_write (scales)", a[1], b[1], exact=True)
    del a, b
    n_tok = tail.numel() // HEAD_DIM
    rows["kv_cache_quantize_write"] = dict(
        err=err, tol=tol, share=share, library_err=None,
        ms=timed(rotating(lambda i: fd.kv_cache_quantize_write(cache8, scales, tail, merge_pos[i]),
                          len(merge_pos)), 125),
        plain_ms=timed(rotating(lambda i: fd.kv_cache_quantize_write_plain(
            cache8, scales, tail, merge_pos[i]), len(merge_pos)), 125),
        library_ms=None, library_note="no single PyTorch call quantizes per token",
        bound=bound(n_tok * (HEAD_DIM * 2 + HEAD_DIM + 4), 4 * n_tok * HEAD_DIM),
    )
    del cache8, scales, tails, tail

    # ---- K3: UNet self-attention from packed qkv, 16 CFG rows, mel length
    t_mel = 2 * (PROMPT_TOKENS + MAX_NEW)
    tp = -(-t_mel // 128) * 128
    hd = FLOW_HEADS * HEAD_DIM
    qkv = randn(ROWS, tp, 3 * hd)
    key_valid = torch.arange(tp, device=dev)[None] < t_mel
    key_bias = torch.where(key_valid, 0.0, -1.0e10).expand(ROWS, tp).contiguous().float()
    want = fa.flash_self_attention_packed_plain(qkv, key_bias, FLOW_HEADS)
    qkv_abs_v = torch.cat([qkv[..., :2 * hd], qkv[..., 2 * hd:].abs()], dim=-1)
    err, tol, share = check_kernel(
        "flash_self_attention_packed", fa.flash_self_attention_packed(qkv, key_bias, FLOW_HEADS),
        want, fa.flash_self_attention_packed_plain(qkv_abs_v, key_bias, FLOW_HEADS))
    del qkv_abs_v
    qh, kh, vh = (qkv[..., i * hd:(i + 1) * hd].unflatten(-1, (FLOW_HEADS, HEAD_DIM)).transpose(1, 2)
                  for i in range(3))
    bias4 = key_bias[:, None, None, :].to(bf)

    def k3_library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=bias4)

    k3_flops = 4 * ROWS * FLOW_HEADS * tp * tp * HEAD_DIM
    k3_bytes = qkv.numel() * 2 + key_bias.numel() * 4 + ROWS * tp * hd * 2
    rows["flash_self_attention_packed"] = dict(
        err=err, tol=tol, share=share,
        library_err=library_err("flash_self_attention_packed",
                                k3_library().transpose(1, 2).flatten(2), want),
        ms=timed(lambda: fa.flash_self_attention_packed(qkv, key_bias, FLOW_HEADS), 50),
        plain_ms=timed(lambda: fa.flash_self_attention_packed_plain(qkv, key_bias, FLOW_HEADS), 10),
        library_ms=timed(k3_library, 50),
        bound=bound(k3_bytes, k3_flops),
    )
    del qkv, qh, kh, vh

    # ---- K5: the same attention on (B, H, T, D) q, k, v (the UNet's unfused
    # layout), at path A's T and path B's; each timed launch reads the next
    # of enough input sets to pass 4x the 50 MB L2
    k5_runs = []
    for t_pad, t_valid in K5_T:
        set_bytes = 3 * ROWS * FLOW_HEADS * t_pad * HEAD_DIM * 2
        n_sets = max(2, -(-200 * 2**20 // set_bytes))
        sets = [tuple(randn(ROWS, FLOW_HEADS, t_pad, HEAD_DIM) for _ in range(3))
                for _ in range(n_sets)]
        bias5 = torch.where(torch.arange(t_pad, device=dev)[None] < t_valid, 0.0, -1.0e10)
        bias5 = bias5.expand(ROWS, t_pad).contiguous().float()
        q5, k5, v5 = sets[0]
        want = fa.flash_self_attention_plain(q5, k5, v5, bias5)
        err, tol, share = check_kernel(f"flash_self_attention (T = {t_pad})",
                                       fa.flash_self_attention(q5, k5, v5, bias5), want,
                                       fa.flash_self_attention_plain(q5, k5, v5.abs(), bias5))
        bias5_4 = bias5[:, None, None, :].to(bf)
        lib_err = library_err(f"flash_self_attention (T = {t_pad})",
                              F.scaled_dot_product_attention(q5, k5, v5, attn_mask=bias5_4), want)
        del want
        iters = 50 if t_pad <= 1024 else 10
        k5_runs.append(dict(
            err=err, tol=tol, share=share, library_err=lib_err, n_sets=n_sets,
            ms=timed(rotating(lambda i: fa.flash_self_attention(*sets[i], bias5), n_sets), iters),
            plain_ms=timed(rotating(lambda i: fa.flash_self_attention_plain(*sets[i], bias5),
                                    n_sets), max(2, iters // 5)),
            library_ms=timed(rotating(lambda i: F.scaled_dot_product_attention(
                *sets[i], attn_mask=bias5_4), n_sets), iters),
            bound=bound(set_bytes * 4 // 3 + bias5.numel() * 4,
                        4 * ROWS * FLOW_HEADS * t_pad * t_pad * HEAD_DIM),
        ))
        del sets, q5, k5, v5
        torch.cuda.empty_cache()
    # the row holds path A's T (as K3's row), path B's beside it
    (t_a, _), (t_b, _) = K5_T
    short, long = k5_runs
    rows["flash_self_attention"] = dict(
        short, err=max(short["err"], long["err"]), share=max(short["share"], long["share"]),
        library_err=max(short["library_err"], long["library_err"]),
        extra={"T": t_a, f"ms_t{t_b}": long["ms"], f"plain_ms_t{t_b}": long["plain_ms"],
               f"library_ms_t{t_b}": long["library_ms"], f"bound_ms_t{t_b}": long["bound"][0],
               f"max_abs_err_t{t_b}": long["err"], f"err_share_of_tol_t{t_b}": long["share"],
               "input_sets": {str(t_a): short["n_sets"], str(t_b): long["n_sets"]}},
    )

    # ---- K4: conformer rel-pos attention, 8 rows, the 50 Hz (upsampled) layers
    t_conf = tp
    cd = CONF_C
    dk = cd // CONF_HEADS
    q_u, k, v = (randn(N_TEXTS, t_conf, cd, scale=0.5) for _ in range(3))
    q_hat = randn(N_TEXTS, t_conf, CONF_HEADS * cd, scale=0.5)
    s_hat = randn(1, t_conf, cd, scale=0.7)
    bias = key_bias[:N_TEXTS].contiguous()
    scale = 1.0 / math.sqrt(dk)
    kargs = (q_u, q_hat, k, s_hat, v, bias, CONF_HEADS, scale)
    want = fa.flash_relpos_attention_plain(*kargs)
    err, tol, share = check_kernel(
        "flash_relpos_attention", fa.flash_relpos_attention(*kargs), want,
        fa.flash_relpos_attention_plain(q_u, q_hat, k, s_hat, v.abs(), bias, CONF_HEADS, scale))

    # the library call: one SDPA of depth dk + C on q = [q_u_h, qhat_h] and
    # k = [k_h, shat], whose q.k^T is q_u.k^T + qhat.shat^T
    def heads(x, n):
        return x.unflatten(-1, (CONF_HEADS, n)).transpose(1, 2)

    q_cat = torch.cat([heads(q_u, dk), heads(q_hat, cd)], dim=-1)
    s_heads = s_hat[:, None].expand(N_TEXTS, CONF_HEADS, t_conf, cd)
    k_cat = torch.cat([heads(k, dk), s_heads], dim=-1)
    v_h, bias4 = heads(v, dk), bias[:, None, None, :].to(bf)

    def k4_library():
        return F.scaled_dot_product_attention(q_cat, k_cat, v_h, attn_mask=bias4, scale=scale)

    k4_flops = 2 * N_TEXTS * CONF_HEADS * t_conf * t_conf * (2 * dk + cd)
    k4_bytes = (4 * q_u.numel() + q_hat.numel() + s_hat.numel()) * 2 + bias.numel() * 4
    rows["flash_relpos_attention"] = dict(
        err=err, tol=tol, share=share,
        library_err=library_err("flash_relpos_attention",
                                k4_library().transpose(1, 2).flatten(2), want),
        ms=timed(lambda: fa.flash_relpos_attention(*kargs), 50),
        plain_ms=timed(lambda: fa.flash_relpos_attention_plain(*kargs), 10),
        library_ms=timed(k4_library, 50),
        bound=bound(k4_bytes, k4_flops),
    )
    torch.cuda.synchronize()
    return rows


def _share(got, want, limit):
    """The worst element's share of its limit (0 where both are 0)."""
    import torch

    diff = (got.float() - want.float()).abs()
    return float(torch.where(diff == 0, torch.zeros_like(diff), diff / limit).max())


def probe_kernel_phase():
    """P1-P5 at the probes' own shapes (``chatterbox_tpu_torch/probes/``):
    each kernel against its plain version (the copies and P4's store bit
    for bit, the sums within the probes' stated limits), then timed with
    its plain version and, where one PyTorch call computes the same
    function, that call. P2 and P3 time each variant as the scripts do: a
    chain of 30 writes at slot 200, here in one CUDA graph; K2 writes the
    same column into the port's (S, D) cache beside them. Returns one row
    per probe, its variants under it."""
    import torch

    from chatterbox_tpu_torch.ops import flash_decode as fd
    from chatterbox_tpu_torch.ops import probes as pk
    from chatterbox_tpu_torch.probes import cache_write, int8_cache, ops

    dev = torch.device("cuda")
    rows = {}

    # ---- P1: the copy of q (16 CFG rows x 16 heads x 64) in each layer's
    # attention slot
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((ROWS, T3_HEADS, HEAD_DIM), generator=g, device=dev).to(torch.bfloat16)
    err, tol, share = check_kernel("noop_copy", pk.noop_copy(q), pk.noop_copy_plain(q), exact=True)
    rows["P1"] = dict(
        name="noop_copy", err=err, tol=tol, share=share, library_err=0.0,
        ms=timed(lambda: pk.noop_copy(q), 500), plain_ms=timed(lambda: pk.noop_copy_plain(q), 500),
        library_ms=timed(lambda: q.clone(), 500),
        library_note="q.clone(), which is also the plain version",
        bound=bound(2 * q.numel() * 2, 0),
    )

    # ---- P2, P3: one column into the (30, 2, 16, 16, 64, 384) bf16 cache
    cache, new = cache_write.make_inputs(dev)
    pos = cache_write.POS
    want = pk.cache_column_write_plain(cache.clone(), new, pos)
    pos_idx = torch.tensor([pos], device=dev)
    lib_err = library_err("cache column write", cache.clone().index_copy_(5, pos_idx, new), want)
    col_bound = bound(2 * new.numel() * 2, 0)  # the column read once and written once
    plain_ms = timed(lambda: pk.cache_column_write_plain(cache, new, pos), cache_write.CHAIN)
    library_ms = timed(lambda: cache.index_copy_(5, pos_idx, new), cache_write.CHAIN)
    sd = cache.transpose(-1, -2).contiguous()
    new_sd = new[..., 0].contiguous()
    got = fd.kv_cache_append(sd.clone(), new_sd, pos)
    k2_err, _, _ = check_kernel("kv_cache_append (P2/P3 shapes, (S, D))", got,
                                fd.kv_cache_append_plain(sd.clone(), new_sd, pos), exact=True)
    k2 = {"layout": "(S, D)", "ms": timed(lambda: fd.kv_cache_append(sd, new_sd, pos),
                                           cache_write.CHAIN),
          "bound_ms": col_bound[0], "max_abs_err": k2_err}
    del sd, got
    for script, headline in (("P2", "rmw b_blk=8 kvsep"), ("P3", "col b_blk=16")):
        variants = {}
        for (sc, name), var in cache_write.VARIANTS.items():
            if sc != script:
                continue
            err, _, _ = check_kernel(f"{script} {name}",
                                     cache_write.write(cache.clone(), new, pos, var), want,
                                     exact=True)
            variants[name] = {
                "ms": timed(lambda v=var: cache_write.write(cache, new, pos, v), cache_write.CHAIN),
                "max_abs_err": err, "moved_bytes": cache_write.moved_bytes(var, cache.shape)}
        variants["K2 kv_cache_append on (S, D), beside"] = k2
        h = variants[headline]
        rows[script] = dict(
            name="cache_column_write" if headline.startswith("col") else "cache_block_rmw",
            headline_variant=headline, err=max(v["max_abs_err"] for v in variants.values()),
            tol="exact", share=0.0, library_err=lib_err, ms=h["ms"], plain_ms=plain_ms,
            library_ms=library_ms, library_note="index_copy_ of the column",
            bound=col_bound, variants=variants)
    del cache, new, want
    torch.cuda.empty_cache()

    # ---- P4: the six int8 fragments; bytes each case reads and writes
    ins = int8_cache.inputs(dev)
    sb, pd = pk.SB, pk.PD
    io_bytes = {"i8_load_convert": (pd * pd, 4 * pd * pd),
                "i8_dequant_matmul": (pd * sb + 4 * sb + 4 * pd, 4 * pd),
                "i8_pv": (4 * sb + pd * sb, 4 * pd), "i8_matmul_direct": (pd * sb + 4 * pd, 4 * pd),
                "i8_store": (4 * 8 * sb, 8 * sb), "i8_sd_tail": (8 * pd + 4 * pd, 4 * pd)}
    flops = {"i8_load_convert": pd * pd, "i8_dequant_matmul": 3 * pd * sb, "i8_pv": 2 * pd * sb,
             "i8_matmul_direct": 2 * pd * sb, "i8_store": 8 * sb, "i8_sd_tail": 2 * 8 * pd}
    variants = {}
    for case in pk.INT8_CASES:
        got, want = pk.int8_probe(case, *ins), pk.int8_probe_plain(case, *ins)
        lim, tol = int8_cache.limit(case, ins)
        if lim is None:
            err, tol, share = check_kernel(f"int8_probe {case}", got, want, exact=True)
        else:
            torch.cuda.synchronize()
            err, share = float((got - want).abs().max()), _share(got, want, lim)
            print(f"kernel int8_probe {case}: max_abs_err={err:.3e}, worst element at "
                  f"{share:.3f} of its limit |err| <= {tol}", flush=True)
            if not share <= 1.0:
                fail(f"int8_probe {case}: an element exceeds its limit ({tol}) by {share:.3f}x")
        variants[case] = {
            "ms": timed(lambda c=case: pk.int8_probe(c, *ins), 200),
            "plain_ms": timed(lambda c=case: pk.int8_probe_plain(c, *ins), 200),
            "bound_ms": bound(sum(io_bytes[case]), flops[case], PEAK_FP32_FLOPS)[0],
            "max_abs_err": err, "tol": tol, "err_share_of_tol": share}
    rows["P4"] = _case_row("int8_probe", "i8_dequant_matmul", variants, io_bytes, flops)

    # ---- P5: the nine online-softmax fragments from a zero scratch
    x, v = ops.inputs(dev)
    scr0 = torch.zeros((1, pd), device=dev)
    io_bytes, flops = {}, {}
    for case in pk.SOFTMAX_CASES:
        x_bytes = 4 * (pd if case[0] in "HI" else sb)  # row 0 of x, or its first 64
        v_bytes = 4 * sb * pd if case[0] in "AEGHI" else 0
        io_bytes[case] = (x_bytes + v_bytes + (4 * pd if case[0] == "H" else 0), 4 * pd)
        flops[case] = 2 * 2 * sb * pd * (2 if case[0] in "HI" else 1 if v_bytes else 0) + 4 * sb
    variants = {}
    for case in pk.SOFTMAX_CASES:
        got, want = pk.softmax_probe(case, x, v, scr0), pk.softmax_probe_plain(case, x, v, scr0)
        lim, tol = ops.limit(case, x, v, scr0)
        torch.cuda.synchronize()
        err, share = float((got - want).abs().max()), _share(got, want, lim)
        print(f"kernel softmax_probe {case}: max_abs_err={err:.3e}, worst element at "
              f"{share:.3f} of its limit |err| <= {tol}", flush=True)
        if not (bool(torch.isfinite(got).all()) and share <= 1.0):
            fail(f"softmax_probe {case}: an element exceeds its limit ({tol}) by {share:.3f}x")
        variants[case] = {
            "ms": timed(lambda c=case: pk.softmax_probe(c, x, v, scr0), 200),
            "plain_ms": timed(lambda c=case: pk.softmax_probe_plain(c, x, v, scr0), 200),
            "bound_ms": bound(sum(io_bytes[case]), flops[case], PEAK_FP32_FLOPS)[0],
            "max_abs_err": err, "tol": tol, "err_share_of_tol": share}
    rows["P5"] = _case_row("softmax_probe", "H_dotgen_transpose_rhs", variants, io_bytes, flops)
    torch.cuda.synchronize()
    return rows


def _case_row(name, headline, variants, io_bytes, flops):
    """A P4/P5 row: the headline case's numbers, every case under it."""
    h = variants[headline]
    return dict(name=name, headline_variant=headline,
                err=max(c["max_abs_err"] for c in variants.values()),
                tol=h["tol"], share=max(c["err_share_of_tol"] for c in variants.values()),
                library_err=None, ms=h["ms"], plain_ms=h["plain_ms"], library_ms=None,
                library_note="no single PyTorch call computes a case",
                bound=bound(sum(io_bytes[headline]), flops[headline], PEAK_FP32_FLOPS),
                variants=variants)


def probe_phase(card):
    """The probes' entry points on the card, the launch counters set to 0
    just before and read just after: P1 (``probes.boundary``: the four
    30-layer chains at full width, eager and as a CUDA graph, with bf16 and
    with int8 weights), then P2/P3, P4 and P5 (each checks its kernels
    against their plain versions and times them). Prints P1's results as
    one JSON line and the rest as another; fails if a probe kernel was not
    launched. Returns (results, counts)."""
    import torch

    from chatterbox_tpu_torch.ops import PROBE_KERNELS, launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.probes import boundary, cache_write, int8_cache, ops

    dev = torch.device("cuda")
    reset_launch_counts()
    p1 = {"bf16": boundary.run(dev), "int8": boundary.run(dev, wquant=True)}
    rest = {"P2/P3": cache_write.run(dev), "P4": int8_cache.run(dev), "P5": ops.run(dev)}
    torch.cuda.synchronize()
    counts = launch_counts()
    print("probe P1: " + json.dumps({"card": card, **p1}), flush=True)
    print("probe P2-P5: " + json.dumps({"card": card, **rest}), flush=True)
    print("probe phase: kernel launches " + json.dumps(counts), flush=True)
    for k in PROBE_KERNELS:
        if counts[k] <= 0:
            fail(f"probe phase: kernel {k} was not launched")
    return {"P1": p1, **rest}, counts


KERNEL_INFO = {
    "flash_decode_layer_attention": (
        "chatterbox_tpu_torch/csrc/flash_decode.cu",
        "chatterbox_tpu/ops/flash_decode.py:361",
    ),
    "flash_decode_layer_attention_stats": (
        "chatterbox_tpu_torch/csrc/flash_decode.cu",
        "chatterbox_tpu/ops/flash_decode.py:361 (return_stats, :260-270, :525-553)",
    ),
    "flash_decode_layer_attention_int8": (
        "chatterbox_tpu_torch/csrc/flash_decode.cu",
        "chatterbox_tpu/ops/flash_decode.py:361 (int8 cache + tail, :109-140, :204-256)",
    ),
    "kv_cache_append": (
        "chatterbox_tpu_torch/csrc/flash_decode.cu",
        "chatterbox_tpu/ops/flash_decode.py:299",
    ),
    "kv_cache_quantize_write": (
        "chatterbox_tpu_torch/csrc/flash_decode.cu",
        "chatterbox_tpu/ops/flash_decode.py:299 (int8 columns after quantize_kv, "
        "chatterbox_tpu/models/t3/llama.py:632-646)",
    ),
    "flash_self_attention_packed": (
        "chatterbox_tpu_torch/csrc/flash_attention.cu",
        "chatterbox_tpu/ops/flash_attention.py:126",
    ),
    "flash_relpos_attention": (
        "chatterbox_tpu_torch/csrc/flash_attention.cu",
        "chatterbox_tpu/ops/flash_attention.py:267",
    ),
    "flash_self_attention": (
        "chatterbox_tpu_torch/csrc/flash_attention.cu",
        "chatterbox_tpu/ops/flash_attention.py:172",
    ),
    "P1": ("chatterbox_tpu_torch/csrc/probes.cu",
           "scripts/probe_boundary.py:120 (_noop, :114-122)"),
    "P2": ("chatterbox_tpu_torch/csrc/probes.cu",
           "scripts/probe_cache_write2.py:67 (make_rmw, :30-78), :103 (make_col, :81-114)"),
    "P3": ("chatterbox_tpu_torch/csrc/probes.cu",
           "scripts/probe_cache_write3.py:48 (make_col, :27-59), :86 (make_rmw, :62-97)"),
    "P4": ("chatterbox_tpu_torch/csrc/probes.cu",
           "scripts/probe_int8_cache.py:41 (run_case, :39-58; cases :61-97)"),
    "P5": ("chatterbox_tpu_torch/csrc/probes.cu",
           "scripts/probe_ops.py:26 (run_case, :22-41; cases A-I :45-144)"),
}


def reference_phase():
    """A small model with the main path's head width (64), run through the
    port on the card and, as the reference, through the port's plain
    versions on the CPU in fp32, on the same weights and inputs:
      - T3 in fp32 (K1 and K2 take fp32): tokens and lengths must be equal,
        greedy and with injected uniforms, on the bf16 path's kernels (K1a,
        K2), with the int8 cache (K1c+d, K2, K2b) and with the alignment
        watchdog (K1b at layer 1, K1a, K2);
      - the flow in bf16 on the card against fp32 on the CPU, from the same
        bf16 weights and noise, in the fused UNet attention layout (K3, K4)
        and the unfused one (K5, K4): relative L2 error of the mel within
        5e-2 each (8-bit mantissas compounding through ~20 layers and 10
        Euler steps);
      - HiFT (fp32 on both, TF32 off) on the card's mel, zero noise:
        max |err| within 2e-3 (the JAX package's decode tolerance);
      - the watermark on the card's wav: max |err| within 1e-4."""
    from dataclasses import replace

    import numpy as np
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.core.sampling import SamplingConfig
    from chatterbox_tpu_torch.models.s3gen.conformer import ConformerConfig
    from chatterbox_tpu_torch.models.s3gen.flow import FlowConfig, flow_inference
    from chatterbox_tpu_torch.models.s3gen.hifigan import HiFTConfig, hift_generate
    from chatterbox_tpu_torch.models.s3gen.unet import UNetConfig
    from chatterbox_tpu_torch.models.t3.llama import (LlamaConfig, fuse_qkv_params,
                                                      quantize_llama_weights)
    from chatterbox_tpu_torch.models.t3.t3 import T3Config, t3_generate
    from chatterbox_tpu_torch.models.watermark import SpreadSpectrumWatermarker

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(0)

    # ---- T3, 2 layers of width 256, 4 heads of 64; fp32 on both sides
    t3_cfg = T3Config(alignment_layer=1,
                      llama=LlamaConfig(hidden_size=256, intermediate_size=512,
                                        num_hidden_layers=2, num_attention_heads=4,
                                        num_key_value_heads=4, head_dim=64))
    p_cpu = weights.init_t3(t3_cfg, seed=3)
    p_dev = weights.tree_to(p_cpu, dev)
    b, max_new = 2, 40
    lens = np.array([20, 13], np.int32)
    text = np.zeros((b, 32), np.int32)
    for i, n in enumerate(lens):
        text[i, :n] = [255] + list(rng.integers(1, 700, n - 2)) + [0]
    cond = (rng.standard_normal((b, 256)).astype(np.float32),
            rng.integers(0, 6561, (b, 150)).astype(np.int32), np.full((b,), 0.5, np.float32))
    uniforms = rng.random((max_new, b)).astype(np.float32)
    # the int8 weights of apply_tts_precision(weight_quant=True), fused
    # q/k/v, quantized on the CPU; how many values the card's own
    # quantization gives otherwise is printed
    q_cpu = {**p_cpu, "llama": quantize_llama_weights(fuse_qkv_params(p_cpu["llama"]))}
    q_dev = weights.tree_to(q_cpu, dev)
    on_card = quantize_llama_weights(fuse_qkv_params(p_dev["llama"]))["layers"]
    n_diff = sum(int((x.cpu() != q_cpu["llama"]["layers"][name][leaf]).sum())
                 for name, wp in on_card.items() for leaf, x in wp.items())
    print(f"reference: int8 T3 weights quantized on the card: {n_diff} values differ from the "
          f"CPU's", flush=True)
    for weights_kind, (pd, pc) in (("dense", (p_dev, p_cpu)), ("int8", (q_dev, q_cpu))):
        for variant in ({}, {"cache_quant": True}, {"alignment": True}):
            for greedy in (True, False):
                out = []
                for p, d in ((pd, dev), (pc, cpu)):
                    args = [torch.from_numpy(x).to(d) for x in (text, lens, *cond)]
                    res = t3_generate(p, t3_cfg, *args, SamplingConfig(greedy=greedy), max_new,
                                      uniforms=torch.from_numpy(uniforms).to(d), **variant)
                    out.append((res.tokens.cpu(), res.lengths.cpu()))
                if not (torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])):
                    fail(f"reference: T3 tokens on the card differ from the CPU ({weights_kind} "
                         f"weights, {variant}, greedy={greedy})")
            print(f"reference: T3 fp32 tokens equal to the CPU's, greedy and sampled "
                  f"({weights_kind} weights, "
                  f"{json.dumps(variant) if variant else 'K1a/K2'})", flush=True)

    # ---- flow: conformer 128 wide, 2 heads of 64; UNet 2 heads of 64
    flow_cfg = FlowConfig(
        input_size=128,
        encoder=ConformerConfig(input_size=128, output_size=128, attention_heads=2,
                                linear_units=256, num_blocks=2, num_up_blocks=1),
        estimator=UNetConfig(channels=64, n_blocks=1, num_mid_blocks=2, num_heads=2),
    )
    flow_bf16 = weights.init_flow(flow_cfg, seed=4, device="cpu", dtype=torch.bfloat16)
    n_tok, n_prompt = 48, 30
    inputs = (rng.integers(0, 6561, (b, n_tok)).astype(np.int32),
              np.array([n_tok, 35], np.int32),
              rng.integers(0, 6561, (b, n_prompt)).astype(np.int32),
              np.full((b,), n_prompt, np.int32),
              (rng.standard_normal((b, 2 * n_prompt, 80)) * 0.5 - 4).astype(np.float32),
              rng.standard_normal((b, 192)).astype(np.float32),
              rng.standard_normal((b, 2 * (n_tok + n_prompt), 80)).astype(np.float32))
    # the default 10 Euler steps, and path G's 4
    turbo_cfg = replace(flow_cfg, n_timesteps=TURBO_STEPS)
    mels = {}
    for layout, d, dt, cfg in (("fused", dev, torch.bfloat16, flow_cfg),
                               ("unfused", dev, torch.bfloat16, flow_cfg),
                               ("cpu", cpu, torch.float32, flow_cfg),
                               ("fused, 4 steps", dev, torch.bfloat16, turbo_cfg),
                               ("cpu, 4 steps", cpu, torch.float32, turbo_cfg)):
        p = weights.tree_to(flow_bf16, d, dt)
        if layout == "unfused":
            p = weights.split_unet_qkv(p)
        mel, _ = flow_inference(p, cfg, *(torch.from_numpy(x).to(d) for x in inputs))
        mels[layout] = mel.float().cpu()
    for layout, ref in (("fused", "cpu"), ("unfused", "cpu"), ("fused, 4 steps", "cpu, 4 steps")):
        valid = [mels[ref][i, : 2 * (n_prompt + int(inputs[1][i]))] for i in range(b)]
        got = [mels[layout][i, : len(v)] for i, v in enumerate(valid)]
        rel = max(float((g - v).norm() / v.norm()) for g, v in zip(got, valid))
        print(f"reference: flow mel bf16 card ({layout} UNet attention layout) vs fp32 CPU "
              f"rel_l2_err={rel:.3e} tol=5.0e-02", flush=True)
        if not (np.isfinite(rel) and rel <= 5e-2):
            fail(f"reference: flow mel ({layout}) relative error {rel} exceeds 5e-2")
    mels = [mels["fused"], mels["cpu"]]

    # ---- HiFT (fp32) on the card's mel, then the watermark
    hift_cfg = HiFTConfig(base_channels=64, f0_cond_channels=64)
    hift_cpu = weights.init_hift(hift_cfg, seed=5)
    gen_mel = mels[0][:, 2 * n_prompt:].contiguous()
    n_valid = torch.from_numpy(2 * inputs[1])
    h = hift_cfg.nb_harmonics + 1
    zeros = (torch.zeros(b, h), torch.zeros(b, h, gen_mel.shape[1] * 480))
    wavs = []
    for d in (dev, cpu):
        wav, _ = hift_generate(weights.tree_to(hift_cpu, d), hift_cfg, gen_mel.to(d),
                               *(z.to(d) for z in zeros), n_valid=n_valid.to(d))
        wavs.append(wav.cpu())
    err = float((wavs[0] - wavs[1]).abs().max())
    print(f"reference: HiFT wav card vs CPU max_abs_err={err:.3e} tol=2.0e-03", flush=True)
    if not err <= 2e-3:
        fail(f"reference: HiFT wav error {err} exceeds 2e-3")
    wm = SpreadSpectrumWatermarker()
    err = float((wm.apply(wavs[1].to(dev)).cpu() - wm.apply(wavs[1])).abs().max())
    print(f"reference: watermark card vs CPU max_abs_err={err:.3e} tol=1.0e-04", flush=True)
    if not err <= 1e-4:
        fail(f"reference: watermark error {err} exceeds 1e-4")


def conditioning_reference(ref_path):
    """The full-width conditioning modules (S3 tokenizer, CAMPPlus, voice
    encoder; fp32, TF32 off) through ``prepare_conditionals`` of the
    reference WAV on the card and, as the reference, on the CPU, with the
    weights ``ChatterboxTTS.from_random(seed=0)`` gives them: T3's prompt
    tokens and S3Gen's prompt tokens equal; the x-vector, the voice-encoder
    embedding and the prompt mels within 1e-4 relative L2. Prints how near
    the tokenizer's pre-round values come to an FSQ boundary (tanh(z)
    scaled at +-0.5), which a flipped token would sit on."""
    import torch

    from chatterbox_tpu_torch import ChatterboxTTS, weights
    from chatterbox_tpu_torch.constants import S3_SR
    from chatterbox_tpu_torch.core.dsp import s3tok_log_mel_spectrogram
    from chatterbox_tpu_torch.device import full_fp32
    from chatterbox_tpu_torch.models.s3gen.s3gen import S3GenConfig
    from chatterbox_tpu_torch.models.s3tokenizer import FSQ_TANH_SCALE, s3_encode_fsq
    from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig
    from chatterbox_tpu_torch.pipeline.audio import load_wav

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg, ve_cfg = S3GenConfig(), VoiceEncoderConfig()
    # the seeds of from_random(seed=0): CAMPPlus 3, tokenizer 4, VE 5
    s3 = {"campplus": weights.init_campplus(cfg.campplus, 3, dev),
          "tokenizer": weights.init_s3tokenizer(cfg.tokenizer, 4, dev)}
    ve = weights.init_voice_encoder(ve_cfg, 5, dev)
    conds = {}
    for where, d in (("card", dev), ("CPU", cpu)):
        tts = ChatterboxTTS(None, weights.tree_to(s3, d), d, s3gen_cfg=cfg,
                            ve_params=weights.tree_to(ve, d), ve_cfg=ve_cfg)
        t0 = time.time()
        conds[where] = tts.prepare_conditionals(ref_path).to(cpu)
        print(f"reference: prepare_conditionals on the {where} in {time.time() - t0:.3f} s",
              flush=True)
    got, want = conds["card"], conds["CPU"]
    for name, g, w in (("T3 prompt tokens", got.t3.prompt_tokens, want.t3.prompt_tokens),
                       ("S3Gen prompt tokens", got.gen.prompt_token, want.gen.prompt_token),
                       ("S3Gen prompt token lens", got.gen.prompt_token_len,
                        want.gen.prompt_token_len)):
        n_diff = int((g != w).sum()) if g.shape == w.shape else -1
        print(f"reference: {name} {tuple(g.shape)} card vs CPU: {n_diff} differ", flush=True)
        if n_diff != 0:
            fail(f"reference: {name} on the card differ from the CPU's ({n_diff})")
    for name, g, w in (("x-vector", got.gen.embedding, want.gen.embedding),
                       ("voice-encoder embedding", got.t3.speaker_emb, want.t3.speaker_emb),
                       ("prompt mels", got.gen.prompt_feat, want.gen.prompt_feat)):
        rel = float((g - w).norm() / w.norm())
        print(f"reference: {name} {tuple(g.shape)} card vs CPU rel_l2_err={rel:.3e} tol=1.0e-04",
              flush=True)
        if not rel <= 1e-4:
            fail(f"reference: {name} relative error {rel} exceeds 1e-4")
    # the FSQ margin of the reference's first 6 s at 16 kHz on the CPU
    wav16 = torch.from_numpy(load_wav(ref_path, S3_SR)[: 6 * S3_SR])[None]
    with full_fp32():
        z, _ = s3_encode_fsq(weights.tree_to(s3["tokenizer"], cpu), cfg.tokenizer,
                             s3tok_log_mel_spectrogram(wav16).transpose(1, 2))
    margin = float(((torch.tanh(z) * FSQ_TANH_SCALE).abs() - 0.5).abs().min())
    print(f"reference: the nearest of {z.numel()} FSQ pre-round values lies {margin:.3e} from a "
          f"rounding boundary", flush=True)


def random_conditionals(dev, seed=0):
    """Seeded random voice conditionals of the production shapes."""
    import torch

    from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData

    g = torch.Generator(device="cpu").manual_seed(seed)
    t3 = T3CondData(
        speaker_emb=torch.randn((1, 256), generator=g),
        prompt_tokens=torch.randint(0, 6561, (1, 150), generator=g, dtype=torch.int32),
        emotion_adv=torch.full((1,), 0.5),
    )
    gen = RefDict(
        prompt_token=torch.randint(0, 6561, (1, PROMPT_TOKENS), generator=g, dtype=torch.int32),
        prompt_token_len=torch.tensor([PROMPT_TOKENS], dtype=torch.int32),
        prompt_feat=torch.randn((1, 2 * PROMPT_TOKENS, 80), generator=g) * 0.5 - 5.0,
        embedding=torch.randn((1, 192), generator=g),
    )
    return Conditionals(t3, gen).to(dev)


# the __global__ functions of csrc/*.cu, as the profiler names them
PORT_KERNELS = ("flash_decode_kernel", "flash_decode_int8_kernel", "kv_append_kernel",
                "kv_quantize_kernel", "flash_attention_kernel", "flash_attention_heads_kernel")


def profile_call(fn, warm_wall):
    """Device time by kernel over one more call, from torch.profiler's CUDA
    activity, and the device's busy share: the summed time of every kernel
    and copy on the card (one stream, so none overlap) over the unprofiled
    warm call's wall time (the profiler slows the host). The raw events are
    summed here: building the profiler's own event tree for the call's
    hundreds of thousands of launches takes minutes of host time."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    ns, count = collections.Counter(), collections.Counter()
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            ns[e.name()] += e.duration_ns()
            count[e.name()] += 1
    busy = sum(ns.values()) / 1e9
    if busy <= 0:  # a measurement gap (no CUPTI tracing), not a fault of the port
        print("profile: the profiler recorded no device events: device time by kernel and "
              "the busy share not measured", flush=True)
        return
    print(f"profile: device busy {busy:.3f} s over {len(ns)} kernel names and "
          f"{sum(count.values())} launches and copies; profiled wall {wall:.3f} s; busy share "
          f"of the warm call {busy / warm_wall:.4f}", flush=True)
    for name, t in ns.most_common(20):
        print(f"profile: {t / 1e6:10.3f} ms {count[name]:8d} x  {name[:100]}", flush=True)
    # the port's own kernels, wherever they rank: time per launch on the path
    for name, t in ns.items():
        if any(f"{k}<" in name or f"{k}(" in name for k in PORT_KERNELS):
            print(f"profile: port kernel {t / 1e6 / count[name]:.5f} ms a launch, {count[name]} "
                  f"launches: {name[:90]}", flush=True)


# the kernels each path must launch, and those it must not
_K1A, _K1B, _K1C = ("flash_decode_layer_attention", "flash_decode_layer_attention_stats",
                    "flash_decode_layer_attention_int8")
_K2, _K2B = "kv_cache_append", "kv_cache_quantize_write"
_K3, _K4, _K5 = "flash_self_attention_packed", "flash_relpos_attention", "flash_self_attention"
_T3 = (_K1A, _K1B, _K1C, _K2, _K2B)
PATHS = {
    # name: (generate_batch keywords, T3's KV cache, launched, not launched)
    "A": ({"max_new_tokens": MAX_NEW}, "bf16", (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5)),
    "B": ({}, "int8", (_K1C, _K2, _K2B, _K3, _K4), (_K1A, _K1B, _K5)),
    "C": ({"max_new_tokens": MAX_NEW, "alignment": True}, "bf16", (_K1A, _K1B, _K2, _K3, _K4),
          (_K1C, _K2B, _K5)),
    # path A's call on conditionals prepared from the reference WAV
    "D": ({"max_new_tokens": MAX_NEW}, "bf16", (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5)),
    # path A's call after apply_tts_precision(weight_quant=True): int8 T3
    # weights, fused q/k/v (bench.py's tts_b8_wquant); G with 4 flow steps
    # (tts_b8_turbo)
    "F": ({"max_new_tokens": MAX_NEW}, "bf16", (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5)),
    "G": ({"max_new_tokens": MAX_NEW, "flow_steps": TURBO_STEPS}, "bf16", (_K1A, _K2, _K3, _K4),
          (_K1B, _K1C, _K2B, _K5)),
}
WQUANT_PATHS = ("F", "G")

# path E: the reference and the sources, seeded synthetic speech
REF_SECONDS = 10.0
N_SOURCES, SOURCE_SECONDS = 8, (3.0, 12.0)


def check_launches(path, counts, launched, not_launched, exact=None):
    """Fail unless each kernel of ``launched`` ran (as many times as
    ``exact`` says for those it names) and none of ``not_launched`` did."""
    exact = exact or {}
    for k in launched:
        if counts[k] <= 0 or counts[k] != exact.get(k, counts[k]):
            want = f"{exact[k]} times" if k in exact else "at least once"
            fail(f"path {path}: kernel {k} was launched {counts[k]} times, not {want}")
    for k in not_launched:
        if counts[k] != 0:
            fail(f"path {path}: kernel {k} was launched {counts[k]} times")


def check_wavs(path, wavs, n, lens=None):
    """n finite 1-D wavs, each a positive multiple of 960 samples (two 480-
    sample mel frames a token), of ``lens`` samples when given."""
    import torch

    if len(wavs) != n:
        fail(f"path {path}: {len(wavs)} wavs for {n} inputs")
    for i, w in enumerate(wavs):
        if w.ndim != 1 or len(w) == 0 or len(w) % 960 != 0:
            fail(f"path {path}: wav {i}: bad shape {w.shape} (a positive multiple of 960)")
        if lens is not None and len(w) != lens[i]:
            fail(f"path {path}: wav {i}: {len(w)} samples, not {lens[i]}")
        if not bool(torch.isfinite(torch.as_tensor(w)).all()):
            fail(f"path {path}: wav {i}: non-finite samples")


def run_path(tts, conds, card, name, profile, exact=None):
    """One TTS path: a first call with the launch counters set to 0 just
    before it and read just after, its wavs, KV cache and launches checked
    (``exact``: {kernel: launches} where the count is known); then a warm
    call timed and, when asked, a third profiled. Returns the counts, the
    speech tokens and the wav lengths of the first call."""
    import torch

    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts

    kw, kv_cache, launched, not_launched = PATHS[name]

    def call():
        return tts.generate_batch(TEXTS, conds=conds, seed=0, **kw)

    reset_launch_counts()
    t0 = time.time()
    wavs = call()
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()
    tokens = [r.copy() for r in tts.last_speech_tokens]
    lens = [len(w) for w in wavs]

    check_wavs(name, wavs, N_TEXTS)
    if tts.last_timings["kv_cache"] != kv_cache:
        fail(f"path {name}: T3 ran a {tts.last_timings['kv_cache']} KV cache, not {kv_cache}")
    check_launches(name, counts, launched, not_launched, exact)
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(f"path {name} ({json.dumps(kw)}): first call {wall:.3f} s for {audio_s:.3f} s of audio "
          f"(stages {json.dumps(tts.last_timings)})", flush=True)
    print(f"path {name}: kernel launches " + json.dumps(counts), flush=True)

    # a second, warm call on the same inputs: the throughput of the port
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    wavs = call()
    torch.cuda.synchronize()
    wall = time.time() - t0
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(
        f"path {name}: {N_TEXTS} texts, {json.dumps(kw)}: warm wall {wall:.3f} s, audio "
        f"{audio_s:.3f} s, audio_sec_per_s_per_chip_b8 {audio_s / wall:.4f}, t3_s "
        f"{tts.last_timings['t3_s']:.3f}, s3gen_s {tts.last_timings['s3gen_s']:.3f}, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}",
        flush=True,
    )
    print(f"path {name}: warm stages " + json.dumps(tts.last_timings), flush=True)
    if profile:
        profile_call(call, wall)
    return counts, tokens, lens


def prepared_conditionals(tts, ref_path, card):
    """Path D's conditionals: ``prepare_conditionals`` of the reference WAV,
    a first call and a warm one timed, the result's shapes checked."""
    import torch

    walls = []
    for _ in range(2):
        t0 = time.time()
        conds = tts.prepare_conditionals(ref_path)
        torch.cuda.synchronize()
        walls.append(time.time() - t0)
    p_tok = int(REF_SECONDS * 25)
    shapes = {"T3 prompt tokens": (tuple(conds.t3.prompt_tokens.shape),
                                   (1, tts.t3_cfg.speech_cond_prompt_len)),
              "voice-encoder embedding": (tuple(conds.t3.speaker_emb.shape),
                                          (1, tts.ve_cfg.speaker_embed_size)),
              "S3Gen prompt tokens": (tuple(conds.gen.prompt_token.shape), (1, p_tok)),
              "prompt mels": (tuple(conds.gen.prompt_feat.shape), (1, 2 * p_tok, 80)),
              "x-vector": (tuple(conds.gen.embedding.shape),
                           (1, tts.s3gen_cfg.campplus.embedding_size))}
    for name, (got, want) in shapes.items():
        if got != want:
            fail(f"path D: prepare_conditionals gave {name} of shape {got}, not {want}")
    for x in (conds.t3.speaker_emb, conds.gen.prompt_feat, conds.gen.embedding):
        if not bool(torch.isfinite(x).all()):
            fail("path D: prepare_conditionals gave non-finite values")
    print(f"path D: prepare_conditionals of a {REF_SECONDS:.0f} s reference: first call "
          f"{walls[0]:.3f} s, warm {walls[1]:.3f} s on {card}", flush=True)
    return conds


def main_path(card, ref_path):
    import torch

    from chatterbox_tpu_torch import ChatterboxTTS
    from chatterbox_tpu_torch.runtime.precision import apply_tts_precision

    t0 = time.time()
    tts = ChatterboxTTS.from_random(seed=0)
    conds = random_conditionals(tts.device)
    torch.cuda.synchronize()
    print(f"paths: from_random at full width in {time.time() - t0:.1f} s", flush=True)
    unet = tts.s3gen_cfg.flow.estimator
    blocks = unet.n_blocks * (2 + unet.num_mid_blocks)  # UNet transformer blocks: 56
    counts, tokens, lens = {}, {}, {}
    for name in PATHS:
        t0 = time.time()
        if name == WQUANT_PATHS[0]:
            apply_tts_precision(tts, weight_quant=True)
            layers = tts.t3_params["llama"]["layers"]
            if not ("w8" in layers["qkv"] and layers["qkv"]["w8"].dtype == torch.int8
                    and "q" not in layers):
                fail(f"path {name}: apply_tts_precision did not give fused int8 T3 weights")
            print(f"path {name}: apply_tts_precision(weight_quant=True) in "
                  f"{time.time() - t0:.1f} s", flush=True)
        c = prepared_conditionals(tts, ref_path, card) if name == "D" else conds
        exact = {_K3: blocks * TURBO_STEPS} if name == "G" else None
        # a profile takes a call more: none on path D, path A's call on other
        # conditionals
        counts[name], tokens[name], lens[name] = run_path(tts, c, card, name, name != "D", exact)
        print(f"path {name}: {time.time() - t0:.1f} s", flush=True)
    # G changes only the flow: its T3 tokens and wav lengths are F's
    f, g = WQUANT_PATHS
    same = all(len(a) == len(b) and (a == b).all() for a, b in zip(tokens[f], tokens[g]))
    print(f"path {g}: speech tokens equal to path {f}'s: {same}; wav lengths equal: "
          f"{lens[f] == lens[g]}", flush=True)
    if not (same and lens[f] == lens[g]):
        fail(f"path {g}: flow_steps={TURBO_STEPS} changed T3's tokens or the wav lengths")
    return counts


def vc_path(card, ref_path, src_paths, src_lens):
    """Path E: ``ChatterboxVC.generate_batch`` of the sources into the
    reference's voice, in the fused UNet attention layout and then the
    unfused one, each a first call (launches counted and checked, wavs
    checked) and a warm call timed; the unfused one profiled. Then the
    flow mels of one batch in both
    layouts, held to each other within relative L2 5e-2 (the card-vs-CPU
    tolerance of the bf16 flow). Returns the first calls' counts by layout."""
    import numpy as np
    import torch

    from chatterbox_tpu_torch import ChatterboxVC, weights
    from chatterbox_tpu_torch.constants import S3_SR
    from chatterbox_tpu_torch.device import full_fp32
    from chatterbox_tpu_torch.models.s3gen.flow import flow_inference
    from chatterbox_tpu_torch.models.s3tokenizer import s3_tokenize
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.pipeline.tts import cfm_noise

    t0 = time.time()
    fused = ChatterboxVC.from_random(seed=0)
    unfused = ChatterboxVC({**fused.s3gen_params,
                            "flow": weights.split_unet_qkv(fused.s3gen_params["flow"])},
                           fused.device, fused.s3gen_cfg)
    torch.cuda.synchronize()
    print(f"path E: from_random at full width in {time.time() - t0:.1f} s", flush=True)
    unet, n_steps = fused.s3gen_cfg.flow.estimator, fused.s3gen_cfg.flow.n_timesteps
    k5_per_call = unet.n_blocks * (2 + unet.num_mid_blocks) * n_steps  # 56 blocks x 10 steps
    # each source's samples out: 2 x 480 a token of 640 input samples
    n_tok = [-(-n // (S3_SR // 25)) for n in src_lens]
    out_lens = [960 * n for n in n_tok]
    layouts = {"fused": (fused, (_K3, _K4), (_K5,) + _T3, None),
               "unfused": (unfused, (_K5, _K4), (_K3,) + _T3, {_K5: k5_per_call})}
    counts = {}
    for layout, (vc, launched, not_launched, exact) in layouts.items():
        t0 = time.time()
        reset_launch_counts()
        wavs = vc.generate_batch(src_paths, target_voice_path=ref_path)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts[layout] = launch_counts()
        check_wavs(f"E ({layout})", wavs, N_SOURCES, out_lens)
        check_launches(f"E ({layout})", counts[layout], launched, not_launched, exact)
        audio_s = sum(len(w) for w in wavs) / vc.sr
        print(f"path E ({layout}): first call (target voice included) {wall:.3f} s for "
              f"{audio_s:.3f} s of audio, token bucket {vc.last_timings['token_bucket']}",
              flush=True)
        print(f"path E ({layout}): kernel launches " + json.dumps(counts[layout]), flush=True)

        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        wavs = vc.generate_batch(src_paths)
        torch.cuda.synchronize()
        wall = time.time() - t0
        print(f"path E ({layout}): {N_SOURCES} sources: warm wall {wall:.3f} s, audio "
              f"{audio_s:.3f} s, audio_sec_per_s_per_chip_b8 {audio_s / wall:.4f}, peak "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}", flush=True)
        if layout == "unfused":
            profile_call(lambda: vc.generate_batch(src_paths), wall)

    # the flow alone, both layouts on one batch: the VC call's own tokens
    batch, n_toks, _ = ChatterboxVC._pack_sources(src_paths)
    dev = fused.device
    lens = torch.from_numpy(n_toks).to(dev)
    with torch.inference_mode():
        with full_fp32():
            tokens, _ = s3_tokenize(fused.s3gen_params["tokenizer"], fused.s3gen_cfg.tokenizer,
                                    torch.from_numpy(batch).to(dev).float() / 32768.0,
                                    wav_lens=lens * (S3_SR // 25))
        ref = [x.expand((N_SOURCES,) + x.shape[1:]) for x in fused.ref_dict]
        total = 2 * (ref[0].shape[1] + tokens.shape[1])
        noise = cfm_noise(dev)[:, :total].expand(N_SOURCES, total, 80)
        mels = [flow_inference(vc.s3gen_params["flow"], vc.s3gen_cfg.flow, tokens, lens, *ref,
                               noise)[0].float().cpu() for vc in (fused, unfused)]
    n_valid = 2 * (ref[0].shape[1] + n_toks)
    rel = max(float((mels[1][i, :n] - mels[0][i, :n]).norm() / mels[0][i, :n].norm())
              for i, n in enumerate(n_valid))
    print(f"path E: flow mel, unfused (K5) vs fused (K3) layout on one batch of {N_SOURCES} "
          f"(T = {mels[0].shape[1]}) rel_l2_err={rel:.3e} tol=5.0e-02", flush=True)
    if not (np.isfinite(rel) and rel <= 5e-2):
        fail(f"path E: the two layouts' flow mels part by {rel} (relative L2), over 5e-2")
    return counts


def write_audio(audio_dir):
    """The seeded reference (24 kHz) and sources (16 kHz) as WAV files ->
    (reference path, source paths, source lengths in samples)."""
    import numpy as np

    from chatterbox_tpu_torch.constants import S3_SR, S3GEN_SR
    from chatterbox_tpu_torch.pipeline.audio import save_wav, synthetic_voice

    ref_path = os.path.join(audio_dir, "reference.wav")
    save_wav(ref_path, synthetic_voice(1000, REF_SECONDS, S3GEN_SR), S3GEN_SR)
    rng = np.random.default_rng(1001)
    src_paths, src_lens = [], []
    for i in range(N_SOURCES):
        wav = synthetic_voice(1002 + i, float(rng.uniform(*SOURCE_SECONDS)), S3_SR)
        src_paths.append(os.path.join(audio_dir, f"source_{i}.wav"))
        save_wav(src_paths[-1], wav, S3_SR)
        src_lens.append(len(wav))
    return ref_path, src_paths, src_lens


def main():
    t_start = time.time()
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    card = card_line()
    print(f"device: {torch.cuda.get_device_name(0)} count={torch.cuda.device_count()}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    from chatterbox_tpu_torch.ops import _build

    t0 = time.time()
    _build.build(force=True)
    print(f"build: nvcc for sm_90a, {len(_build.SOURCES)} sources in {time.time() - t0:.1f} s",
          flush=True)

    # each phase's wall seconds, so a later slice can see what its additions
    # cost against the run's time limit
    with tempfile.TemporaryDirectory(prefix=".smoke_audio_", dir=HERE) as audio_dir:
        ref_path, src_paths, src_lens = write_audio(audio_dir)
        t0 = time.time()
        rows = kernel_phase()
        rows.update(probe_kernel_phase())
        t1 = time.time()
        probes, probe_counts = probe_phase(card)
        t2 = time.time()
        reference_phase()
        conditioning_reference(ref_path)
        t3 = time.time()
        counts = main_path(card, ref_path)
        t4 = time.time()
        vc_counts = vc_path(card, ref_path, src_paths, src_lens)
        t5 = time.time()
    print(f"phases: start {t0 - t_start:.1f} s, kernels {t1 - t0:.1f} s, probes {t2 - t1:.1f} s, "
          f"reference {t3 - t2:.1f} s, TTS paths {t4 - t3:.1f} s, VC path {t5 - t4:.1f} s",
          flush=True)
    counts["E"] = {k: vc_counts["fused"][k] + vc_counts["unfused"][k] for k in vc_counts["fused"]}
    counts["probes"] = probe_counts
    # each P2/P3 variant's launches in the probe phase
    variant_launches = {k: v["launches"] for k, v in probes["P2/P3"]["variants"].items()}

    # "max_abs_err"/"ms" and "max_err"/"kernel_ms" carry the same numbers
    # under the two sets of names that readers of this line expect;
    # "launches" sums the first calls of paths A-G (E: both layouts) and the
    # probe phase; a probe's row counts its probe's launches in that phase
    table = []
    for key, r in rows.items():
        src, replaces = KERNEL_INFO[key]
        bound_ms, bound_by = r["bound"]
        name = r.get("name", key)
        if key in ("P2", "P3"):
            launches = sum(n for v, n in variant_launches.items() if v.startswith(key))
            by_path = {"probes": launches}
        elif key.startswith("P"):
            launches = probe_counts[name]
            by_path = {"probes": launches}
        else:
            by_path = {p: c[name] for p, c in counts.items()}
            launches = sum(by_path.values())
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "launches_by_path": by_path,
            "max_abs_err": r["err"], "max_err": r["err"],
            "tol": r["tol"], "err_share_of_tol": r["share"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            "library_max_abs_err": r["library_err"],
        }
        if key.startswith("P"):
            row["probe"] = key
        row.update({k: r[k] for k in ("library_note", "k1a_ms_same_live_lengths",
                                      "headline_variant", "variants") if k in r})
        row.update(r.get("extra", {}))
        table.append(row)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
