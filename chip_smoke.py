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
     each as device time from a replayed CUDA graph;
  4. reference: a small model with the main path's head width, through the
     port on the card against the port's plain versions on the CPU, and the
     full-width conditioning modules on the card against the CPU (see
     ``reference_phase`` and ``conditioning_reference`` for each comparison
     and its tolerance);
  5. the TTS paths, on ``ChatterboxTTS.from_random(seed=0)`` at full width
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
     after each first call a second, warm call is timed (audio seconds per
     second, per stage) and a third profiled (device time by kernel, the
     busy share) while the run is under half its limit; no TTS path
     launches K5;
  6. the VC path E: ``ChatterboxVC.from_random(seed=0)`` (the same S3Gen
     weights), ``generate_batch`` of 8 seeded 3-12 s sources written as
     16 kHz WAVs, with ``target_voice_path`` the reference of path D: in
     the fused attention layout (K3 and K4, no K5), then with the UNet's
     ``to_qkv`` split into ``to_q``/``to_k``/``to_v`` (K5 in every
     transformer block at every Euler step, K4, no K3), each a first and a
     warm call, the unfused one profiled; then the two layouts' flow mels
     on one batch against each other;
  7. prints the kernel table as one JSON line, the card line, and then
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

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
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
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds, loads and allocates outside the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rotating(fn, n):
    """A callable that runs fn(0), fn(1), ..., fn(n - 1), fn(0), ... on
    successive calls, so that timed launches read other memory each time,
    as the main path's launches do, and not the same lines from L2."""
    calls = itertools.count()
    return lambda: fn(next(calls) % n)


def bound(n_bytes, flops):
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
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
    import numpy as np
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.core.sampling import SamplingConfig
    from chatterbox_tpu_torch.models.s3gen.conformer import ConformerConfig
    from chatterbox_tpu_torch.models.s3gen.flow import FlowConfig, flow_inference
    from chatterbox_tpu_torch.models.s3gen.hifigan import HiFTConfig, hift_generate
    from chatterbox_tpu_torch.models.s3gen.unet import UNetConfig
    from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
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
    for variant in ({}, {"cache_quant": True}, {"alignment": True}):
        for greedy in (True, False):
            out = []
            for p, d in ((p_dev, dev), (p_cpu, cpu)):
                args = [torch.from_numpy(x).to(d) for x in (text, lens, *cond)]
                res = t3_generate(p, t3_cfg, *args, SamplingConfig(greedy=greedy), max_new,
                                  uniforms=torch.from_numpy(uniforms).to(d), **variant)
                out.append((res.tokens.cpu(), res.lengths.cpu()))
            if not (torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])):
                fail(f"reference: T3 tokens on the card differ from the CPU ({variant}, "
                     f"greedy={greedy})")
        print(f"reference: T3 fp32 tokens equal to the CPU's, greedy and sampled "
              f"({json.dumps(variant) if variant else 'K1a/K2'})", flush=True)

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
    mels = {}
    for layout, d, dt in (("fused", dev, torch.bfloat16), ("unfused", dev, torch.bfloat16),
                          ("cpu", cpu, torch.float32)):
        p = weights.tree_to(flow_bf16, d, dt)
        if layout == "unfused":
            p = weights.split_unet_qkv(p)
        mel, _ = flow_inference(p, flow_cfg, *(torch.from_numpy(x).to(d) for x in inputs))
        mels[layout] = mel.float().cpu()
    valid = [mels["cpu"][i, : 2 * (n_prompt + int(inputs[1][i]))] for i in range(b)]
    for layout in ("fused", "unfused"):
        got = [mels[layout][i, : len(v)] for i, v in enumerate(valid)]
        rel = max(float((g - v).norm() / v.norm()) for g, v in zip(got, valid))
        print(f"reference: flow mel bf16 card ({layout} UNet attention) vs fp32 CPU "
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
}

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


def run_path(tts, conds, card, name, profile):
    """One TTS path: a first call with the launch counters set to 0 just
    before it and read just after, its wavs, KV cache and launches checked;
    then a warm call timed and, when asked, a third profiled. Returns the
    counts of the first call."""
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

    check_wavs(name, wavs, N_TEXTS)
    if tts.last_timings["kv_cache"] != kv_cache:
        fail(f"path {name}: T3 ran a {tts.last_timings['kv_cache']} KV cache, not {kv_cache}")
    check_launches(name, counts, launched, not_launched)
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
    return counts


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


def main_path(card, ref_path, t_start):
    import torch

    from chatterbox_tpu_torch import ChatterboxTTS

    t0 = time.time()
    tts = ChatterboxTTS.from_random(seed=0)
    conds = random_conditionals(tts.device)
    torch.cuda.synchronize()
    print(f"paths: from_random at full width in {time.time() - t0:.1f} s", flush=True)
    counts = {}
    for name in PATHS:
        t0 = time.time()
        c = prepared_conditionals(tts, ref_path, card) if name == "D" else conds
        # a profile takes a call more: none once the run nears half its limit
        counts[name] = run_path(tts, c, card, name, profile=time.time() - t_start < 500)
        print(f"path {name}: {time.time() - t0:.1f} s", flush=True)
    return counts


def vc_path(card, ref_path, src_paths, src_lens, t_start):
    """Path E: ``ChatterboxVC.generate_batch`` of the sources into the
    reference's voice, in the fused UNet attention layout and then the
    unfused one, each a first call (launches counted and checked, wavs
    checked) and a warm call timed; the unfused one profiled while the run
    is under half its limit. Then the flow mels of one batch in both
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
        if layout == "unfused" and time.time() - t_start < 500:
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
        t1 = time.time()
        reference_phase()
        conditioning_reference(ref_path)
        t2 = time.time()
        counts = main_path(card, ref_path, t_start)
        t3 = time.time()
        vc_counts = vc_path(card, ref_path, src_paths, src_lens, t_start)
        t4 = time.time()
    print(f"phases: start {t0 - t_start:.1f} s, kernels {t1 - t0:.1f} s, reference "
          f"{t2 - t1:.1f} s, TTS paths {t3 - t2:.1f} s, VC path {t4 - t3:.1f} s", flush=True)
    counts["E"] = {k: vc_counts["fused"][k] + vc_counts["unfused"][k] for k in vc_counts["fused"]}

    # "max_abs_err"/"ms" and "max_err"/"kernel_ms" carry the same numbers
    # under the two sets of names that readers of this line expect;
    # "launches" sums the first calls of paths A-E (E: both layouts)
    table = []
    for name, r in rows.items():
        src, replaces = KERNEL_INFO[name]
        bound_ms, bound_by = r["bound"]
        by_path = {p: c[name] for p, c in counts.items()}
        row = {
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": r["err"], "max_err": r["err"],
            "tol": r["tol"], "err_share_of_tol": r["share"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            "library_max_abs_err": r["library_err"],
        }
        row.update({k: r[k] for k in ("library_note", "k1a_ms_same_live_lengths") if k in r})
        row.update(r.get("extra", {}))
        table.append(row)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
