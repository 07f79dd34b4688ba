"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles every kernel of ``chatterbox_tpu_torch/csrc`` with nvcc;
  3. kernels: runs K1a, K1b, K1c+d, K2, K2b, K3, K4 and K5 at the full-width
     shapes of the TTS and VC paths (K1a at path A's cache length, S = 384,
     and at the default budget's, S = 1152, where K1b, K1c+d and K2b run,
     K2b also at the prefill's 100 tokens; K3 and K4 also at a streaming
     tick's lengths (``tick_kernel_checks``: K3 at T = 640 and 768 on 8
     rows, K4 at T = 384, 640 and 768 on 4);
     K1a, K1b and K1c+d each called twice on the same inputs, which must
     agree bit for bit; K3 and K5 at T = 1024, 1536 and 2560, paths A, E
     and B, where the two must agree bit for bit on the same q, k, v; K4 at
     T = 1024 and 2560; the Granite backbone's two decode kernels at the
     Granite cell's shapes, ``granite_kernel_checks``: the Mamba-2 update
     on 128 rows x 64 heads x 64 x 128 over 4 consecutive steps, and K1a
     with 4 query heads a KV head, scale 1/64, on 128 rows x 8 KV heads at
     S = 384; the Llama decode step's three glue kernels at cell A's 128
     rows, ``glue_kernel_checks``), holds each
     against its plain PyTorch version on the same inputs (the limits are
     stated at ``OUT_RTOL``) and times the kernel, the plain version and,
     as a yardstick only, one PyTorch library call for the same function,
     each as device time from a replayed CUDA graph, and prints each
     kernel's share of its bound; then the probe kernels
     P1-P5 at the probes' own shapes, each against its plain version and
     timed the same way (``probe_kernel_phase``; the P2/P3 column writes
     also once with the L2 flushed, with K2 and ``index_copy_`` beside them;
     P4 also on a second seeded input set over the whole int8 range, its
     convert beside ``k8[:, :64] * 0.5``; P5 also from a random scratch; the
     launch floor, an empty kernel timed the same way, beside P1, P4 and P5,
     and the CUDA runtime and driver versions on P1's line, since P1, P4 and
     P5 launch with programmatic dependent launch);
  4. probes: the entry points of ``chatterbox_tpu_torch/probes/`` with the
     launch counters set to 0 just before and read just after: P1's four
     chains of ``P1_LAYERS`` (10) layers at full width, eager and as a CUDA graph, with bf16
     and with int8 weights, each timed as the best of ``P1_ITERS`` (2) runs,
     then P2/P3, P4 and P5 (``probe_phase``);
  5. reference: a small model with the main path's head width, through the
     port on the card against the port's plain versions on the CPU (T3 with
     dense and with int8 weights, the flow at 10 and at 4 Euler steps), and
     the full-width conditioning modules on the card against the CPU (see
     ``reference_phase`` and ``conditioning_reference`` for each comparison
     and its tolerance);
  6. the TTS paths, on ``ChatterboxTTS.from_random(seed=0)`` at full width
     with T3 cut to ``TTS_T3_LAYERS`` (10) of its 30 layers, path I on a
     second model with all 30 (T3 and flow in bf16, HiFT and the
     conditioning modules in fp32), each
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
       H. 16 texts at ``max_new_tokens=250`` with ``max_device_batch = 8``:
          the batch splits into two chunks of 8 through
          ``generate_batches_pipelined``; each chunk's speech tokens and
          wavs must equal a direct ``generate_batch(chunk, seed=c,
          device_chain=True)``'s; the warm split call is timed against the
          two direct calls, with the peak memory of each;
       I. one call at the card's one-shot cap for the default 1000 tokens
          on the int8 cache: it must run without running out of memory
          (prints the batch, the peak and ``total_memory``);
       F. path A's call after ``apply_tts_precision(tts, weight_quant=True)``:
          int8 T3 weights with fused q/k/v (``bench.py``'s tts_b8_wquant);
       G. path F with ``flow_steps=4`` (tts_b8_turbo): T3's tokens and the
          wav lengths must equal F's, and the flow launches K3 exactly
          4 x 56 times;
       J. ``stream_generate_batch`` of four texts at the default
          ``StreamConfig`` (1000 tokens, the int8 cache), one call
          counted, checked (whole finite chunks; tokens equal to a
          one-shot ``t3_generate``; K1c+d, K2b, K3 and K4 per step and per
          tick) and timed (time to first audio, ms a tick, T3's ms a
          step, ``stream_aggregate_audio_sec_per_s_n4``), then one stream
          with the flow window over its whole history against
          ``generate_batch`` (SNR bound ``STREAM_SNR_DB``);
       K. ``generate_batch_preemptible`` of the 8 texts at 250 tokens in
          T3 chunks of 25 against ``generate_batch``: tokens and wavs bit
          for bit, both timed warm in turns;
       L. the stdlib server over this model on 127.0.0.1: /health, a voice
          upload and an emotion profile, 4 concurrent /generate (must
          coalesce), a seeded /generate (equal to a direct call), 2
          concurrent streams with a bulk /generate (must go preemptibly),
          and a stream with alignment (400);
       R. (after path G, on a model of its own) ``generate_batch`` of the 8
          texts at 250 tokens with T3 on the Granite 4.0-H backbone at its
          published widths (``GraniteT3Config()``: 36 Mamba-2 and 4
          attention layers, bf16), the program's recorder on: the update
          once a Mamba layer a decode step (36 x 249) and K1a once an
          attention layer (4 x 249), no K1b, K1c+d or K2b, every step
          after the first replayed from its graphs, ``t3.ssm_layers`` 36;
     K1 must launch once a layer a decode step (A: 10 x 249, B: 10 x 999,
     I: 30 x 999; C: 9 x 249 K1a and 249 K1b; H: 2 x 10 x 249; J: 10 x 999
     K1c+d; K: 10 x 249), K2b once at the prefill and once a decode step,
     merging where the step's slot closes a tail of 8 (I: 1000); on paths
     A-G, O1 and both ranks of O2 the glue kernels once a layer a decode
     step (the norm twice, and once more a step), on path R never;
     after the first call of paths A, D and F (``WARM_PATHS``) a second,
     warm call is timed (audio seconds per second, per stage), and on paths
     A and F (bf16 and int8 weights) a third profiled (device time by
     kernel, the busy share); B, C and G time no warm call, and K makes one
     call of each kind, for the run's time limit; no TTS path launches K5;
  7. the VC path E: ``ChatterboxVC.from_random(seed=0)`` (the same S3Gen
     weights), ``generate_batch`` of 8 seeded 3-12 s sources written as
     16 kHz WAVs, with ``target_voice_path`` the reference of path D: in
     the fused attention layout (K3 and K4, no K5), then with the UNet's
     ``to_qkv`` split into ``to_q``/``to_k``/``to_v`` (K5 in every
     transformer block at every Euler step, K4, no K3), each a first and a
     warm call, the unfused one profiled; then, fused,
     ``generate_batches_pipelined`` over two batches of 4 sources, which
     must equal per-batch ``generate_batch`` calls bit for bit (both timed
     warm); then the two layouts' flow mels on one batch against each
     other;
  8. the reference checkpoint set, path M (``reference_set_path``): a fresh
     ``from_random(seed=0)`` written in the reference format by
     ``tests/torch_reference_format.py`` into a directory of the checkout
     (removed at the end), loaded with ``ChatterboxTTS.from_local`` (every
     leaf bit for bit; the load's wall seconds and peak RSS), path A's call
     on it (launches counted and checked; tokens and wavs equal to the
     written model's), ``save_native`` -> ``from_native``,
     ``ChatterboxVC.from_local`` on two of path E's sources, and a random
     Perth net from the factory, on the card against the CPU, in the
     pipeline and in a stream;
  8b. voice embeddings and ``load_params``, path Q (``voice_path``): path
     D's seeded 10 s synthetic voice made at 16, 24 and 44.1 kHz, each
     through ``ve_embed_from_wavs`` (the full-width ``VoiceEncoderConfig()``
     with from_random(seed=0)'s weights; kaiser_fast resampling to 16 kHz,
     silence trimmed) on the card and on the CPU, within ``Q_EMBED_ATOL``,
     and the cosine of the 24 and 44.1 kHz embeddings to the 16 kHz one;
     ``resample`` 44.1 -> 16 kHz with kaiser_fast and kaiser_best on the card
     against the CPU (within ``Q_RESAMPLE_ATOL``), timed; ``load_params`` of
     the T3 file path M's ``save_native`` wrote, on the card, bit for bit
     against the tree path M saved;
  9. T3 training, path N (``train_path``): ``T3Trainer`` on ``T3Config()``
     in fp32 (532,397,056 parameters) with batches of 8 rows of 34 + 128 +
     512 positions: the first gradient reaches every leaf; 2 warm and 4
     timed steps on one batch (losses finite and falling; ms a step by
     ``runtime.profiling.StageTimer``, tokens/s, the share of the fp32
     bound, peak memory, the AdamW update's ms); a save and resume under
     ``torch.use_deterministic_algorithms(True)`` equal bit for bit to the
     straight run; a 4-layer T3 at full width on the card against the CPU;
     ``cfm_loss`` at the full flow width on 8 rows of 1000 frames (K3 56
     launches, against the dense path; autograd through K3 raises; the
     dense path's gradient finite);
 10. the mesh, path O (``mesh_path``): O1, a world of one over NCCL and
     ``with_mesh(make_mesh((1, 1)), model_sharded=True)`` on path A's
     model, path A's call bit for bit; O2, two processes on the card over
     ``gloo`` (``chip_smoke.py --mesh-worker``), T3 at full width split 8
     heads a rank on a (1, 2) mesh, 4 layers, fp32, greedy, 50 tokens,
     against the world of one (K1a, K2 and the glue kernels on each
     rank's heads, in fp32); O3,
     ``dryrun_multichip(1)``; O4, ``from_random(synthetic=True)`` at full
     width against the CPU's ``synthetic_like`` on three leaves, and the
     native library (its build must succeed: the machine has g++);
 11. prints the kernel table as one JSON line (K1a-K5 and one row for each
     probe, its variants under it), the card line, and then
     ``{"ok": true, "device": {...}}`` as the last line.

Numerics: fp32 matmuls and convolutions run in full fp32 (TF32 off) so the
fp32 vocoder matches its reference arithmetic; the kernels are compared in
their working dtype (bf16).
"""

import contextlib
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
# cuBLAS runs deterministically under torch.use_deterministic_algorithms (path
# N's resume check) only with a fixed workspace, set before its first call;
# 8 buffers of 4 MiB
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

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
# depth cut so that the run fits its time limit (a decode step is bound by
# the host's launches, a cost a layer; the width stays full): the TTS paths'
# T3 (the alignment layer, 9, stays in the stack; path I, the memory cap,
# and path M, the reference set, keep all 30) and P1's chains
TTS_T3_LAYERS = 10
P1_LAYERS = 10
P1_ITERS = 2  # runs of each P1 chain count, best taken (the probe's default is 3)
N_COND, TEXT_BUCKET, N_BOS = 34, 64, 2
FLOW_HEADS, CONF_HEADS, CONF_C = 8, 8, 512
# K3's and K5's (padded T, valid mel frames): path A's flow (250 + 250
# tokens), path E's (1500 frames) and path B's (250 + 1000)
SELF_ATTN_T = ((1024, 1000), (1536, 1500), (2560, 2500))
TURBO_STEPS = 4  # path G's per-call flow_steps

# path H's second chunk
TEXTS_H = [
    "Peter Piper picked a peck of pickled peppers.",
    "All that glitters is not gold.",
    "Fortune favours the bold, or so they claim.",
    "The early bird catches the worm.",
    "Many hands make light work, most days.",
    "Actions speak louder than words.",
    "Two wrongs do not make a right.",
    "A watched pot never boils, they say.",
]
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


def check_repeat(name, fn):
    """Two calls of ``fn`` on the same inputs must agree bit for bit (K1's
    combine folds its chunks in order, whichever CTA comes last)."""
    import torch

    a, b = fn(), fn()
    torch.cuda.synchronize()
    same = all(torch.equal(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else \
        torch.equal(a, b)
    print(f"kernel {name}: two calls on the same inputs bit-identical: {same}", flush=True)
    if not same:
        fail(f"{name}: two calls on the same inputs differ")


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

    def dpos(n):
        """A position as the kernels read it: a (1,) int32 on the card,
        uploaded here, outside every timed graph."""
        return fd.device_position(n, dev)

    def worst_check(checks):
        """(max |err|, its limit, the worst share) of (err, tol, share)s."""
        return max(c[0] for c in checks), checks[0][1], max(c[2] for c in checks)

    rows = {}

    # ---- K1: decode attention, 16 CFG rows x 16 heads, mid-decode length,
    # checked at lengths with cur_len % 8 = 1, 0 and 7 (the path's phases)
    s0 = N_COND + TEXT_BUCKET + N_BOS
    s_cache = -(-(s0 + MAX_NEW) // 128) * 128
    cur_len = s0 + MAX_NEW // 2
    cache = randn(T3_LAYERS, 2, ROWS, T3_HEADS, s_cache, HEAD_DIM)
    q, kn, vn = (randn(ROWS, T3_HEADS, HEAD_DIM) for _ in range(3))
    text_lens = torch.randint(20, TEXT_BUCKET, (N_TEXTS,), generator=g, device=dev)
    row_prefix = (N_COND + text_lens).repeat(2).to(torch.int32).contiguous()
    gap_end = N_COND + TEXT_BUCKET
    checks = []
    for c in (cur_len, cur_len // TAIL_W * TAIL_W, cur_len // TAIL_W * TAIL_W + TAIL_W - 1):
        want = fd.flash_decode_layer_attention_plain(cache, 7, c, row_prefix, gap_end, q, kn, vn)
        checks.append(check_kernel(f"flash_decode_layer_attention (cur_len {c})",
                                   fd.flash_decode_layer_attention(
                                       cache, 7, dpos(c), row_prefix, gap_end, q, kn, vn), want))
    err, tol, share = worst_check(checks)
    want = fd.flash_decode_layer_attention_plain(cache, 7, cur_len, row_prefix, gap_end, q, kn, vn)
    cur_dev = dpos(cur_len)
    args = (cache, 7, cur_dev, row_prefix, gap_end, q, kn, vn)
    check_repeat("flash_decode_layer_attention", lambda: fd.flash_decode_layer_attention(*args))
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
            cache, i, cur_dev, row_prefix, gap_end, q, kn, vn), T3_LAYERS), 300),
        plain_ms=timed(rotating(lambda i: fd.flash_decode_layer_attention_plain(
            cache, i, cur_len, row_prefix, gap_end, q, kn, vn), T3_LAYERS), 60),
        library_ms=timed(rotating(k1_library, T3_LAYERS), 300),
        bound=bound(k1_bytes, k1_flops),
    )
    del kv_lib

    # ---- K2: per-step append of all 30 layers' K/V at one slot, at the
    # same three phases
    new_kv = randn(T3_LAYERS, 2, ROWS, T3_HEADS, HEAD_DIM)
    c_kernel, c_plain = cache.clone(), cache.clone()
    for c in (cur_len, cur_len // TAIL_W * TAIL_W, cur_len // TAIL_W * TAIL_W + TAIL_W - 1):
        fd.kv_cache_append(c_kernel, new_kv, dpos(c))
        fd.kv_cache_append_plain(c_plain, new_kv, c)
    err, tol, share = check_kernel("kv_cache_append", c_kernel, c_plain, exact=True)
    c_lib = cache.clone()
    c_lib.index_copy_(4, torch.tensor([cur_len], device=dev), new_kv[:, :, :, :, None])
    lib_err = library_err("kv_cache_append", c_lib, c_plain)
    del c_plain, c_lib
    # each timed launch writes the next decode step's slot
    pos = [s0 + i for i in range(MAX_NEW)]
    pos_idx = [torch.tensor([p], device=dev) for p in pos]
    pos_dev = [dpos(p) for p in pos]
    rows["kv_cache_append"] = dict(
        err=err, tol=tol, share=share, library_err=lib_err,
        ms=timed(rotating(lambda i: fd.kv_cache_append(c_kernel, new_kv, pos_dev[i]), MAX_NEW),
                 500),
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

    curs_dev = [dpos(c) for c in curs]
    # the checks' lengths: cur_len % 8 = 0, 1 and 7
    phase_curs = (curs[-1], curs[0], curs[-2])

    def step_args(i, device_len=True):
        """(layer, cur_len) of timed launch i: the kernels' cur_len on the
        card, the plain versions' an int."""
        return i % T3_LAYERS, (curs_dev if device_len else curs)[i % TAIL_W]

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
    checks, m_share, l_share = [], 0.0, 0.0
    for c in (c_mid + 3,) + phase_curs:
        args = (kv, 7, c, row_prefix, gap_end, q, kn, vn)
        out, m, l = fd.flash_decode_layer_attention_stats(kv, 7, dpos(c), *args[3:])
        want, want_m, want_l = fd.flash_decode_layer_attention_stats_plain(*args)
        checks.append(check_kernel(f"flash_decode_layer_attention_stats (cur_len {c})", out,
                                   want))
        m_share = max(m_share, float(((m - want_m).abs() / (1e-5 * want_m.abs() + 1e-5)).max()))
        l_share = max(l_share, float(((l - want_l).abs() / (1e-4 * want_l)).max()))
    check_repeat("flash_decode_layer_attention_stats",
                 lambda: fd.flash_decode_layer_attention_stats(kv, 7, curs_dev[3], *args[3:]))
    err, tol, share = worst_check(checks)
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
            kv, *step_args(i, False), row_prefix, gap_end, q, kn, vn), T3_LAYERS * TAIL_W), 60),
        library_ms=timed(rotating(lib, T3_LAYERS), 300),
        library_note="SDPA gives no (m, l)",
        bound=mean_bound(lambda c: 2 * sum(live(c)) * T3_HEADS * HEAD_DIM * 2 + vec_bytes
                         + rows_h * 8, k1_flops),
    )
    # K1a at S = 1152 at the same live lengths (the int8 kernel's comparison),
    # beside the same SDPA
    k1a_same_ms = timed(rotating(lambda i: fd.flash_decode_layer_attention(
        kv, *step_args(i), row_prefix, gap_end, q, kn, vn), T3_LAYERS * TAIL_W), 240)
    k1a_1152 = dict(
        ms=k1a_same_ms, library_ms=rows["flash_decode_layer_attention_stats"]["library_ms"],
        bound=mean_bound(lambda c: 2 * sum(live(c)) * T3_HEADS * HEAD_DIM * 2 + vec_bytes,
                         k1_flops))
    rows["flash_decode_layer_attention"]["extra"] = {
        "S": s_cache, "cur_len": cur_len, "ms_s1152": k1a_same_ms,
        "library_ms_s1152": k1a_1152["library_ms"], "bound_ms_s1152": k1a_1152["bound"][0],
        "cur_len_s1152": f"{curs[0]}-{curs[-1]}"}
    print(f"kernel flash_decode_layer_attention at S = {s_1000}: {k1a_same_ms:.5f} ms; "
          f"SDPA {k1a_1152['library_ms']:.5f} ms; bound {k1a_1152['bound'][0]:.5f} ms "
          f"({k1a_1152['bound'][0] / k1a_same_ms:.1%})", flush=True)
    del kv_lib

    # K1c+d: the int8 cache below merge_base, the bf16 tail from there on;
    # the main cache slots at and past merge_base are never read
    def k1c(i, plain=False, cur=None):
        """Timed launch i (K1c+d, or its plain version), at cur_len cur
        where given: the kernel derives merge_base from its cur_len."""
        layer, c = i % T3_LAYERS, curs[i % TAIL_W] if cur is None else cur
        tail = tails[c // TAIL_W * TAIL_W]
        if plain:
            return fd.flash_decode_layer_attention_int8_plain(
                cache8, scales, tail, None, layer, c, row_prefix, gap_end, q, kn, vn)
        c_dev = curs_dev[i % TAIL_W] if cur is None else dpos(cur)
        return fd.flash_decode_layer_attention_int8(
            cache8, scales, tail, None, layer, c_dev, row_prefix, gap_end, q, kn, vn)

    checks = [check_kernel(f"flash_decode_layer_attention_int8 (cur_len {c})",
                           k1c(TAIL_W // 2, cur=c), k1c(TAIL_W // 2, True, c))
              for c in phase_curs]
    want = k1c(TAIL_W // 2, True)  # layer 4 at c_lib
    checks.append(check_kernel("flash_decode_layer_attention_int8", k1c(TAIL_W // 2), want))
    err, tol, share = worst_check(checks)
    check_repeat("flash_decode_layer_attention_int8", lambda: k1c(TAIL_W // 2))
    deq = (cache8.float() * scales[..., None]).to(bf)  # the library's input, made once
    mb_lib = c_lib // TAIL_W * TAIL_W
    deq[:, :, :, :, mb_lib:mb_lib + TAIL_W] = tails[mb_lib]
    kv_lib, lib = sdpa_library(deq)
    del deq
    lib_err = library_err("flash_decode_layer_attention_int8", lib(TAIL_W // 2), want)
    rows["flash_decode_layer_attention_int8"] = dict(
        err=err, tol=tol, share=share, library_err=lib_err,
        ms=timed(rotating(k1c, T3_LAYERS * TAIL_W), 240),
        plain_ms=timed(rotating(lambda i: k1c(i, True), T3_LAYERS * TAIL_W), 60),
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

    # K2b: launched every step with the step's write slot, it merges the
    # full tail into the int8 cache where the slot closes it (the prefill
    # takes the same kernel with n = s0 tokens); bit-exact at the slots of
    # phases 7 (a merge), 0 and 1 (none: the cache is left bit for bit)
    tail = next(iter(tails.values()))
    merge_w = [s0 // TAIL_W * TAIL_W + TAIL_W * j + TAIL_W - 1
               for j in range(MAX_NEW_DEFAULT // TAIL_W)]  # each merge's write slot
    checks = []
    for w in (merge_w[7], merge_w[7] + 1, merge_w[7] + 2):
        a = (cache8.clone(), scales.clone())
        b = (cache8.clone(), scales.clone())
        fd.kv_cache_quantize_write(*a, tail, dpos(w))
        fd.kv_cache_quantize_write_plain(*b, tail, w)
        checks.append(check_kernel(f"kv_cache_quantize_write (write slot {w})", a[0], b[0],
                                   exact=True))
        check_kernel(f"kv_cache_quantize_write (write slot {w}, scales)", a[1], b[1], exact=True)
        if (w + 1) % TAIL_W and not (torch.equal(a[0], cache8) and torch.equal(a[1], scales)):
            fail(f"kv_cache_quantize_write: write slot {w} closes no tail, yet the cache changed")
        del a, b
    err, tol, share = worst_check(checks)
    merge_dev = [dpos(w) for w in merge_w]
    off_dev = [dpos(w + 1) for w in merge_w]  # the steps that merge nothing
    n_tok = tail.numel() // HEAD_DIM
    rows["kv_cache_quantize_write"] = dict(
        err=err, tol=tol, share=share, library_err=None,
        ms=timed(rotating(lambda i: fd.kv_cache_quantize_write(cache8, scales, tail, merge_dev[i]),
                          len(merge_w)), 125),
        plain_ms=timed(rotating(lambda i: fd.kv_cache_quantize_write_plain(
            cache8, scales, tail, merge_w[i]), len(merge_w)), 125),
        library_ms=None, library_note="no single PyTorch call quantizes per token",
        bound=bound(n_tok * (HEAD_DIM * 2 + HEAD_DIM + 4), 4 * n_tok * HEAD_DIM),
    )
    # the 7 launches of 8 whose slot closes no tail: each returns at once
    off_ms = timed(rotating(lambda i: fd.kv_cache_quantize_write(cache8, scales, tail, off_dev[i]),
                            len(merge_w)), 125)
    # ... and the prefill's launch: the s0 = 100 prefix tokens of every
    # (layer, k/v, row, head) at slot 0, bit-exact too; the ~98 MB of bf16
    # input does not stay in the 50 MB L2 between launches
    prefix = randn(T3_LAYERS, 2, ROWS, T3_HEADS, s0, HEAD_DIM)
    a = (cache8.clone(), scales.clone())
    b = (cache8.clone(), scales.clone())
    pre_dev = dpos(s0 - 1)  # the write slot of the prefix's last token
    fd.kv_cache_quantize_write(*a, prefix, pre_dev)
    fd.kv_cache_quantize_write_plain(*b, prefix, s0 - 1)
    check_kernel(f"kv_cache_quantize_write (prefill, n = {s0})", a[0], b[0], exact=True)
    check_kernel(f"kv_cache_quantize_write (prefill, n = {s0}, scales)", a[1], b[1], exact=True)
    del a, b
    n_pre = prefix.numel() // HEAD_DIM
    pre_bound = bound(n_pre * (HEAD_DIM * 2 + HEAD_DIM + 4), 4 * n_pre * HEAD_DIM)
    pre_ms = timed(lambda: fd.kv_cache_quantize_write(cache8, scales, prefix, pre_dev), 20)
    pre_plain_ms = timed(lambda: fd.kv_cache_quantize_write_plain(cache8, scales, prefix,
                                                                  s0 - 1), 5)
    rows["kv_cache_quantize_write"]["extra"] = {
        "n": TAIL_W, "ms_no_merge": off_ms, "ms_prefill": pre_ms,
        "plain_ms_prefill": pre_plain_ms, "bound_ms_prefill": pre_bound[0], "n_prefill": s0}
    k2b = rows["kv_cache_quantize_write"]
    print(f"kernel kv_cache_quantize_write: n = {TAIL_W}: {k2b['ms']:.5f} ms, "
          f"{k2b['bound'][0] / k2b['ms']:.1%} of its {k2b['bound'][0]:.5f} ms bound; a step "
          f"that merges nothing {off_ms:.5f} ms; prefill "
          f"n = {s0}: {pre_ms:.5f} ms, {pre_bound[0] / pre_ms:.1%} of its {pre_bound[0]:.5f} ms "
          f"bound (plain {pre_plain_ms:.5f} ms)", flush=True)
    del cache8, scales, tails, tail, prefix

    # ---- K3 and K5: the UNet's self-attention, 16 CFG rows x 8 heads of 64,
    # from the packed to_qkv output (K3) and on (B, H, T, D) q, k, v (K5, the
    # unfused layout), at the padded mel lengths of paths A, E and B. Each
    # timed launch reads the next of enough input sets to pass 4x the 50 MB
    # L2, as the main path's launches (one a transformer block) do. K3 and K5
    # run one kernel body: on the same q, k, v they must agree bit for bit.
    hd = FLOW_HEADS * HEAD_DIM
    attn_runs = {"flash_self_attention_packed": [], "flash_self_attention": []}
    for t_pad, t_valid in SELF_ATTN_T:
        set_bytes = 3 * ROWS * FLOW_HEADS * t_pad * HEAD_DIM * 2
        n_sets = max(2, -(-200 * 2**20 // set_bytes))
        bias_t = torch.where(torch.arange(t_pad, device=dev)[None] < t_valid, 0.0, -1.0e10)
        bias_t = bias_t.expand(ROWS, t_pad).contiguous().float()
        bias_4 = bias_t[:, None, None, :].to(bf)
        flops = 4 * ROWS * FLOW_HEADS * t_pad * t_pad * HEAD_DIM
        # each input read once, the output written once
        t_bound = bound(set_bytes * 4 // 3 + bias_t.numel() * 4, flops)
        packed = [randn(ROWS, t_pad, 3 * hd) for _ in range(n_sets)]

        def split(x, i):  # (B, T, 3HD) -> band i as (B, H, T, D)
            return x[..., i * hd:(i + 1) * hd].unflatten(-1, (FLOW_HEADS, HEAD_DIM)).transpose(1, 2)

        qkv = packed[0]
        want = fa.flash_self_attention_packed_plain(qkv, bias_t, FLOW_HEADS)
        got3 = fa.flash_self_attention_packed(qkv, bias_t, FLOW_HEADS)
        qkv_abs_v = torch.cat([qkv[..., :2 * hd], qkv[..., 2 * hd:].abs()], dim=-1)
        err, tol, share = check_kernel(f"flash_self_attention_packed (T = {t_pad})", got3, want,
                                       fa.flash_self_attention_packed_plain(qkv_abs_v, bias_t,
                                                                            FLOW_HEADS))
        del qkv_abs_v
        lib_err = library_err(f"flash_self_attention_packed (T = {t_pad})",
                              F.scaled_dot_product_attention(
                                  *(split(qkv, i) for i in range(3)),
                                  attn_mask=bias_4).transpose(1, 2).flatten(2), want)
        del want
        lib_sets = [tuple(split(x, i) for i in range(3)) for x in packed]  # strided views
        iters = 50 if t_pad <= 1024 else 20
        attn_runs["flash_self_attention_packed"].append(dict(
            T=t_pad, err=err, tol=tol, share=share, library_err=lib_err, n_sets=n_sets,
            ms=timed(rotating(lambda i: fa.flash_self_attention_packed(packed[i], bias_t,
                                                                        FLOW_HEADS), n_sets), iters),
            plain_ms=timed(rotating(lambda i: fa.flash_self_attention_packed_plain(
                packed[i], bias_t, FLOW_HEADS), n_sets), max(2, iters // 5)),
            library_ms=timed(rotating(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i], attn_mask=bias_4), n_sets), iters),
            bound=t_bound,
        ))
        del lib_sets
        sets = [tuple(split(x, i).contiguous() for i in range(3)) for x in packed]
        del packed, qkv
        q5, k5, v5 = sets[0]
        got5 = fa.flash_self_attention(q5, k5, v5, bias_t)
        torch.cuda.synchronize()
        same = torch.equal(got5.transpose(1, 2).flatten(2), got3)
        print(f"kernel flash_self_attention (T = {t_pad}): bit-identical to "
              f"flash_self_attention_packed on the same q, k, v: {same}", flush=True)
        if not same:
            fail(f"flash_self_attention and flash_self_attention_packed disagree at T = {t_pad}")
        del got3
        want = fa.flash_self_attention_plain(q5, k5, v5, bias_t)
        err, tol, share = check_kernel(f"flash_self_attention (T = {t_pad})", got5, want,
                                       fa.flash_self_attention_plain(q5, k5, v5.abs(), bias_t))
        lib_err = library_err(f"flash_self_attention (T = {t_pad})",
                              F.scaled_dot_product_attention(q5, k5, v5, attn_mask=bias_4), want)
        del want, got5
        attn_runs["flash_self_attention"].append(dict(
            T=t_pad, err=err, tol=tol, share=share, library_err=lib_err, n_sets=n_sets,
            ms=timed(rotating(lambda i: fa.flash_self_attention(*sets[i], bias_t), n_sets), iters),
            plain_ms=timed(rotating(lambda i: fa.flash_self_attention_plain(*sets[i], bias_t),
                                    n_sets), max(2, iters // 5)),
            library_ms=timed(rotating(lambda i: F.scaled_dot_product_attention(
                *sets[i], attn_mask=bias_4), n_sets), iters),
            bound=t_bound,
        ))
        del sets, q5, k5, v5
        torch.cuda.empty_cache()
    # each row holds path A's T; the other T's figures beside it
    for name, runs in attn_runs.items():
        first = runs[0]
        extra = {"T": first["T"], "input_sets": {str(r["T"]): r["n_sets"] for r in runs}}
        for r in runs[1:]:
            t = r["T"]
            extra.update({f"ms_t{t}": r["ms"], f"plain_ms_t{t}": r["plain_ms"],
                          f"library_ms_t{t}": r["library_ms"], f"bound_ms_t{t}": r["bound"][0],
                          f"max_abs_err_t{t}": r["err"], f"err_share_of_tol_t{t}": r["share"]})
        rows[name] = dict(first, err=max(r["err"] for r in runs),
                          share=max(r["share"] for r in runs),
                          library_err=max(r["library_err"] for r in runs), extra=extra)

    # ---- K4: conformer rel-pos attention, 8 rows, the 50 Hz (upsampled) layers,
    # at path A's T and path B's
    cd = CONF_C
    dk = cd // CONF_HEADS
    scale = 1.0 / math.sqrt(dk)
    k4_runs = []
    for t_conf, t_valid in (SELF_ATTN_T[0], SELF_ATTN_T[-1]):
        q_u, k, v = (randn(N_TEXTS, t_conf, cd, scale=0.5) for _ in range(3))
        q_hat = randn(N_TEXTS, t_conf, CONF_HEADS * cd, scale=0.5)
        s_hat = randn(1, t_conf, cd, scale=0.7)
        bias = torch.where(torch.arange(t_conf, device=dev)[None] < t_valid, 0.0, -1.0e10)
        bias = bias.expand(N_TEXTS, t_conf).contiguous().float()
        kargs = (q_u, q_hat, k, s_hat, v, bias, CONF_HEADS, scale)
        want = fa.flash_relpos_attention_plain(*kargs)
        err, tol, share = check_kernel(
            f"flash_relpos_attention (T = {t_conf})", fa.flash_relpos_attention(*kargs), want,
            fa.flash_relpos_attention_plain(q_u, q_hat, k, s_hat, v.abs(), bias, CONF_HEADS,
                                            scale))

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
        k4_runs.append(dict(
            T=t_conf, err=err, tol=tol, share=share,
            library_err=library_err(f"flash_relpos_attention (T = {t_conf})",
                                    k4_library().transpose(1, 2).flatten(2), want),
            ms=timed(lambda: fa.flash_relpos_attention(*kargs), 50 if t_conf <= 1024 else 20),
            plain_ms=timed(lambda: fa.flash_relpos_attention_plain(*kargs), 10 if t_conf <= 1024
                           else 4),
            library_ms=timed(k4_library, 50 if t_conf <= 1024 else 20),
            bound=bound(k4_bytes, k4_flops),
        ))
        del q_u, k, v, q_hat, s_hat, q_cat, k_cat, s_heads, v_h, want
        torch.cuda.empty_cache()
    short, long = k4_runs
    t_b = long["T"]
    rows["flash_relpos_attention"] = dict(
        short, err=max(short["err"], long["err"]), share=max(short["share"], long["share"]),
        library_err=max(short["library_err"], long["library_err"]),
        extra={"T": short["T"], f"ms_t{t_b}": long["ms"], f"plain_ms_t{t_b}": long["plain_ms"],
               f"library_ms_t{t_b}": long["library_ms"], f"bound_ms_t{t_b}": long["bound"][0],
               f"max_abs_err_t{t_b}": long["err"], f"err_share_of_tol_t{t_b}": long["share"]},
    )
    torch.cuda.synchronize()
    return rows


# the Granite cell's shapes (tts-granite4h-b64-t250): 64 texts, so 128 CFG
# rows; Mamba-2 layers of 64 heads of 64 with a state of 128 and a conv of
# width 4 over 4096 + 2 * 128 channels; attention layers of 32 query heads
# on 8 KV heads of 64, softmax scale 1/64
G_TEXTS = 64
G_ROWS = 2 * G_TEXTS
G_HEADS, G_HEAD, G_STATE, G_CONV = 64, 64, 128, 4
G_CONV_DIM = G_HEADS * G_HEAD + 2 * G_STATE
G_QHEADS, G_KVHEADS = 32, 8
G_STEPS = 4  # consecutive update steps held against the plain version
# the update against its plain version, both fp32 inside: elementwise
#     |got - want| <= 2^-14 (|want| + mean |want|)
# the kernel's exp, softplus and SiLU (fast intrinsics, a few ulp) and its
# order of the 128-term sum y = s.C part the two by a few fp32 ulp of the
# terms, not of the result, which may cancel: the mean |want| over the
# tensor (the typical value) carries that; G_STEPS steps compound it
G_RTOL = 2.0 ** -14


def granite_kernel_checks(rows):
    """The two kernels of the Granite backbone's decode step at the cell's
    shapes: ``ssm_decode_update`` over ``G_STEPS`` consecutive steps (y, the
    state and the conv inputs after each) against its plain version, timed
    against it and its bound (a new row), and K1a with 4 query heads a KV
    head and the scale 1/64 at the three cur_len % 8 phases against its
    plain version, timed against it, SDPA with the grouped K/V, and its
    bound (``_g4`` figures in K1a's row)."""
    import torch
    import torch.nn.functional as F

    from chatterbox_tpu_torch.ops import flash_decode as fd
    from chatterbox_tpu_torch.ops import ssm_decode as sd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # ---- the Mamba-2 update: 128 rows x 64 heads x 64 x 128 fp32 state (256
    # MiB a layer) over 4 layers, each timed launch the next layer's
    n_layers = 4
    ssm = randn(n_layers, G_ROWS, G_HEADS, G_HEAD, G_STATE, scale=0.3, dtype=torch.float32)
    conv = randn(n_layers, G_ROWS, G_CONV_DIM, G_CONV - 1)
    a_log = torch.log(1 + 15 * torch.rand(G_HEADS, generator=g, device=dev))
    dt = torch.exp(math.log(1e-3) + math.log(100) * torch.rand(G_HEADS, generator=g, device=dev))
    vec = dict(conv_w=randn(G_CONV_DIM, G_CONV, scale=0.5, dtype=torch.float32),
               conv_b=randn(G_CONV_DIM, scale=0.02, dtype=torch.float32),
               dt_bias=(dt + torch.log(-torch.expm1(-dt))).contiguous(),
               A=(-torch.exp(a_log)).contiguous(), D=torch.ones(G_HEADS, device=dev))
    in_dim = G_HEADS * G_HEAD + G_CONV_DIM + G_HEADS
    zx = [randn(G_ROWS, in_dim) for _ in range(n_layers)]
    ssm_p, conv_p = ssm[1:2].clone(), conv[1:2].clone()
    err, share = 0.0, 0.0
    for step in range(G_STEPS):
        x = zx[step % n_layers]
        got = sd.ssm_decode_update(conv, ssm, 1, x, *vec.values())
        want = sd.ssm_decode_update_plain(conv_p, ssm_p, 0, x, *vec.values())
        torch.cuda.synchronize()
        for what, a, b in (("y", got, want), ("state", ssm[1], ssm_p[0])):
            if not bool(torch.isfinite(a).all()):
                fail(f"ssm_decode_update: step {step}: {what} is not finite")
            diff = (a - b).abs()
            limit = G_RTOL * (b.abs() + b.abs().mean())
            err, share = max(err, float(diff.max())), max(share, float((diff / limit).max()))
        if not torch.equal(conv[1], conv_p[0]):
            fail(f"ssm_decode_update: step {step}: the conv inputs differ from the plain "
                 "version's")
    print(f"kernel ssm_decode_update ({G_ROWS} rows, {G_HEADS} heads of {G_HEAD} x {G_STATE}, "
          f"{G_STEPS} steps): max_abs_err={err:.3e}, worst element at {share:.3f} of its limit "
          f"|err| <= 2^-14 (|want| + mean |want|); conv inputs bit for bit", flush=True)
    if not share <= 1.0:
        fail(f"ssm_decode_update: an element exceeds its limit by {share:.3f}x")
    del ssm_p, conv_p, got, want
    # each row's state read and written, its conv inputs read and written, its
    # xBC and dt read (bf16) and y written (fp32); the layer's conv weights and
    # head vectors once; 5 operations a state value, 9 a conv channel
    state = G_HEADS * G_HEAD * G_STATE
    up_bytes = (G_ROWS * (2 * 4 * state + 2 * 2 * G_CONV_DIM * (G_CONV - 1)
                          + 2 * (G_CONV_DIM + G_HEADS) + 4 * G_HEADS * G_HEAD)
                + 4 * G_CONV_DIM * (G_CONV + 1) + 3 * 4 * G_HEADS)
    up_flops = G_ROWS * (5 * state + 9 * G_CONV_DIM)
    rows["ssm_decode_update"] = dict(
        err=err, tol="2^-14 (|want| + mean |want|) over 4 steps; conv inputs exact",
        share=share, library_err=None,
        ms=timed(rotating(lambda i: sd.ssm_decode_update(conv, ssm, i, zx[i], *vec.values()),
                          n_layers), 40),
        plain_ms=timed(rotating(lambda i: sd.ssm_decode_update_plain(
            conv, ssm, i, zx[i], *vec.values()), n_layers), 8),
        library_ms=None, library_note="no PyTorch call runs the Mamba-2 step",
        bound=bound(up_bytes, up_flops),
        extra={"rows": G_ROWS, "heads": G_HEADS, "state": [G_HEAD, G_STATE]},
    )
    del ssm, conv, zx
    torch.cuda.empty_cache()

    # ---- K1a, G = 4: 4 attention layers' cache of 128 rows x 8 KV heads at
    # the cell's budget (S = 384), mid-decode, each timed launch the next layer
    s0 = N_COND + TEXT_BUCKET + N_BOS
    s_cache = -(-(s0 + MAX_NEW) // 128) * 128
    cur_len = s0 + MAX_NEW // 2
    n_attn = 4
    cache = randn(n_attn, 2, G_ROWS, G_KVHEADS, s_cache, HEAD_DIM)
    q = randn(G_ROWS, G_QHEADS, HEAD_DIM)
    kn, vn = (randn(G_ROWS, G_KVHEADS, HEAD_DIM) for _ in range(2))
    text_lens = torch.randint(20, TEXT_BUCKET, (G_TEXTS,), generator=g, device=dev)
    row_prefix = (N_COND + text_lens).repeat(2).to(torch.int32).contiguous()
    gap_end = N_COND + TEXT_BUCKET
    scale = 1 / 64
    checks = []
    for c in (cur_len, cur_len // TAIL_W * TAIL_W, cur_len // TAIL_W * TAIL_W + TAIL_W - 1):
        want = fd.flash_decode_layer_attention_plain(cache, 2, c, row_prefix, gap_end, q, kn, vn,
                                                     scale=scale)
        checks.append(check_kernel(f"flash_decode_layer_attention (G = 4, cur_len {c})",
                                   fd.flash_decode_layer_attention(
                                       cache, 2, fd.device_position(c, dev), row_prefix, gap_end,
                                       q, kn, vn, scale=scale), want))
    cur_dev = fd.device_position(cur_len, dev)
    check_repeat("flash_decode_layer_attention (G = 4)", lambda: fd.flash_decode_layer_attention(
        cache, 2, cur_dev, row_prefix, gap_end, q, kn, vn, scale=scale))
    idx = torch.arange(cur_len, device=dev)
    valid = (idx[None] < row_prefix[:, None]) | (idx[None] >= gap_end)
    new = torch.stack([kn, vn])[None, :, :, :, None].expand(n_attn, 2, -1, -1, -1, -1)
    kv_lib = torch.cat([cache[:, :, :, :, :cur_len], new], dim=4)
    m_lib = torch.cat([valid, torch.ones_like(valid[:, :1])], dim=1)[:, None, None, :]

    def library(i):
        return F.scaled_dot_product_attention(q[:, :, None], kv_lib[i, 0], kv_lib[i, 1],
                                              attn_mask=m_lib, scale=scale,
                                              enable_gqa=True)[:, :, 0]

    want = fd.flash_decode_layer_attention_plain(cache, 2, cur_len, row_prefix, gap_end, q, kn,
                                                 vn, scale=scale)
    lib_err = library_err("flash_decode_layer_attention (G = 4)", library(2), want)
    n_valid = int(valid.sum()) + G_ROWS  # (row, slot) pairs read, the new token's included
    g4_bytes = (2 * n_valid * G_KVHEADS * HEAD_DIM * 2 + 2 * G_ROWS * G_QHEADS * HEAD_DIM * 2
                + 2 * G_ROWS * G_KVHEADS * HEAD_DIM * 2 + G_ROWS * 4)
    g4_flops = 4 * n_valid * G_QHEADS * HEAD_DIM
    g4_ms = timed(rotating(lambda i: fd.flash_decode_layer_attention(
        cache, i, cur_dev, row_prefix, gap_end, q, kn, vn, scale=scale), n_attn), 300)
    g4_plain_ms = timed(rotating(lambda i: fd.flash_decode_layer_attention_plain(
        cache, i, cur_len, row_prefix, gap_end, q, kn, vn, scale=scale), n_attn), 60)
    g4_lib_ms = timed(rotating(library, n_attn), 300)
    g4_bound = bound(g4_bytes, g4_flops)
    err = max(c[0] for c in checks)
    share = max(c[2] for c in checks)
    k1 = rows["flash_decode_layer_attention"]
    k1["err"], k1["share"] = max(k1["err"], err), max(k1["share"], share)
    k1.setdefault("extra", {}).update({
        "rows_g4": G_ROWS, "kv_heads_g4": G_KVHEADS, "S_g4": s_cache, "cur_len_g4": cur_len,
        "ms_g4": g4_ms, "plain_ms_g4": g4_plain_ms, "library_ms_g4": g4_lib_ms,
        "bound_ms_g4": g4_bound[0], "max_abs_err_g4": err, "err_share_of_tol_g4": share,
        "library_max_abs_err_g4": lib_err})
    print(f"kernel flash_decode_layer_attention (G = 4, {G_ROWS} rows x {G_KVHEADS} KV heads, "
          f"S = {s_cache}): {g4_ms:.5f} ms, {g4_bound[0] / g4_ms:.1%} of its {g4_bound[0]:.5f} ms "
          f"bound; plain {g4_plain_ms:.5f} ms; SDPA (enable_gqa) {g4_lib_ms:.5f} ms", flush=True)
    del cache, kv_lib
    torch.cuda.empty_cache()


# the glue kernels of T3's Llama decode step at cell A's shapes: 128 CFG
# rows of hidden 1024, 16 heads of 64, FFN 4096
GLUE_ROWS, T3_HIDDEN, T3_FFN = 128, 1024, 4096
_GLUE = ("add_rms_norm", "rope_split_kv", "silu_mul")


def glue_launches(layers, steps):
    """{glue kernel: launches} of ``steps`` decode steps of a Llama T3 of
    ``layers`` layers, whatever its dtype, cache, watchdog or weights: each
    kernel once a layer a step, the norm twice and once more at the end."""
    return {"add_rms_norm": (2 * layers + 1) * steps, "rope_split_kv": layers * steps,
            "silu_mul": layers * steps}


def glue_kernel_checks(rows):
    """The decode step's three glue kernels (``ops/decode_glue.py``) at cell
    A's shapes, each against its plain version (the residual add, rope with
    the K/V split, and silu_mul bit for bit; the norm within the bf16 limit,
    its differing elements counted), each timed over T3_LAYERS layers'
    inputs against its plain version and its bound; the norm also beside
    ``F.rms_norm`` (the norm alone, no residual add) as a yardstick."""
    import torch
    import torch.nn.functional as F

    from chatterbox_tpu_torch.models.t3.llama import LlamaConfig, rope_cos_sin
    from chatterbox_tpu_torch.ops import decode_glue as dg

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    bf, n, c, f, h, d = torch.bfloat16, GLUE_ROWS, T3_HIDDEN, T3_FFN, T3_HEADS, HEAD_DIM
    eps = 1e-5

    def randn(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    # ---- add_rms_norm: a layer's first norm (no residual), a norm after a
    # projection, the final norm
    xs = [randn(n, 1, c, scale=4.0) for _ in range(T3_LAYERS)]
    rs = [randn(n, 1, c) for _ in range(T3_LAYERS)]
    scales = [randn(c) + 1 for _ in range(T3_LAYERS)]
    checks, n_diff = [], 0
    for case, r in (("layer0", None), ("residual", rs[0].clone()), ("final", rs[1].clone())):
        want_h, want_y = dg.add_rms_norm_plain(xs[0], r, scales[0], eps)
        want_h = want_h.clone()
        got_h, got_y = dg.add_rms_norm(xs[0], r, scales[0], eps)
        check_kernel(f"add_rms_norm ({case}: h)", got_h, want_h, exact=True)
        checks.append(check_kernel(f"add_rms_norm ({case}: y)", got_y, want_y))
        n_diff += int((got_y != want_y).sum())
    print(f"kernel add_rms_norm: {n_diff} of {3 * n * c} normed values differ from the plain "
          "version's (its mean is an fp32 sum in another order)", flush=True)
    err, tol, share = max(x[0] for x in checks), checks[0][1], max(x[2] for x in checks)
    lib_err = library_err("add_rms_norm (F.rms_norm, the norm alone)",
                          F.rms_norm(xs[0], (c,), scales[0], eps),
                          dg.add_rms_norm_plain(xs[0], None, scales[0], eps)[1])
    rows["add_rms_norm"] = dict(
        err=err, tol=tol, share=share, library_err=lib_err,
        # each timed launch adds into the next layer's r
        ms=timed(rotating(lambda i: dg.add_rms_norm(xs[i], rs[i], scales[i], eps), T3_LAYERS),
                 300),
        plain_ms=timed(rotating(lambda i: dg.add_rms_norm_plain(xs[i], rs[i], scales[i], eps),
                                T3_LAYERS), 60),
        library_ms=timed(rotating(lambda i: F.rms_norm(xs[i], (c,), scales[i], eps),
                                  T3_LAYERS), 300),
        library_note="F.rms_norm: the norm alone, without the residual add",
        bound=bound(4 * n * c * 2 + c * 2, 5 * n * c),
        extra={"rows": n, "width": c, "differing_values": n_diff},
    )
    del xs, rs

    # ---- rope_split_kv: the fused qkv product's views, the step's K/V
    qkvs = [randn(n, 1, 3 * h * d, scale=3.0) for _ in range(T3_LAYERS)]
    views = [q.split([h * d] * 3, dim=-1) for q in qkvs]
    pos = torch.randint(40, 400, (n, 1), generator=g, device=dev)
    cos, sin = rope_cos_sin(LlamaConfig(), pos)
    new_kv = torch.zeros((T3_LAYERS, 2, n, h, d), dtype=bf, device=dev)
    want_kv = new_kv.clone()
    want_q = dg.rope_split_kv_plain(*views[0], cos, sin, want_kv, 0)
    got_q = dg.rope_split_kv(*views[0], cos, sin, new_kv, 0)
    err, tol, share = check_kernel("rope_split_kv (q)", got_q, want_q, exact=True)
    check_kernel("rope_split_kv (k, v)", new_kv, want_kv, exact=True)
    rows["rope_split_kv"] = dict(
        err=err, tol=tol, share=share, library_err=None,
        ms=timed(rotating(lambda i: dg.rope_split_kv(*views[i], cos, sin, new_kv, i), T3_LAYERS),
                 300),
        plain_ms=timed(rotating(lambda i: dg.rope_split_kv_plain(*views[i], cos, sin, new_kv, i),
                                T3_LAYERS), 60),
        library_ms=None, library_note="no PyTorch call applies rope",
        bound=bound(2 * 3 * n * h * d * 2 + 2 * n * d * 4, 6 * 2 * n * h * d),
        extra={"rows": n, "heads": h},
    )
    del qkvs, views, new_kv, want_kv

    # ---- silu_mul: the gate_up product (N, 2F)
    gus = [randn(n, 1, 2 * f, scale=2.0) for _ in range(T3_LAYERS)]
    err, tol, share = check_kernel("silu_mul", dg.silu_mul(gus[0]), dg.silu_mul_plain(gus[0]),
                                   exact=True)
    rows["silu_mul"] = dict(
        err=err, tol=tol, share=share, library_err=None,
        ms=timed(rotating(lambda i: dg.silu_mul(gus[i]), T3_LAYERS), 300),
        plain_ms=timed(rotating(lambda i: dg.silu_mul_plain(gus[i]), T3_LAYERS), 60),
        library_ms=None, library_note="no single PyTorch call: F.silu and a multiply",
        bound=bound(3 * n * f * 2, 5 * n * f),
        extra={"rows": n, "ffn": f},
    )
    del gus
    torch.cuda.empty_cache()


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
    function, that call. P2 and P3 hold each variant bit for bit at four
    slots and time it as the scripts do: a chain of 30 writes at slot 200,
    here in one CUDA graph, and once cold; K2 writes the same column into
    the port's (S, D) cache beside them. Returns one row per probe, its
    variants under it."""
    import torch

    from chatterbox_tpu_torch.ops import flash_decode as fd
    from chatterbox_tpu_torch.ops import probes as pk
    from chatterbox_tpu_torch.probes import cache_write, cold_ms, int8_cache, ops

    dev = torch.device("cuda")
    rows = {}
    # the launch floor: an empty kernel (one thread, no memory) timed as the
    # probes are; every probe's bound is far below it
    floor_ms = timed(lambda: torch.cuda._sleep(0), 500)

    # ---- P1: the copy of q (16 CFG rows x 16 heads x 64) in each layer's
    # attention slot, launched with programmatic dependent launch (PDL)
    g = torch.Generator(device=dev).manual_seed(1)
    q = torch.randn((ROWS, T3_HEADS, HEAD_DIM), generator=g, device=dev).to(torch.bfloat16)
    err, tol, share = check_kernel("noop_copy", pk.noop_copy(q), pk.noop_copy_plain(q), exact=True)
    versions = pk.cuda_versions()
    rows["P1"] = dict(
        name="noop_copy", err=err, tol=tol, share=share, library_err=0.0,
        ms=timed(lambda: pk.noop_copy(q), 500), plain_ms=timed(lambda: pk.noop_copy_plain(q), 500),
        library_ms=timed(lambda: q.clone(), 500),
        library_note="q.clone(), which is also the plain version",
        bound=bound(2 * q.numel() * 2, 0),
        extra={"floor_ms": floor_ms, "cuda_runtime": versions["runtime"],
               "cuda_driver": versions["driver"]},
    )
    p1 = rows["P1"]
    print(f"kernel noop_copy: {p1['ms']:.5f} ms chained (PDL), clone {p1['library_ms']:.5f} ms, "
          f"launch floor {floor_ms:.5f} ms; CUDA runtime {versions['runtime']}, driver "
          f"{versions['driver']}", flush=True)

    # ---- P2, P3: one column into the (30, 2, 16, 16, 64, 384) bf16 cache.
    # Every variant launches one column-write kernel; each is held bit for
    # bit at slots 0, 7 (not 8-aligned), 200 and S - 1, timed as a chain of
    # 30 writes at slot 200 and once with the L2 flushed (``cold_ms``)
    cache, new = cache_write.make_inputs(dev)
    pos = cache_write.POS
    slots = (0, 7, pos, cache.shape[-1] - 1)
    want = pk.cache_column_write_plain(cache.clone(), new, pos)
    pos_idx = torch.tensor([pos], device=dev)
    lib_err = library_err("cache column write", cache.clone().index_copy_(5, pos_idx, new), want)
    col_bound = bound(cache_write.moved_bytes(cache.shape), 0)  # the column read and written once
    plain_ms = timed(lambda: pk.cache_column_write_plain(cache, new, pos), cache_write.CHAIN)
    library_ms = timed(lambda: cache.index_copy_(5, pos_idx, new), cache_write.CHAIN)
    library_cold = cold_ms(lambda: cache.index_copy_(5, pos_idx, new))
    sd = cache.transpose(-1, -2).contiguous()
    new_sd = new[..., 0].contiguous()
    pos_dev = fd.device_position(pos, dev)
    got = fd.kv_cache_append(sd.clone(), new_sd, pos_dev)
    k2_err, _, _ = check_kernel("kv_cache_append (P2/P3 shapes, (S, D))", got,
                                fd.kv_cache_append_plain(sd.clone(), new_sd, pos), exact=True)
    k2 = {"layout": "(S, D)", "ms": timed(lambda: fd.kv_cache_append(sd, new_sd, pos_dev),
                                           cache_write.CHAIN),
          "bound_ms": col_bound[0], "max_abs_err": k2_err}
    del sd, got

    def measured(label, write):
        # the timed writes leave new at slot pos: each check starts from the
        # cache as it is
        for s in slots:
            want_s = pk.cache_column_write_plain(cache.clone(), new, s)
            got = write(cache.clone(), s)
            torch.cuda.synchronize()
            if not torch.equal(got, want_s):
                err = float((got.float() - want_s.float()).abs().max())
                fail(f"{label}: slot {s} differs from the slice assignment (max |err| {err:.3e})")
            del got, want_s
        cold, least, most = cold_ms(lambda: write(cache, pos))
        r = {"ms": timed(lambda: write(cache, pos), cache_write.CHAIN),
             "cold_ms": cold, "cold_spread_ms": [least, most],
             "max_abs_err": 0.0, "slots_exact": list(slots),
             "moved_bytes": cache_write.moved_bytes(cache.shape),
             "sectors_written": cache_write.sectors_written(cache.shape)}
        print(f"kernel {label}: bit for bit at slots {list(slots)}; chain {r['ms']:.5f} ms, "
              f"cold {cold:.5f} ms ({least:.5f}-{most:.5f}; index_copy_ {library_ms:.5f}, "
              f"cold {library_cold[0]:.5f} ({library_cold[1]:.5f}-{library_cold[2]:.5f}))",
              flush=True)
        return r

    for script, headline in (("P2", "rmw b_blk=8 kvsep"), ("P3", "col b_blk=16")):
        variants = {name: measured(f"{script} {name}",
                                   lambda c, s, v=var: cache_write.write(c, new, s, v))
                    for (sc, name), var in cache_write.VARIANTS.items() if sc == script}
        variants["K2 kv_cache_append on (S, D), beside"] = k2
        h = variants[headline]
        rows[script] = dict(
            name="cache_column_write" if headline.startswith("col") else "cache_block_rmw",
            headline_variant=headline, err=max(v["max_abs_err"] for v in variants.values()),
            tol="exact", share=0.0, library_err=lib_err,
            ms=h["ms"], plain_ms=plain_ms, library_ms=library_ms,
            library_note="index_copy_ of the column", bound=col_bound, variants=variants,
            extra={"cold_ms": h["cold_ms"], "cold_spread_ms": h["cold_spread_ms"],
                   "library_cold_ms": library_cold[0],
                   "library_cold_spread_ms": list(library_cold[1:])})
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
    # each case held on the probe's inputs and on a second seeded set over
    # the whole int8 range with signed scales; timed on the probe's inputs
    wide = int8_cache.wide_inputs(dev)
    variants = {}
    for case in pk.INT8_CASES:
        errs, shares = [], []
        for label, xs in (("probe", ins), ("wide", wide)):
            got, want = pk.int8_probe(case, *xs), pk.int8_probe_plain(case, *xs)
            lim, tol = int8_cache.limit(case, xs)
            if lim is None:
                err, tol, share = check_kernel(f"int8_probe {case} ({label} inputs)", got, want,
                                               exact=True)
            else:
                torch.cuda.synchronize()
                err, share = float((got - want).abs().max()), _share(got, want, lim)
                print(f"kernel int8_probe {case} ({label} inputs): max_abs_err={err:.3e}, worst "
                      f"element at {share:.3f} of its limit |err| <= {tol}", flush=True)
                if not share <= 1.0:
                    fail(f"int8_probe {case} ({label} inputs): an element exceeds its limit "
                         f"({tol}) by {share:.3f}x")
            errs.append(err)
            shares.append(share)
        r = variants[case] = {
            "ms": timed(lambda c=case: pk.int8_probe(c, *ins), 200),
            "plain_ms": timed(lambda c=case: pk.int8_probe_plain(c, *ins), 200),
            "bound_ms": bound(sum(io_bytes[case]), flops[case], PEAK_FP32_FLOPS)[0],
            "max_abs_err": max(errs), "tol": tol, "err_share_of_tol": max(shares),
            "max_abs_err_wide_inputs": errs[1]}
        if case == "i8_load_convert":  # the one case that one PyTorch call computes
            r["library_err"] = library_err(f"int8_probe {case}", ins[0][:, :pd] * 0.5,
                                           pk.int8_probe_plain(case, *ins))
            r["library_ms"] = timed(lambda: ins[0][:, :pd] * 0.5, 200)
            r["library_note"] = "k8[:, :64] * 0.5"
        lib = f", k8[:, :64] * 0.5 {r['library_ms']:.6f} ms" if "library_ms" in r else ""
        print(f"kernel int8_probe {case}: max_abs_err {max(errs):.3e} ({max(shares):.3f} of its "
              f"limit, {tol}); graphed {r['ms']:.6f} ms{lib}; launch floor "
              f"{floor_ms:.6f} ms", flush=True)
    rows["P4"] = _case_row("int8_probe", "i8_dequant_matmul", variants, io_bytes, flops,
                           floor_ms, "only i8_load_convert has one call, k8[:, :64] * 0.5: "
                           "its case's library_ms")

    # ---- P5: the nine online-softmax fragments, held from a zero scratch
    # and from a seeded random one on the scale of H's largest score (the
    # only inputs on which H's twice-applied update moves the result), timed
    # from the zero one
    x, v = ops.inputs(dev)
    scr0 = torch.zeros((1, pd), device=dev)
    scr_rand = 16 * torch.randn((1, pd), generator=g, device=dev)
    io_bytes, flops = {}, {}
    for case in pk.SOFTMAX_CASES:
        x_bytes = 4 * (pd if case[0] in "HI" else sb)  # row 0 of x, or its first 64
        v_bytes = 4 * sb * pd if case[0] in "AEGHI" else 0
        io_bytes[case] = (x_bytes + v_bytes + (4 * pd if case[0] == "H" else 0), 4 * pd)
        flops[case] = 2 * 2 * sb * pd * (2 if case[0] in "HI" else 1 if v_bytes else 0) + 4 * sb
    variants = {}
    for case in pk.SOFTMAX_CASES:
        errs, shares = [], []
        for label, s0 in (("zero", scr0), ("random", scr_rand)):
            got, want = pk.softmax_probe(case, x, v, s0), pk.softmax_probe_plain(case, x, v, s0)
            lim, tol = ops.limit(case, x, v, s0)
            torch.cuda.synchronize()
            errs.append(float((got - want).abs().max()))
            shares.append(_share(got, want, lim))
            print(f"kernel softmax_probe {case} ({label} scratch): max_abs_err={errs[-1]:.3e}, "
                  f"worst element at {shares[-1]:.3f} of its limit |err| <= {tol}", flush=True)
            if not (bool(torch.isfinite(got).all()) and shares[-1] <= 1.0):
                fail(f"softmax_probe {case} ({label} scratch): an element exceeds its limit "
                     f"({tol}) by {shares[-1]:.3f}x")
        variants[case] = {
            "ms": timed(lambda c=case: pk.softmax_probe(c, x, v, scr0), 200),
            "plain_ms": timed(lambda c=case: pk.softmax_probe_plain(c, x, v, scr0), 200),
            "bound_ms": bound(sum(io_bytes[case]), flops[case], PEAK_FP32_FLOPS)[0],
            "max_abs_err": max(errs), "tol": tol, "err_share_of_tol": max(shares),
            "max_abs_err_random_scratch": errs[1]}
    rows["P5"] = _case_row("softmax_probe", "H_dotgen_transpose_rhs", variants, io_bytes, flops,
                           floor_ms)
    print("kernel softmax_probe: ms a case " + json.dumps(
        {c[0]: round(r["ms"], 6) for c, r in variants.items()}) + f", launch floor "
        f"{floor_ms:.5f} ms", flush=True)
    torch.cuda.synchronize()
    return rows


def _case_row(name, headline, variants, io_bytes, flops, floor_ms,
              library_note="no single PyTorch call computes a case"):
    """A P4/P5 row: the headline case's numbers, every case under it, and
    the launch floor. A case that one PyTorch call computes carries that
    call's time in its own line."""
    h = variants[headline]
    return dict(name=name, headline_variant=headline,
                err=max(c["max_abs_err"] for c in variants.values()),
                tol=h["tol"], share=max(c["err_share_of_tol"] for c in variants.values()),
                library_err=None, ms=h["ms"], plain_ms=h["plain_ms"], library_ms=None,
                library_note=library_note,
                bound=bound(sum(io_bytes[headline]), flops[headline], PEAK_FP32_FLOPS),
                variants=variants, extra={"floor_ms": floor_ms})


def probe_phase(card):
    """The probes' entry points on the card, the launch counters set to 0
    just before and read just after: P1 (``probes.boundary``: the four
    chains of ``P1_LAYERS`` layers at full width, eager and as a CUDA
    graph, with bf16 and with int8 weights, the best of ``P1_ITERS`` runs
    each), then P2/P3, P4 and P5 (each checks its kernels
    against their plain versions and times them). Prints P1's results as
    one JSON line and the rest as another; fails if a probe kernel was not
    launched. Returns (results, counts)."""
    import torch

    from chatterbox_tpu_torch.ops import PROBE_KERNELS, launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.probes import boundary, cache_write, int8_cache, ops

    dev = torch.device("cuda")
    reset_launch_counts()
    p1 = {"bf16": boundary.run(dev, layers=P1_LAYERS, iters=P1_ITERS),
          "int8": boundary.run(dev, wquant=True, layers=P1_LAYERS, iters=P1_ITERS)}
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
        "chatterbox_tpu_torch/csrc/flash_attention_sm90.cu",
        "chatterbox_tpu/ops/flash_attention.py:126",
    ),
    "flash_relpos_attention": (
        "chatterbox_tpu_torch/csrc/flash_attention_sm90.cu",
        "chatterbox_tpu/ops/flash_attention.py:267",
    ),
    "flash_self_attention": (
        "chatterbox_tpu_torch/csrc/flash_attention_sm90.cu",
        "chatterbox_tpu/ops/flash_attention.py:172",
    ),
    "ssm_decode_update": (
        "chatterbox_tpu_torch/csrc/ssm_decode.cu",
        "none: the JAX package has no Mamba layer (the Granite 4.0-H backbone's decode step)",
    ),
    **{name: ("chatterbox_tpu_torch/csrc/decode_glue.cu",
              "none: the Llama decode step's glue, which XLA fuses on the TPU "
              "(chatterbox_tpu/models/t3/llama.py)") for name in _GLUE},
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
                "kv_quantize_kernel", "flash_relpos_sm90_kernel",
                "flash_attention_packed_sm90_kernel", "flash_attention_heads_sm90_kernel")


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
PROFILED_PATHS = ("A", "F")
# the paths whose warm call is timed (the bf16 and int8 weights, and path D's
# prepared voice); B, C and G time none, for the run's time limit
WARM_PATHS = ("A", "D", "F")

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


# each TTS path's first call: (speech tokens, wavs), for path O1
FIRST_CALLS = {}


def run_path(tts, conds, card, name, profile, exact=None):
    """One TTS path: a first call with the launch counters set to 0 just
    before it and read just after, its wavs, KV cache and launches checked
    (``exact``: {kernel: launches} where the count is known); then, on
    ``WARM_PATHS``, a warm call timed and, when asked, a third profiled. Returns the counts, the
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
    FIRST_CALLS[name] = (tokens, wavs)

    check_wavs(name, wavs, N_TEXTS)
    if tts.last_timings["kv_cache"] != kv_cache:
        fail(f"path {name}: T3 ran a {tts.last_timings['kv_cache']} KV cache, not {kv_cache}")
    check_launches(name, counts, launched, not_launched, exact)
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(f"path {name} ({json.dumps(kw)}): first call {wall:.3f} s for {audio_s:.3f} s of audio "
          f"(stages {json.dumps(tts.last_timings)})", flush=True)
    print(f"path {name}: kernel launches " + json.dumps(counts), flush=True)
    if name not in WARM_PATHS:
        return counts, tokens, lens

    # a second, warm call on the same inputs: the throughput of the port
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.time()
    wavs = call()
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated()
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(
        f"path {name}: {N_TEXTS} texts, {json.dumps(kw)}: warm wall {wall:.3f} s, audio "
        f"{audio_s:.3f} s, audio_sec_per_s_per_chip_b8 {audio_s / wall:.4f}, t3_s "
        f"{tts.last_timings['t3_s']:.3f}, s3gen_s {tts.last_timings['s3gen_s']:.3f}, peak "
        f"{peak / 2**30:.2f} GiB on {card}",
        flush=True,
    )
    # the call's own memory a text: what the batch caps are sized from
    # (pipeline/tts.py _ROW_PEAK_BYTES, paths A and B)
    print(f"path {name}: peak over the {held} bytes held before the call: {peak - held} bytes, "
          f"{(peak - held) // N_TEXTS} a text", flush=True)
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


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN held to deterministic algorithms inside the block. Its
    transposed convolutions (HiFT's upsampling, the iSTFT's overlap-add) may
    otherwise sum in another order from call to call, so two calls on the
    same tokens need not give bit-identical wavs (without it, a run found
    path H's tokens equal and its wavs not)."""
    import torch

    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


class TokenSpy:
    """Records the compacted tokens each ``device_chain`` call hands S3Gen
    (``pipeline/tts._compact_tokens``'s outputs, read back after the call)."""

    def __init__(self):
        from chatterbox_tpu_torch.pipeline import tts as tts_mod

        self.mod, self.real, self.calls = tts_mod, tts_mod._compact_tokens, []

    def __enter__(self):
        def spy(tokens, lengths):
            out = self.real(tokens, lengths)
            self.calls.append(out)
            return out

        self.mod._compact_tokens = spy
        return self

    def __exit__(self, *exc):
        self.mod._compact_tokens = self.real

    def rows(self):
        """Each call's tokens: one array of valid tokens a row."""
        return [[r[:n] for r, n in zip(speech.cpu().numpy(), lens.cpu().numpy())]
                for speech, lens in self.calls]


def split_path(tts, conds, card):
    """Path H: 2 * N_TEXTS texts at MAX_NEW tokens through ``generate_batch``
    with ``max_device_batch = N_TEXTS``: the batch splits into two chunks of
    N_TEXTS through ``generate_batches_pipelined`` (chunk c seeded c). A
    first call with the launch counters set to 0 just before it and read
    just after; a warm call timed, with its peak memory; then the two chunks
    as direct ``generate_batch(chunk, seed=c, device_chain=True)`` calls,
    timed together, whose tokens and wavs each chunk of the split call must
    equal, with cuDNN's algorithms deterministic for the whole path. Returns
    the first call's counts."""
    import numpy as np
    import torch

    from chatterbox_tpu_torch.ops import flash_decode as fd
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts

    texts = TEXTS + TEXTS_H
    spaces = len(fd._workspaces)
    kw = {"max_new_tokens": MAX_NEW}
    saved = tts.max_device_batch
    tts.max_device_batch = N_TEXTS
    try:
        with deterministic_cudnn():
            reset_launch_counts()
            with TokenSpy() as spy:
                t0 = time.time()
                wavs = tts.generate_batch(texts, conds=conds, seed=0, **kw)
                torch.cuda.synchronize()
                first = time.time() - t0
            counts = launch_counts()
            split_tokens = spy.rows()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t0 = time.time()
            tts.generate_batch(texts, conds=conds, seed=0, **kw)
            torch.cuda.synchronize()
            warm = time.time() - t0
            peak_split = torch.cuda.max_memory_allocated() - held

            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            with TokenSpy() as spy:
                t0 = time.time()
                direct = [tts.generate_batch(texts[c * N_TEXTS:(c + 1) * N_TEXTS], conds=conds,
                                             seed=c, device_chain=True, **kw) for c in range(2)]
                torch.cuda.synchronize()
                sequential = time.time() - t0
            peak_direct = torch.cuda.max_memory_allocated() - held
            direct_tokens = spy.rows()
    finally:
        tts.max_device_batch = saved
    check_wavs("H", wavs, 2 * N_TEXTS)
    # K1's workspaces belong to the caches: none may outlive its chunk
    print(f"path H: K1 workspaces alive before the split calls: {spaces}, after: "
          f"{len(fd._workspaces)}", flush=True)
    if len(fd._workspaces) != spaces:
        fail("path H: a KV cache's K1 workspace outlived its chunk")
    check_launches("H", counts, (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5),
                   {_K1A: 2 * tts.t3_cfg.llama.num_hidden_layers * (MAX_NEW - 1)})
    if len(split_tokens) != 2:
        fail(f"path H: {len(split_tokens)} chunks, not 2")
    for c in range(2):
        same = all(len(a) == len(b) and (a == b).all()
                   for a, b in zip(split_tokens[c], direct_tokens[c]))
        wav_same = all(np.array_equal(a, b) for a, b in
                       zip(wavs[c * N_TEXTS:(c + 1) * N_TEXTS], direct[c]))
        print(f"path H: chunk {c}: speech tokens equal to the direct call's: {same}; wavs "
              f"bit-identical: {wav_same}", flush=True)
        if not (same and wav_same):
            fail(f"path H: chunk {c} of the split call differs from the direct call")
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(f"path H: {2 * N_TEXTS} texts, {json.dumps(kw)}, max_device_batch {N_TEXTS}: first call "
          f"{first:.3f} s; warm split call {warm:.3f} s against {sequential:.3f} s for the two "
          f"chunks as sequential calls (overlap {sequential - warm:.3f} s); audio {audio_s:.3f} s, "
          f"audio_sec_per_s_per_chip {audio_s / warm:.4f}; peak over the memory held before: "
          f"split {peak_split / 2**30:.2f} GiB, sequential {peak_direct / 2**30:.2f} GiB on {card}",
          flush=True)
    print("path H: kernel launches " + json.dumps(counts), flush=True)
    return counts


def cap_path(tts, conds, card):
    """Path I: one ``generate_batch`` at the card's one-shot cap for the
    default budget (MAX_NEW_DEFAULT tokens, the int8 cache), TEXTS repeated
    to that batch, with the launch counters set to 0 just before it and read
    just after, with the caching allocator held to the share of the card
    the caps are sized for (``_USABLE_SHARE``, through
    ``set_per_process_memory_fraction``: left unbounded it reserves what
    the card has free). It must run without running out of memory within
    that share; prints the batch, the peaks and the card's total memory. Then the kernels of the
    path at its batch (``cap_kernel_checks``). Returns the counts and those
    checks."""
    import torch

    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.pipeline.tts import _USABLE_SHARE, TEXT_BUCKETS, _bucket

    tb = _bucket(max(len(tts._encode_text(t)) for t in TEXTS), TEXT_BUCKETS)
    b = tts._budget_batch_cap(MAX_NEW_DEFAULT, False, tb)
    texts = [TEXTS[i % N_TEXTS] for i in range(b)]
    total = torch.cuda.get_device_properties(0).total_memory
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    held_reserved = torch.cuda.memory_reserved()
    reset_launch_counts()
    torch.cuda.set_per_process_memory_fraction(_USABLE_SHARE)
    try:
        t0 = time.time()
        wavs = tts.generate_batch(texts, conds=conds, seed=0)
        torch.cuda.synchronize()
        wall = time.time() - t0
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    check_wavs("I", wavs, b)
    if tts.last_timings["kv_cache"] != "int8":
        fail(f"path I: T3 ran a {tts.last_timings['kv_cache']} KV cache, not int8")
    steps = MAX_NEW_DEFAULT - 1
    # K2b at the prefill and in every decode step (it merges only where a
    # slot closes a group of TAIL_W)
    check_launches("I", counts, (_K1C, _K2, _K2B, _K3, _K4), (_K1A, _K1B, _K5),
                   {_K1C: tts.t3_cfg.llama.num_hidden_layers * steps, _K2B: 1 + steps})
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(f"path I: the one-shot cap at {MAX_NEW_DEFAULT} tokens (text bucket {tb}): batch {b} "
          f"(max_device_batch {tts.max_device_batch}); wall {wall:.3f} s for {audio_s:.3f} s of "
          f"audio, audio_sec_per_s_per_chip {audio_s / wall:.4f} (t3_s "
          f"{tts.last_timings['t3_s']:.3f}, s3gen_s {tts.last_timings['s3gen_s']:.3f}); peak "
          f"allocated {peak / 2**30:.2f} GiB ({held / 2**30:.2f} GiB held before, "
          f"{(peak - held) // b} bytes a text), peak reserved {peak_reserved / 2**30:.2f} GiB "
          f"({held_reserved / 2**30:.2f} GiB before, {(peak_reserved - held_reserved) // b} "
          f"bytes a text; {(peak_reserved - held_reserved) / (peak - held):.4f} reserved for "
          f"each byte allocated) of total_memory {total / 2**30:.2f} GiB on {card}", flush=True)
    print("path I: kernel launches " + json.dumps(counts), flush=True)
    if peak_reserved > total * _USABLE_SHARE:
        fail(f"path I: the allocator reserved {peak_reserved} bytes at the peak, over the "
             f"{_USABLE_SHARE} of total_memory ({total * _USABLE_SHARE:.0f} bytes) the caps are "
             f"sized for")
    del wavs
    torch.cuda.empty_cache()
    return counts, cap_kernel_checks(b)


def cap_kernel_checks(b):
    """The kernels of path I at its batch of ``b`` texts (2b CFG rows), each
    against its plain version within the kernel phase's limits, each T3
    kernel given its position on the card as the path gives it: K2b at the
    prefill's n and at n = 8 into the whole 30-layer int8 cache (~11.6 GB
    at 82 texts, byte offsets past 2^32), and at two write slots that close
    no tail (the cache left bit for bit), K2 into the tail and K1c+d at the
    first and the last layer, each at cur_len % 8 = 0, 1 and 7, K3 at 2b
    rows and K4 at b rows at path B's
    T = 2560, with a key length of its own a row. The plain versions of K3
    and K4 run on groups of rows, each row's output depending only on its
    own inputs. Returns {kernel: (max |err|, tol, share, rows)}."""
    import torch

    from chatterbox_tpu_torch.ops import flash_attention as fa
    from chatterbox_tpu_torch.ops import flash_decode as fd

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    rows_t3 = 2 * b
    out = {}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def exact_slots(name, got, want, pos, n):
        """The written slots [pos, pos + n) compared, then the whole tensors
        (nothing else written)."""
        err, tol, share = check_kernel(name, got[:, :, :, :, pos:pos + n],
                                       want[:, :, :, :, pos:pos + n], exact=True)
        if not torch.equal(got, want):
            fail(f"{name}: the kernel wrote outside slots [{pos}, {pos + n})")
        return err, tol, share

    def worst(*checks):
        return (max(c[0] for c in checks), checks[0][1], max(c[2] for c in checks), rows_t3)

    def dpos(n):
        return fd.device_position(n, dev)

    # ---- K2b: the prefill's n = s0 at slots [0, s0) (write slot s0 - 1),
    # then n = 8 at a merge (write slot merge + 7), then at the two write
    # slots after it, which close no tail and must leave the cache as it is
    s0 = N_COND + TEXT_BUCKET + N_BOS
    s_1000 = -(-(s0 + MAX_NEW_DEFAULT) // 128) * 128
    shape = (T3_LAYERS, 2, rows_t3, T3_HEADS, s_1000)
    cache8 = torch.randint(-127, 128, shape + (HEAD_DIM,), generator=g, device=dev,
                           dtype=torch.int8)
    scales = torch.rand(shape, generator=g, device=dev) * 0.02 + 1e-3
    print(f"cap shapes: {b} texts, {rows_t3} CFG rows: int8 cache {cache8.numel()} bytes",
          flush=True)
    b8, bsc = cache8.clone(), scales.clone()
    checks = []
    merge = s0 + MAX_NEW_DEFAULT - 2 * TAIL_W - s0 % TAIL_W  # a merge slot late in the decode
    for pos, n in ((0, s0), (merge, TAIL_W)):
        src = randn(T3_LAYERS, 2, rows_t3, T3_HEADS, n, HEAD_DIM)
        fd.kv_cache_quantize_write(cache8, scales, src, dpos(pos + n - 1))
        fd.kv_cache_quantize_write_plain(b8, bsc, src, pos + n - 1)
        name = f"kv_cache_quantize_write ({rows_t3} rows, n = {n})"
        checks.append(exact_slots(name, cache8, b8, pos, n))
        checks.append(exact_slots(name + " scales", scales[..., None], bsc[..., None], pos, n))
    for w in (merge + TAIL_W, merge + TAIL_W + 1):  # src: the merge's tail
        fd.kv_cache_quantize_write(cache8, scales, src, dpos(w))
        torch.cuda.synchronize()
        if not (torch.equal(cache8, b8) and torch.equal(scales, bsc)):
            fail(f"kv_cache_quantize_write ({rows_t3} rows): write slot {w} closes no tail, "
                 f"yet the cache changed")
    print(f"kernel kv_cache_quantize_write ({rows_t3} rows): write slots {merge + TAIL_W} and "
          f"{merge + TAIL_W + 1} left the cache bit for bit", flush=True)
    del src
    out[_K2B] = worst(*checks)
    del b8, bsc
    torch.cuda.empty_cache()

    # ---- K2: the per-step append into the bf16 tail (L, 2, B, H, 8, D),
    # at the write slots of phases 0, 1 and 7 after the merge: tail slot
    # pos % 8
    tail = randn(T3_LAYERS, 2, rows_t3, T3_HEADS, TAIL_W, HEAD_DIM)
    new_kv = randn(T3_LAYERS, 2, rows_t3, T3_HEADS, HEAD_DIM)
    curs = (merge + TAIL_W, merge + TAIL_W + 1, merge + 2 * TAIL_W - 1)
    checks = []
    for c in curs:
        t_plain = tail.clone()
        fd.kv_cache_append(tail, new_kv, dpos(c))
        fd.kv_cache_append_plain(t_plain, new_kv, c % TAIL_W)
        checks.append(exact_slots(f"kv_cache_append ({rows_t3} rows, pos {c})", tail, t_plain,
                                  c % TAIL_W, 1))
    out[_K2] = worst(*checks)
    del t_plain, new_kv

    # ---- K1c+d: late in the decode, the first and the last layer, with
    # merge_base = merge + 8 and tails of 0, 1 and 7
    text_lens = torch.randint(20, TEXT_BUCKET, (b,), generator=g, device=dev)
    row_prefix = (N_COND + text_lens).repeat(2).to(torch.int32).contiguous()
    gap_end = N_COND + TEXT_BUCKET
    q, kn, vn = (randn(rows_t3, T3_HEADS, HEAD_DIM) for _ in range(3))
    checks = []
    for layer in (0, T3_LAYERS - 1):
        for cur in curs:
            rest = (row_prefix, gap_end, q, kn, vn)
            checks.append(check_kernel(
                f"flash_decode_layer_attention_int8 ({rows_t3} rows, layer {layer}, cur_len "
                f"{cur})",
                fd.flash_decode_layer_attention_int8(cache8, scales, tail, None, layer, dpos(cur),
                                                     *rest),
                fd.flash_decode_layer_attention_int8_plain(cache8, scales, tail, merge + TAIL_W,
                                                           layer, cur, *rest)))
    out[_K1C] = worst(*checks)
    del cache8, scales, tail, q, kn, vn
    torch.cuda.empty_cache()

    # ---- K3 (2b rows) and K4 (b rows) at T = 2560, a key length a row
    t_pad, t_valid = SELF_ATTN_T[-1]
    hd = FLOW_HEADS * HEAD_DIM

    def key_bias(n_rows):
        lens = t_valid - 64 * (torch.arange(n_rows, device=dev) % 7)
        return torch.where(torch.arange(t_pad, device=dev)[None] < lens[:, None], 0.0,
                           -1.0e10).float().contiguous()

    qkv = randn(rows_t3, t_pad, 3 * hd)
    bias = key_bias(rows_t3)
    got = fa.flash_self_attention_packed(qkv, bias, FLOW_HEADS)
    torch.cuda.synchronize()
    checks = []
    for r in range(0, rows_t3, ROWS):
        x = qkv[r:r + ROWS]
        x_abs_v = torch.cat([x[..., :2 * hd], x[..., 2 * hd:].abs()], dim=-1)
        checks.append(check_kernel(
            f"flash_self_attention_packed ({rows_t3} rows, T = {t_pad}; rows {r}-"
            f"{min(r + ROWS, rows_t3) - 1})", got[r:r + ROWS],
            fa.flash_self_attention_packed_plain(x, bias[r:r + ROWS], FLOW_HEADS),
            fa.flash_self_attention_packed_plain(x_abs_v, bias[r:r + ROWS], FLOW_HEADS)))
        del x_abs_v
    out[_K3] = worst(*checks)
    del qkv, got
    torch.cuda.empty_cache()

    cd = CONF_C
    scale = 1.0 / math.sqrt(cd // CONF_HEADS)
    q_u, k, v = (randn(b, t_pad, cd, scale=0.5) for _ in range(3))
    q_hat = randn(b, t_pad, CONF_HEADS * cd, scale=0.5)
    s_hat = randn(1, t_pad, cd, scale=0.7)
    bias = key_bias(b)
    got = fa.flash_relpos_attention(q_u, q_hat, k, s_hat, v, bias, CONF_HEADS, scale)
    torch.cuda.synchronize()
    checks = []
    for r in range(0, b, N_TEXTS):
        sl = slice(r, r + N_TEXTS)
        checks.append(check_kernel(
            f"flash_relpos_attention ({b} rows, T = {t_pad}; rows {r}-{min(r + N_TEXTS, b) - 1})",
            got[sl], fa.flash_relpos_attention_plain(q_u[sl], q_hat[sl], k[sl], s_hat, v[sl],
                                                     bias[sl], CONF_HEADS, scale),
            fa.flash_relpos_attention_plain(q_u[sl], q_hat[sl], k[sl], s_hat, v[sl].abs(),
                                            bias[sl], CONF_HEADS, scale)))
    out[_K4] = worst(*checks)[:3] + (b,)
    del q_u, k, v, q_hat, s_hat, got
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# streaming and serving (paths J, K, L)
# ---------------------------------------------------------------------------

# path J: bench.py's four stream texts (the JAX package's stream cell),
# copied here: the port imports nothing of bench.py
STREAM_TEXTS = [
    "The quick brown fox jumps over the lazy dog near the river bank today.",
    "A second speaker reads an entirely different sentence about mountains.",
    "Stream three narrates the weather forecast for the coming weekend now.",
    "Speaker four describes a recipe for fresh bread with honey and butter.",
]
N_STREAMS = len(STREAM_TEXTS)
# the flow's (padded T, valid frames) in a streaming tick with the 250-token
# prompt: the first tick's 25-token window (2 (250 + 25) = 550 mel frames),
# and a steady tick's 100 tokens (700); K3 runs there on 2 x 4 CFG rows and
# K4's 50 Hz layers on 4 rows. K4's token-rate layers see 275-350 tokens,
# padded to 384.
TICK_T = ((640, 550), (768, 700))
TICK_T_TOKEN = ((384, 275), (384, 350))
# path J's exact-window call: one stream whose flow window holds its whole
# history, against generate_batch on the same seed, the vocoder's noise
# zeroed on both. The whole wav is held to an SNR of STREAM_SNR_DB, the
# bound of the JAX package's own window-divergence test on its tiny random
# model: even with the whole history in the window, a tick's flow sees no
# token after its chunk (the conformer's lookahead and the encoder's and
# the UNet's attention are not causal), so the early chunks differ. The
# last chunk, whose window holds every token, differs only by the
# vocoder's chunking (24 frames of context) and the watermark a chunk: it
# is held to STREAM_LAST_SNR_DB. The random vocoder's output sits near 2
# int16 steps rms, where rounding alone caps the SNR near 18 dB, so this
# comparison scales the spectra's magnitude by STREAM_EXACT_GAIN (conv_post's
# log-magnitude bias), the same on both sides; random weights say nothing
# of how audible the differences are
STREAM_EXACT_TOKENS = 100
STREAM_SNR_DB = 10.0
STREAM_LAST_SNR_DB = 30.0
STREAM_EXACT_GAIN = 100.0
# (gain, flow_ctx_tokens) of path J's window sweep: the whole history, and a
# 25-token window that the last-chunk bound must fail
STREAM_SWEEP = ((STREAM_EXACT_GAIN, STREAM_EXACT_TOKENS), (STREAM_EXACT_GAIN, 25))
# path K: generate_batch_preemptible's T3 chunk
PREEMPT_CHUNK = 25


def tick_kernel_checks():
    """K3 and K4 at the lengths of a streaming tick (``TICK_T``,
    ``TICK_T_TOKEN``): each against its plain version within the kernel
    phase's limits, and timed (kernel, plain, and SDPA as the yardstick; K3
    on rotating input sets past the L2, as in the kernel phase). Path J is
    the first path that gives the kernels lengths this short. Returns
    {kernel: [one dict a length]}."""
    import torch
    import torch.nn.functional as F

    from chatterbox_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    bf = torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def key_bias(n_rows, t_pad, t_valid):
        return torch.where(torch.arange(t_pad, device=dev)[None] < t_valid, 0.0, -1.0e10) \
            .expand(n_rows, t_pad).contiguous().float()

    out = {_K3: [], _K4: []}
    rows_unet, hd = 2 * N_STREAMS, FLOW_HEADS * HEAD_DIM
    for t_pad, t_valid in TICK_T:
        set_bytes = 3 * rows_unet * FLOW_HEADS * t_pad * HEAD_DIM * 2
        n_sets = max(2, -(-200 * 2**20 // set_bytes))
        bias = key_bias(rows_unet, t_pad, t_valid)
        bias4 = bias[:, None, None, :].to(bf)
        packed = [randn(rows_unet, t_pad, 3 * hd) for _ in range(n_sets)]

        def split(x, i):
            return x[..., i * hd:(i + 1) * hd].unflatten(-1, (FLOW_HEADS, HEAD_DIM)).transpose(1, 2)

        qkv = packed[0]
        want = fa.flash_self_attention_packed_plain(qkv, bias, FLOW_HEADS)
        name = f"flash_self_attention_packed (streaming tick, {rows_unet} rows, T = {t_pad})"
        abs_v = torch.cat([qkv[..., :2 * hd], qkv[..., 2 * hd:].abs()], dim=-1)
        err, tol, share = check_kernel(name, fa.flash_self_attention_packed(qkv, bias, FLOW_HEADS),
                                       want, fa.flash_self_attention_packed_plain(
                                           abs_v, bias, FLOW_HEADS))
        lib_sets = [tuple(split(x, i) for i in range(3)) for x in packed]
        lib_err = library_err(name, F.scaled_dot_product_attention(
            *lib_sets[0], attn_mask=bias4).transpose(1, 2).flatten(2), want)
        out[_K3].append(dict(
            T=t_pad, valid=t_valid, rows=rows_unet, err=err, tol=tol, share=share,
            library_err=lib_err,
            ms=timed(rotating(lambda i: fa.flash_self_attention_packed(
                packed[i], bias, FLOW_HEADS), n_sets), 50),
            plain_ms=timed(rotating(lambda i: fa.flash_self_attention_packed_plain(
                packed[i], bias, FLOW_HEADS), n_sets), 10),
            library_ms=timed(rotating(lambda i: F.scaled_dot_product_attention(
                *lib_sets[i], attn_mask=bias4), n_sets), 50),
            bound=bound(set_bytes * 4 // 3 + bias.numel() * 4,
                        4 * rows_unet * FLOW_HEADS * t_pad * t_pad * HEAD_DIM)))
        del packed, lib_sets, qkv, abs_v, want

    cd = CONF_C
    dk = cd // CONF_HEADS
    scale = 1.0 / math.sqrt(dk)
    for t_pad, t_valid in TICK_T_TOKEN + TICK_T:
        q_u, k, v = (randn(N_STREAMS, t_pad, cd, scale=0.5) for _ in range(3))
        q_hat = randn(N_STREAMS, t_pad, CONF_HEADS * cd, scale=0.5)
        s_hat = randn(1, t_pad, cd, scale=0.7)
        bias = key_bias(N_STREAMS, t_pad, t_valid)
        kargs = (q_u, q_hat, k, s_hat, v, bias, CONF_HEADS, scale)
        want = fa.flash_relpos_attention_plain(*kargs)
        name = f"flash_relpos_attention (streaming tick, {N_STREAMS} rows, T = {t_pad}, " \
               f"{t_valid} valid)"
        err, tol, share = check_kernel(name, fa.flash_relpos_attention(*kargs), want,
                                       fa.flash_relpos_attention_plain(
                                           q_u, q_hat, k, s_hat, v.abs(), bias, CONF_HEADS, scale))

        def heads(x, n):
            return x.unflatten(-1, (CONF_HEADS, n)).transpose(1, 2)

        q_cat = torch.cat([heads(q_u, dk), heads(q_hat, cd)], dim=-1)
        k_cat = torch.cat([heads(k, dk), s_hat[:, None].expand(N_STREAMS, CONF_HEADS, t_pad, cd)],
                          dim=-1)
        v_h, bias4 = heads(v, dk), bias[:, None, None, :].to(bf)

        def k4_library():
            return F.scaled_dot_product_attention(q_cat, k_cat, v_h, attn_mask=bias4, scale=scale)

        out[_K4].append(dict(
            T=t_pad, valid=t_valid, rows=N_STREAMS, err=err, tol=tol, share=share,
            library_err=library_err(name, k4_library().transpose(1, 2).flatten(2), want),
            ms=timed(lambda: fa.flash_relpos_attention(*kargs), 50),
            plain_ms=timed(lambda: fa.flash_relpos_attention_plain(*kargs), 10),
            library_ms=timed(k4_library, 50),
            bound=bound((4 * q_u.numel() + q_hat.numel() + s_hat.numel()) * 2 + bias.numel() * 4,
                        2 * N_STREAMS * CONF_HEADS * t_pad * t_pad * (2 * dk + cd))))
        del q_u, k, v, q_hat, s_hat, q_cat, k_cat, v_h, want
    torch.cuda.empty_cache()
    for key, runs in out.items():
        for r in runs:
            print(f"kernel {key} at the streaming tick's T = {r['T']} ({r['valid']} valid, "
                  f"{r['rows']} rows): {r['ms']:.5f} ms, bound {r['bound'][0]:.5f} ms "
                  f"({r['bound'][1]}), {r['bound'][0] / r['ms']:.1%} of the bound; plain "
                  f"{r['plain_ms']:.5f} ms; library {r['library_ms']:.5f} ms", flush=True)
    return out


def merge_tick_checks(rows, checks):
    """The streaming tick's K3/K4 runs into their kernel rows: the errors
    count in the row's, the times stand beside the row's own."""
    for key, runs in checks.items():
        r = rows[key]
        r["err"] = max([r["err"]] + [x["err"] for x in runs])
        r["share"] = max([r["share"]] + [x["share"] for x in runs])
        r["library_err"] = max([r["library_err"]] + [x["library_err"] for x in runs])
        extra = r.setdefault("extra", {})
        for x in runs:
            tag = f"tick_t{x['T']}_valid{x['valid']}"
            extra.update({f"ms_{tag}": x["ms"], f"plain_ms_{tag}": x["plain_ms"],
                          f"library_ms_{tag}": x["library_ms"], f"bound_ms_{tag}": x["bound"][0],
                          f"max_abs_err_{tag}": x["err"], f"err_share_of_tol_{tag}": x["share"],
                          f"rows_{tag}": x["rows"]})


class CallSpy:
    """Wraps ``module.name`` for the block: each call's record and wall
    seconds (with a synchronise after it, unless ``sync`` is false: then
    the seconds are the host's launch time) are kept in ``calls``."""

    def __init__(self, module, name, record=None, sync=True):
        self.module, self.name, self.record, self.sync = module, name, record, sync
        self.real, self.calls = getattr(module, name), []

    def __enter__(self):
        import torch

        def spy(*args, **kw):
            t0 = time.time()
            out = self.real(*args, **kw)
            if self.sync:
                torch.cuda.synchronize()
            self.calls.append((self.record(args, kw, out) if self.record else None,
                               time.time() - t0))
            return out

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.real)


class ZeroNoise:
    """``module.hift_generate`` with the vocoder's phase and additive noise
    zeroed for the block, as the CPU parity tests run it: the stream and
    ``generate_batch`` draw their noise differently."""

    def __init__(self, module):
        self.module, self.real = module, module.hift_generate

    def __enter__(self):
        import torch

        def run(p, cfg, mel, **kw):
            b, t_mel, _ = mel.shape
            h = cfg.nb_harmonics + 1
            kw.pop("generator", None)
            kw["phase_noise"] = torch.zeros((b, h), device=mel.device)
            kw["additive_noise"] = torch.zeros((b, h, t_mel * cfg.upsample_total),
                                               device=mel.device)
            return self.real(p, cfg, mel, **kw)

        self.module.hift_generate = run
        return self

    def __exit__(self, *exc):
        self.module.hift_generate = self.real


def _snr_db(got, want):
    import numpy as np

    d = got.astype(np.float64) - want.astype(np.float64)
    return 10 * np.log10(float(np.mean(want.astype(np.float64) ** 2)) /
                         max(float(np.mean(d ** 2)), 1e-30))


def stream_run(tts, conds, texts, stream, **kw):
    """One ``stream_generate_batch`` call: (every stream's chunks, each
    stream's time to first audio, each tick's seconds, wall seconds)."""
    from chatterbox_tpu_torch.pipeline.streaming import stream_generate_batch

    chunks = [[] for _ in texts]
    ttfa, ticks = [None] * len(texts), []
    t0 = time.time()
    last = t0
    for tick in stream_generate_batch(tts, texts, conds=conds, stream=stream, **kw):
        now = time.time()
        ticks.append(now - last)
        last = now
        for i, c in enumerate(tick):
            if c is not None and len(c):
                chunks[i].append(c)
                if ttfa[i] is None:
                    ttfa[i] = now - t0
    return chunks, ttfa, ticks, time.time() - t0


def stream_path(tts, conds, card):
    """Path J: ``stream_generate_batch`` of the four stream texts at the
    default ``StreamConfig`` (1000 tokens, the int8 cache, chunks of 25
    after a first of 10, a 75-token flow window), ``min_new_tokens=999``.
    A first call with the launch counters set to 0 just before it and read
    just after: every chunk finite and whole tokens long; each stream's
    tokens equal to a one-shot ``t3_generate`` with the same inputs and
    seed; K1c+d once a layer a decode step, K2b at the prefill and every 8
    slots, K3 and K4 in every tick at the lengths the kernel phase checked.
    The same call timed: time to first audio per stream, ms a tick, T3's
    ms a step and ``stream_aggregate_audio_sec_per_s_n4``. Then the
    exact-window call (one stream, ``STREAM_EXACT_TOKENS`` tokens, the
    window over the whole history) against ``generate_batch`` on the same
    seed, both with the vocoder's noise zeroed (the stream draws its own)
    and its magnitude gained by ``STREAM_EXACT_GAIN``: the whole wav and
    the last chunk held to ``STREAM_SNR_DB`` and ``STREAM_LAST_SNR_DB``
    (``stream_window_sweep``, which also reads a cut window). Returns the
    first call's counts."""
    import numpy as np
    import torch

    from chatterbox_tpu_torch.models.s3gen import conformer, unet
    from chatterbox_tpu_torch.models.t3.t3 import t3_generate
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.pipeline import streaming

    st = streaming.StreamConfig()
    kw = dict(seed=0, min_new_tokens=st.max_new_tokens - 1)

    def shape2(args, kw_, out):
        return tuple(args[0].shape[:2])

    reset_launch_counts()
    with CallSpy(streaming, "t3_generate_start", lambda a, k, o: (a, k)) as start_spy, \
            CallSpy(streaming, "t3_generate_resume",
                    lambda a, k, o: (o[1].tokens.clone(), o[1].steps)) as resume_spy, \
            CallSpy(streaming._ChunkSynthesizer, "_synth") as synth_spy, \
            CallSpy(unet, "flash_self_attention_packed", shape2, sync=False) as k3_spy, \
            CallSpy(conformer, "flash_relpos_attention", shape2, sync=False) as k4_spy:
        chunks, ttfa, ticks, wall = stream_run(tts, conds, STREAM_TEXTS, st, **kw)
    counts = launch_counts()
    n_synth = len(synth_spy.calls)
    for i, cs in enumerate(chunks):
        if not cs:
            fail(f"path J: stream {i} gave no audio")
        for c in cs:
            if c.ndim != 1 or len(c) == 0 or len(c) % 960 or not np.isfinite(c).all():
                fail(f"path J: stream {i}: a chunk of shape {c.shape} is empty, not whole "
                     f"tokens (960 samples) or not finite")
    # the streams' tokens against one t3_generate on the same inputs and seed
    (args, start_kw), _ = start_spy.calls[0]
    stream_tokens, steps = resume_spy.calls[-1][0]
    one_shot = t3_generate(*args, cache_quant=start_kw["cache_quant"],
                           generator=torch.Generator(device=tts.device).manual_seed(kw["seed"]))
    same = torch.equal(stream_tokens, one_shot.tokens)
    print(f"path J: {N_STREAMS} streams' tokens ({tuple(stream_tokens.shape)}, {steps} steps, "
          f"{len(resume_spy.calls)} T3 chunks) equal to a one-shot t3_generate's on the same "
          f"inputs and seed: {same}", flush=True)
    if not same:
        fail("path J: the streamed tokens differ from a one-shot t3_generate's")
    # launches: K1c+d once a layer a decode step, K2b at the prefill and in
    # every decode step (it merges where a slot closes a group of TAIL_W);
    # K3/K4 in every tick
    decode_steps = st.max_new_tokens - 1
    unet_cfg = tts.s3gen_cfg.flow.estimator
    enc = tts.s3gen_cfg.flow.encoder
    k3_per_tick = unet_cfg.n_blocks * (2 + unet_cfg.num_mid_blocks) * tts.s3gen_cfg.flow.n_timesteps
    k4_per_tick = enc.num_blocks + enc.num_up_blocks
    check_launches("J", counts, (_K1C, _K2, _K2B, _K3, _K4), (_K1A, _K1B, _K5),
                   {_K1C: tts.t3_cfg.llama.num_hidden_layers * decode_steps, _K2B: 1 + decode_steps,
                    _K3: k3_per_tick * n_synth, _K4: k4_per_tick * n_synth})
    k3_t = sorted({s for s, _ in k3_spy.calls})
    k4_t = sorted({s for s, _ in k4_spy.calls})
    print(f"path J: {len(ticks)} ticks, {n_synth} with synthesis; (rows, T) of K3: {k3_t}, of "
          f"K4: {k4_t}; kernel launches " + json.dumps(counts), flush=True)
    checked3 = {(2 * N_STREAMS, t) for t, _ in TICK_T}
    checked4 = {(N_STREAMS, t) for t, _ in TICK_T_TOKEN + TICK_T}
    if not (set(k3_t) <= checked3 and set(k4_t) <= checked4):
        fail(f"path J: K3/K4 ran at (rows, T) {k3_t} / {k4_t}, beyond the streaming tick's "
             f"lengths the kernel phase checked ({sorted(checked3)} / {sorted(checked4)})")

    # the same call's times: the streams as a user gets them (the spies add
    # a synchronise a T3 chunk and a tick, where the stream waits anyway)
    audio = [sum(len(c) for c in cs) / tts.sr for cs in chunks]
    t3_s = sum(s for _, s in resume_spy.calls)
    print(f"path J: stream_aggregate_audio_sec_per_s_n{N_STREAMS} {sum(audio) / wall:.4f} "
          f"({sum(audio):.3f} s of audio in {wall:.3f} s); time to first audio per stream "
          f"{json.dumps([round(x, 4) for x in ttfa])} s; {len(ticks)} ticks, "
          f"{1e3 * wall / len(ticks):.2f} ms a tick (first {1e3 * ticks[0]:.2f}, median "
          f"{1e3 * float(np.median(ticks)):.2f}); T3 {t3_s:.3f} s for {steps} steps, "
          f"{1e3 * t3_s / steps:.3f} ms a step; synthesis {wall - t3_s:.3f} s, "
          f"{1e3 * (wall - t3_s) / len(ticks):.2f} ms a tick; per-stream audio "
          f"{json.dumps([round(a, 3) for a in audio])} s on {card}", flush=True)

    # the exact-window stream against generate_batch, zero vocoder noise
    snr, per_chunk = stream_window_sweep(tts, conds)
    if not (snr > STREAM_SNR_DB and per_chunk[-1] > STREAM_LAST_SNR_DB):
        fail(f"path J: the exact-window stream is {snr:.2f} dB from generate_batch's wav (its "
             f"last chunk {per_chunk[-1]:.2f} dB), not above {STREAM_SNR_DB} dB "
             f"({STREAM_LAST_SNR_DB} dB)")
    return counts


def stream_window_sweep(tts, conds):
    """Path J's exact-window stream (``STREAM_EXACT_TOKENS`` tokens) against
    ``generate_batch`` on the same seed, both with the vocoder's noise
    zeroed, at each of ``STREAM_SWEEP``'s (magnitude gain, flow_ctx_tokens):
    the whole history, and a cut window, whose last chunk must stay under
    ``STREAM_LAST_SNR_DB`` (else that bound does not tell a cut window from
    a whole one). Prints each
    reading; returns (whole-wav SNR, per-chunk SNRs) at ``STREAM_EXACT_GAIN``
    with the whole history in the window."""
    import numpy as np

    from chatterbox_tpu_torch.models.s3gen import s3gen as s3gen_mod
    from chatterbox_tpu_torch.pipeline import streaming

    text = STREAM_TEXTS[0]
    ekw = dict(seed=3, min_new_tokens=STREAM_EXACT_TOKENS - 1)
    hift = tts.s3gen_params["hift"]
    post = hift["conv_post"]
    n_freq = tts.s3gen_cfg.hift.istft_n_fft // 2 + 1
    readings, wants = {}, {}
    try:
        for gain, ctx in STREAM_SWEEP:
            bias = post["b"].clone()
            bias[:n_freq] += math.log(gain)
            hift["conv_post"] = {**post, "b": bias}
            ex = streaming.StreamConfig(max_new_tokens=STREAM_EXACT_TOKENS, flow_ctx_tokens=ctx)
            with ZeroNoise(streaming), ZeroNoise(s3gen_mod):
                streamed, _, _, _ = stream_run(tts, conds, [text], ex, **ekw)
                if gain not in wants:
                    wants[gain] = tts.generate_batch([text], conds=conds,
                                                     max_new_tokens=STREAM_EXACT_TOKENS, **ekw)[0]
            want = wants[gain]
            got = np.concatenate(streamed[0])
            if len(got) != len(want):
                fail(f"path J: the stream at flow_ctx_tokens {ctx} gave {len(got)} samples, "
                     f"generate_batch {len(want)}")
            ends = np.cumsum([0] + [len(c) for c in streamed[0]])
            per_chunk = [_snr_db(got[a:b], want[a:b]) for a, b in zip(ends[:-1], ends[1:])]
            readings[gain, ctx] = (_snr_db(got, want), per_chunk)
            print(f"path J: window stream ({STREAM_EXACT_TOKENS} tokens, flow_ctx_tokens {ctx}, "
                  f"{len(streamed[0])} chunks, {len(got)} samples, peak {np.abs(got).max():.4f}) "
                  f"against generate_batch (peak {np.abs(want).max():.4f}, rms "
                  f"{np.sqrt(np.mean(want.astype(np.float64) ** 2)):.5f}), vocoder noise zeroed "
                  f"on both, magnitude gain {gain:g}: SNR {readings[gain, ctx][0]:.2f} dB; per "
                  f"chunk {json.dumps([round(x, 2) for x in per_chunk])} dB", flush=True)
    finally:
        hift["conv_post"] = post
    cut = min(ctx for _, ctx in STREAM_SWEEP)
    cut_last = readings[STREAM_EXACT_GAIN, cut][1][-1]
    print(f"path J: exact-window check at gain {STREAM_EXACT_GAIN:g}: the last chunk "
          f"{readings[STREAM_EXACT_GAIN, STREAM_EXACT_TOKENS][1][-1]:.2f} dB with the whole "
          f"history, {cut_last:.2f} dB at flow_ctx_tokens {cut} (bound {STREAM_LAST_SNR_DB} dB); "
          f"the whole wav's bound {STREAM_SNR_DB} dB", flush=True)
    if cut_last > STREAM_LAST_SNR_DB:
        fail(f"path J: a {cut}-token window's last chunk is {cut_last:.2f} dB from "
             f"generate_batch's, above the {STREAM_LAST_SNR_DB} dB bound meant to fail it")
    return readings[STREAM_EXACT_GAIN, STREAM_EXACT_TOKENS]


def preemptible_path(tts, conds, card):
    """Path K: ``generate_batch_preemptible`` of the 8 texts at MAX_NEW
    tokens, T3 in chunks of ``PREEMPT_CHUNK`` and S3Gen in one group,
    against ``generate_batch`` on the same seed: speech tokens and wavs
    equal bit for bit, cuDNN deterministic. The one-shot call runs first,
    warm; the preemptible one after it with the launch counters set to 0
    just before it and read just after (one call of each, for the run's
    time limit). Returns its counts."""
    import numpy as np
    import torch

    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts

    kw = dict(conds=conds, seed=0, max_new_tokens=MAX_NEW)
    walls, outs = {"one-shot": [], "preemptible": []}, {}

    def call(name, count=False):
        if count:
            reset_launch_counts()
        t0 = time.time()
        if name == "one-shot":
            wavs = tts.generate_batch(TEXTS, **kw)
        else:
            wavs = tts.generate_batch_preemptible(TEXTS, t3_chunk_tokens=PREEMPT_CHUNK,
                                                  s3gen_max_rows=None, **kw)
        torch.cuda.synchronize()
        walls[name].append(time.time() - t0)
        outs.setdefault(name, (wavs, [r.copy() for r in tts.last_speech_tokens]))
        return launch_counts() if count else None

    with deterministic_cudnn():
        call("one-shot")
        counts = call("preemptible", count=True)
    (w1, t1), (w2, t2) = outs["one-shot"], outs["preemptible"]
    check_wavs("K", w2, N_TEXTS)
    same_tok = all(len(a) == len(b) and (a == b).all() for a, b in zip(t1, t2))
    same_wav = all(np.array_equal(a, b) for a, b in zip(w1, w2))
    print(f"path K: generate_batch_preemptible (t3_chunk_tokens {PREEMPT_CHUNK}, one S3Gen "
          f"group): speech tokens equal to generate_batch's: {same_tok}; wavs bit-identical: "
          f"{same_wav}", flush=True)
    if not (same_tok and same_wav):
        fail("path K: generate_batch_preemptible differs from generate_batch on the same seed")
    check_launches("K", counts, (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5),
                   {_K1A: tts.t3_cfg.llama.num_hidden_layers * (MAX_NEW - 1)})
    audio_s = sum(len(w) for w in w1) / tts.sr
    print(f"path K: {N_TEXTS} texts at {MAX_NEW} tokens, warm walls: one-shot "
          f"{walls['one-shot'][0]:.3f} s, preemptible {walls['preemptible'][0]:.3f} s (it "
          f"counted launches); audio {audio_s:.3f} s, audio_sec_per_s one-shot "
          f"{audio_s / walls['one-shot'][0]:.4f}, preemptible "
          f"{audio_s / walls['preemptible'][0]:.4f} on {card}", flush=True)
    print("path K: kernel launches " + json.dumps(counts), flush=True)
    return counts


def _http(port, path, method="GET", body=None, ctype="application/json"):
    """(status, parsed JSON or bytes, seconds) of one request to the smoke
    run's own server on localhost."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if isinstance(body, dict) else body
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", ctype)
    t0 = time.time()
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            raw, status = resp.read(), resp.status
            is_json = "json" in resp.headers.get("Content-Type", "")
    except urllib.error.HTTPError as e:
        raw, status, is_json = e.read(), e.code, True
    return status, (json.loads(raw) if is_json and raw else raw), time.time() - t0


def _http_stream(port, body, on_first_audio=None):
    """A /generate/stream request read chunk by chunk: (status, int16 PCM,
    seconds to the first audio, seconds in all); ``on_first_audio()`` is
    called when the first audio arrives."""
    import http.client

    import numpy as np

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.time()
    conn.request("POST", "/generate/stream", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data, first = b"", None
    while True:
        part = resp.read1(1 << 16)
        if not part:
            break
        if first is None:
            first = time.time() - t0
            if on_first_audio is not None:
                on_first_audio()
        data += part
    conn.close()
    return resp.status, np.frombuffer(data, "<i2"), first, time.time() - t0


def server_path(tts, conds, card, ref_path, work_dir):
    """Path L: the stdlib server (``run_server(background=True)``) on
    127.0.0.1 and an ephemeral port, over this full-width model on the card,
    driven over HTTP: /health (device cuda); a voice upload (path D's
    reference WAV) and an emotion profile over it; 4 concurrent /generate at
    MAX_NEW tokens, which must coalesce (fewer than 4 batches); a seeded
    /generate of the profile, equal to a direct ``generate_batch`` on its
    conditionals and seed; 2 concurrent /generate/stream while a bulk
    /generate runs, which must go preemptibly; /generate/stream with
    ``alignment`` answering 400. cuDNN deterministic throughout. Prints each
    request's latency and each stream's time to first audio. Returns the
    launch counts of the whole path."""
    import base64
    import io
    import threading
    import wave

    import numpy as np

    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.serve.config import ServerConfig
    from chatterbox_tpu_torch.serve.server import run_server

    cfg = ServerConfig(host="127.0.0.1", port=0, device="cuda",
                       voice_storage_path=os.path.join(work_dir, "voices"),
                       config_storage_path=os.path.join(work_dir, "configs"),
                       cache_path=os.path.join(work_dir, "cache"),
                       output_path=os.path.join(work_dir, "outputs"))
    saved_conds, tts.conds = tts.conds, conds  # the server's default voice
    reset_launch_counts()
    httpd = run_server(cfg, tts=tts, background=True)
    service, port = httpd.service, httpd.server_address[1]
    lat = {}
    try:
        with deterministic_cudnn():
            status, health, lat["health"] = _http(port, "/health")
            if status != 200 or health["device"] != "cuda" or not health["model_loaded"]:
                fail(f"path L: /health answered {status}: {health}")
            with open(ref_path, "rb") as f:
                status, up, lat["voice upload"] = _http(
                    port, "/voices/upload?filename=reference.wav", "POST", f.read(),
                    "audio/wav")
            status2, prof, lat["emotion create"] = _http(
                port, "/emotions", "POST", {"id": "narrator", "exaggeration": 0.5,
                                            "voice_samples": ["reference.wav"]})
            if status != 200 or status2 != 200:
                fail(f"path L: voice upload / emotion profile answered {status} / {status2}")

            # 4 concurrent /generate: one or more coalesced batches
            b0 = dict(service.batcher.stats)
            res = [None] * 4

            def gen(i):
                res[i] = _http(port, "/generate", "POST",
                               {"text": TEXTS[i], "max_new_tokens": MAX_NEW})

            threads = [threading.Thread(target=gen, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
            batches = service.batcher.stats["batches"] - b0["batches"]
            for i, (status, j, sec) in enumerate(res):
                lat[f"concurrent generate {i}"] = sec
                if status != 200 or not j["success"] or j["duration_seconds"] <= 0:
                    fail(f"path L: concurrent /generate {i} answered {status}")
            print(f"path L: 4 concurrent /generate at {MAX_NEW} tokens ran as {batches} "
                  f"batches (largest {service.batcher.stats['max_batch_seen']})", flush=True)
            if not 1 <= batches < 4:
                fail(f"path L: 4 concurrent /generate ran as {batches} batches, not coalesced")

            # a seeded /generate of the profile against a direct call
            body = {"text": TEXTS[4], "emotion": "narrator", "seed": 17,
                    "max_new_tokens": MAX_NEW}
            status, j, lat["seeded generate (cold profile)"] = _http(port, "/generate", "POST",
                                                                     body)
            if status != 200:
                fail(f"path L: seeded /generate answered {status}: {j}")
            with wave.open(io.BytesIO(base64.b64decode(j["audio_base64"]))) as w:
                got = np.frombuffer(w.readframes(w.getnframes()), "<i2")
            direct = tts.generate_batch([TEXTS[4]], conds=service.voices.get_conditionals(
                "narrator"), seed=17, max_new_tokens=MAX_NEW, exaggeration=0.5)[0]
            want = (np.clip(direct, -1, 1) * 32767).astype(np.int16)
            same = np.array_equal(got, want)
            print(f"path L: seeded /generate ({len(got)} samples) equal to a direct "
                  f"generate_batch on the profile's conditionals: {same}", flush=True)
            if not same:
                fail("path L: the seeded /generate differs from the direct call")

            # 2 concurrent streams, and a bulk /generate while they run
            # (the bulk request goes once a stream has sounded: the streams'
            # group is then live, which is what admission control reads)
            streams, sounding = [None, None], threading.Event()

            def stream(i):
                streams[i] = _http_stream(port, {"text": STREAM_TEXTS[i],
                                                 "max_new_tokens": MAX_NEW}, sounding.set)

            p0 = service.batcher.stats["preempted_batches"]
            threads = [threading.Thread(target=stream, args=(i,)) for i in range(2)]
            for th in threads:
                th.start()
            if not sounding.wait(timeout=300):
                fail("path L: no stream gave audio within 300 s")
            status, j, lat["bulk generate during streams"] = _http(
                port, "/generate", "POST", {"text": TEXTS[5], "max_new_tokens": MAX_NEW})
            for th in threads:
                th.join()
            preempted = service.batcher.stats["preempted_batches"] - p0
            if status != 200:
                fail(f"path L: the bulk /generate during the streams answered {status}")
            for i, (s_status, pcm, first, sec) in enumerate(streams):
                lat[f"stream {i}"] = sec
                print(f"path L: stream {i}: {s_status}, {len(pcm)} samples "
                      f"({len(pcm) / tts.sr:.3f} s of audio), time to first audio "
                      f"{first if first is None else round(first, 4)} s, {sec:.3f} s in all",
                      flush=True)
                if s_status != 200 or len(pcm) == 0 or len(pcm) % 960:
                    fail(f"path L: stream {i} answered {s_status} with {len(pcm)} samples")
            print(f"path L: bulk /generate while 2 streams ran: {preempted} preemptible "
                  f"batches; stream batcher {json.dumps(service.stream_batcher.stats)}",
                  flush=True)
            if preempted < 1:
                fail("path L: the bulk /generate during the streams did not run preemptibly")

            status, j, lat["stream with alignment"] = _http(
                port, "/generate/stream", "POST",
                {"text": TEXTS[6], "alignment": True, "max_new_tokens": MAX_NEW})
            print(f"path L: /generate/stream with alignment=true answered {status}: {j}",
                  flush=True)
            if status != 400:
                fail(f"path L: /generate/stream with alignment answered {status}, not 400")
            status, health, _ = _http(port, "/health")
            print("path L: /health after: " + json.dumps(health), flush=True)
    finally:
        httpd.shutdown()
        service.batcher.shutdown()
        service.stream_batcher.shutdown()
        tts.conds = saved_conds
    counts = launch_counts()
    check_launches("L", counts, (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5))
    print("path L: request latencies (s) " + json.dumps({k: round(v, 4) for k, v in lat.items()})
          + f" on {card}", flush=True)
    print("path L: kernel launches " + json.dumps(counts), flush=True)
    return counts


def main_path(card, ref_path, work_dir):
    import torch

    from chatterbox_tpu_torch import ChatterboxTTS
    from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
    from chatterbox_tpu_torch.models.t3.t3 import T3Config
    from chatterbox_tpu_torch.runtime.precision import apply_tts_precision

    t0 = time.time()
    tts = ChatterboxTTS.from_random(
        seed=0, t3_cfg=T3Config(llama=LlamaConfig(num_hidden_layers=TTS_T3_LAYERS)))
    conds = random_conditionals(tts.device)
    torch.cuda.synchronize()
    print(f"paths: from_random at full width, T3 at {TTS_T3_LAYERS} of {T3_LAYERS} layers, in "
          f"{time.time() - t0:.1f} s", flush=True)
    unet = tts.s3gen_cfg.flow.estimator
    blocks = unet.n_blocks * (2 + unet.num_mid_blocks)  # UNet transformer blocks: 56
    counts, tokens, lens = {}, {}, {}
    for name in PATHS:
        t0 = time.time()
        if name == WQUANT_PATHS[0]:
            # paths H and I on the bf16 weights, before F converts them
            counts["H"] = split_path(tts, conds, card)
            print(f"path H: {time.time() - t0:.1f} s", flush=True)
            # path I at T3's full depth: the cap is the memory of 30 layers
            t0 = time.time()
            full = ChatterboxTTS.from_random(seed=0)
            counts["I"], cap_checks = cap_path(full, conds, card)
            del full
            torch.cuda.empty_cache()
            print(f"path I: {time.time() - t0:.1f} s", flush=True)
            # paths J, K and L on the bf16 weights too
            for path, run in (("J", lambda: stream_path(tts, conds, card)),
                              ("K", lambda: preemptible_path(tts, conds, card)),
                              ("L", lambda: server_path(tts, conds, card, ref_path, work_dir))):
                t0 = time.time()
                counts[path] = run()
                print(f"path {path}: {time.time() - t0:.1f} s", flush=True)
            t0 = time.time()
            apply_tts_precision(tts, weight_quant=True)
            layers = tts.t3_params["llama"]["layers"]
            if not ("w8" in layers["qkv"] and layers["qkv"]["w8"].dtype == torch.int8
                    and "q" not in layers):
                fail(f"path {name}: apply_tts_precision did not give fused int8 T3 weights")
            print(f"path {name}: apply_tts_precision(weight_quant=True) in "
                  f"{time.time() - t0:.1f} s", flush=True)
        c = prepared_conditionals(tts, ref_path, card) if name == "D" else conds
        # K1: one launch a layer a decode step (budget - 1 steps: random
        # weights never stop every row early); path C's alignment layer takes K1b
        steps = PATHS[name][0].get("max_new_tokens", MAX_NEW_DEFAULT) - 1
        exact = {"B": {_K1C: TTS_T3_LAYERS * steps},
                 "C": {_K1A: (TTS_T3_LAYERS - 1) * steps, _K1B: steps}}.get(
                     name, {_K1A: TTS_T3_LAYERS * steps})
        if name == "G":
            exact[_K3] = blocks * TURBO_STEPS
        # a profile takes a call more: on paths A (the bf16 weights) and F
        # (the int8 weights) only, for the run's time limit
        counts[name], tokens[name], lens[name] = run_path(tts, c, card, name,
                                                          name in PROFILED_PATHS, exact)
        check_launches(name, counts[name], _GLUE, (), glue_launches(TTS_T3_LAYERS, steps))
        print(f"path {name}: {time.time() - t0:.1f} s", flush=True)
    # G changes only the flow: its T3 tokens and wav lengths are F's
    f, g = WQUANT_PATHS
    same = all(len(a) == len(b) and (a == b).all() for a, b in zip(tokens[f], tokens[g]))
    print(f"path {g}: speech tokens equal to path {f}'s: {same}; wav lengths equal: "
          f"{lens[f] == lens[g]}", flush=True)
    if not (same and lens[f] == lens[g]):
        fail(f"path {g}: flow_steps={TURBO_STEPS} changed T3's tokens or the wav lengths")
    return counts, cap_checks


def granite_path(card, conds):
    """Path R: ``ChatterboxTTS.from_random(seed=0)`` with T3 on the Granite
    4.0-H backbone at its published widths (all 40 layers: 36 Mamba-2 and
    4 attention, bf16), ``generate_batch`` on the 8 texts at 250 tokens,
    the launch counters set to 0 just before the call and read just after,
    and the program's recorder on for it: each decode step launches the
    update once a Mamba layer and K1a once an attention layer, the step is
    replayed from its graphs after the first, and the wavs are checked.
    Returns the launch counts."""
    import torch

    from chatterbox_tpu_torch import ChatterboxTTS
    from chatterbox_tpu_torch.models.t3.t3 import GraniteT3Config
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.runtime import profiling

    t0 = time.time()
    cfg = GraniteT3Config()
    tts = ChatterboxTTS.from_random(seed=0, t3_cfg=cfg)
    torch.cuda.synchronize()
    print(f"path R: from_random with the Granite 4.0-H T3 ({cfg.granite.num_hidden_layers} "
          f"layers of {cfg.granite.hidden_size}) in {time.time() - t0:.1f} s", flush=True)
    n_m, n_a = len(cfg.granite.mamba_layers), len(cfg.granite.attention_layers)
    reset_launch_counts()
    profiling.take()
    profiling.enable()
    t0 = time.time()
    try:
        wavs = tts.generate_batch(TEXTS, conds=conds, seed=0, max_new_tokens=MAX_NEW)
        torch.cuda.synchronize()
    finally:
        profiling.disable()
    wall = time.time() - t0
    counts = launch_counts()
    rec = profiling.take()
    check_wavs("R", wavs, N_TEXTS)
    steps = MAX_NEW - 1  # decode steps: random weights never stop every row early
    check_launches("R", counts, (_K1A, _K2, _K3, _K4, "ssm_decode_update"),
                   (_K1B, _K1C, _K2B, _K5) + _GLUE,
                   {"ssm_decode_update": n_m * steps, _K1A: n_a * steps})

    def counted(name):
        return rec.counts.get(name, 0) + sum(sp.counts.get(name, 0) for sp in rec.spans)

    step_spans = [sp for sp in rec.spans if sp.name == "t3.step"]
    graphed = counted("t3.graph_steps")
    syncs = sum(sp.counts.get("host_syncs", 0) for sp in step_spans
                if sp.counts.get("t3.graph_steps"))
    print(f"path R: {N_TEXTS} texts at {MAX_NEW} tokens: first call {wall:.3f} s (stages "
          f"{json.dumps(tts.last_timings)}); {len(step_spans)} t3.step spans, {graphed} replayed "
          f"from graphs, {syncs} host syncs in them; t3.ssm_layers {counted('t3.ssm_layers')}, "
          f"t3.ssm_state_bytes {counted('t3.ssm_state_bytes')}", flush=True)
    print("path R: kernel launches " + json.dumps(counts), flush=True)
    if graphed != len(step_spans) - 1 or graphed <= 0:
        fail(f"path R: {graphed} of {len(step_spans)} steps replayed, not all but the first")
    if counted("t3.ssm_layers") != n_m:
        fail(f"path R: t3.ssm_layers {counted('t3.ssm_layers')}, not {n_m}")
    if counted("t3.glue_fused_layers"):  # the Llama step's glue kernels only
        fail(f"path R: t3.glue_fused_layers {counted('t3.glue_fused_layers')}, not 0")
    del tts
    torch.cuda.empty_cache()
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

    counts["pipelined"] = vc_pipelined(fused, src_paths, card)

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


def vc_pipelined(vc, src_paths, card):
    """VC's ``generate_batches_pipelined`` over two batches of half the
    sources (batch c seeded c; the next batch packed on a thread of its
    own while one computes), with the launch counters set to
    0 just before the first call and read just after; its wavs must equal
    per-batch ``generate_batch`` calls bit for bit, with cuDNN's algorithms
    deterministic. Then both timed warm. Returns the first call's counts."""
    import numpy as np
    import torch

    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts

    half = N_SOURCES // 2
    batches = [src_paths[:half], src_paths[half:]]
    with deterministic_cudnn():
        reset_launch_counts()
        piped = vc.generate_batches_pipelined(batches)
        torch.cuda.synchronize()
        counts = launch_counts()
        t0 = time.time()
        direct = [vc.generate_batch(srcs, seed=c) for c, srcs in enumerate(batches)]
        torch.cuda.synchronize()
        sequential = time.time() - t0
        t0 = time.time()
        vc.generate_batches_pipelined(batches)
        torch.cuda.synchronize()
        warm = time.time() - t0
    check_launches("E (pipelined)", counts, (_K3, _K4), (_K5,) + _T3)
    for c in range(2):
        check_wavs("E (pipelined)", piped[c], half)
        if not all(np.array_equal(a, b) for a, b in zip(piped[c], direct[c])):
            fail(f"path E: generate_batches_pipelined's batch {c} differs from generate_batch's")
    audio_s = sum(len(w) for ws in piped for w in ws) / vc.sr
    print(f"path E (pipelined): 2 batches of {half} sources equal to per-batch calls bit for "
          f"bit; warm wall {warm:.3f} s against {sequential:.3f} s for the per-batch calls, "
          f"audio {audio_s:.3f} s, audio_sec_per_s_per_chip {audio_s / warm:.4f} on {card}",
          flush=True)
    print("path E (pipelined): kernel launches " + json.dumps(counts), flush=True)
    return counts


# path M: the reference checkpoint set, written from the from_random model
# and loaded back; the 2-text calls' budget, the VC sources it converts, and
# the Perth net's topology (tests/torch_perth_ref.py's defaults: n_fft 1024)
M_SHORT_TOKENS = 100
M_VC_SOURCES = 2
PERTH_TOPOLOGY = {"n_bins": 513, "hidden": 256, "n_layers": 4}
PERTH_ATOL = 1e-5  # tests/test_torch_checkpoint.py's, against the JAX package


def same_params(what, got, want, path="M"):
    """Fail unless both parameter trees hold the same leaves, each of the
    same dtype and shape and equal bit for bit (compared as integers)."""
    import torch

    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten

    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    a, b = flatten(got), flatten(want)
    if a.keys() != b.keys():
        fail(f"path {path}: {what}: leaves differ: {sorted(a.keys() ^ b.keys())[:10]}")
    for k, x in a.items():
        y = b[k]
        if x.dtype != y.dtype or x.shape != y.shape or x.device != y.device:
            fail(f"path {path}: {what}: {k}: {x.dtype} {tuple(x.shape)} on {x.device}, not "
                 f"{y.dtype} {tuple(y.shape)} on {y.device}")
        it = ints[x.element_size()]
        if not torch.equal(x.contiguous().view(it), y.contiguous().view(it)):
            fail(f"path {path}: {what}: {k} differs")
    dtypes = sorted({str(x.dtype).replace("torch.", "") for x in a.values()})
    print(f"path {path}: {what}: {len(a)} leaves equal bit for bit ({', '.join(dtypes)})",
          flush=True)


class RssPeak:
    """The largest resident set of this process while the block runs, read
    every 10 ms from /proc/self/statm on a thread (None where that file
    cannot be read), beside the process's lifetime peak (``ru_maxrss``)
    before and after the block."""

    def __enter__(self):
        import resource
        import threading

        self.start = self.peak = None
        self.maxrss_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        page = os.sysconf("SC_PAGE_SIZE")
        while True:
            try:
                with open("/proc/self/statm") as f:
                    rss = int(f.read().split()[1]) * page
            except (OSError, ValueError, IndexError):
                return
            self.start = rss if self.start is None else self.start
            self.peak = max(self.peak or 0, rss)
            if self._stop.wait(0.01):
                return

    def __exit__(self, *exc):
        import resource

        self._stop.set()
        self._thread.join()
        self.maxrss_after = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss

    def __str__(self):
        sampled = ("not measured" if self.peak is None else
                   f"{self.peak} bytes, {self.start} at the start")
        return (f"peak RSS {sampled} (sampled every 10 ms), the process's lifetime peak "
                f"{self.maxrss_before * 1024} -> {self.maxrss_after * 1024} bytes")


class WatermarkSpy:
    """A watermarker that records the (B, T) batch each ``apply`` is given
    (the pipeline's unwatermarked wavs) and applies ``engine``."""

    def __init__(self, engine):
        self.engine, self.seen = engine, []

    def apply(self, wav):
        self.seen.append(wav.clone())
        return self.engine.apply(wav)


def reference_set_path(card, ref_path, src_paths, native):
    """Path M: the reference checkpoint set. The ``from_random(seed=0)``
    model (path E's weights, and paths A-L's with T3's 30 layers) is
    written in the reference format
    (``tests/torch_reference_format.py``: fp32 ``t3_cfg`` under a
    ``model.`` prefix, HiFT's weight-norm pairs spelled
    ``parametrizations.weight.*``, the ``tokenizer.`` subtree, a
    ``tokenizer.json``, a ``conds.pt`` and a random Perth net's
    ``perth.pth``) into a directory of the checkout, removed at the end, and
    loaded back on the card:
      1. ``ChatterboxTTS.from_local``: every leaf and the conditionals equal
         the written model's bit for bit (load wall seconds, peak RSS);
      2. path A's call on the loaded model, counted (K1a x 30 x 249, K2, K3,
         K4; no K1b, K1c+d, K2b, K5): tokens and wavs (cuDNN deterministic)
         equal to the written model's, the call timed;
      3. ``save_native`` into ``native`` (kept for path Q) then
         ``from_native``: the same leaves, and a 2-text call's tokens equal
         to the loaded model's (step 5's first call);
      4. ``ChatterboxVC.from_local``: S3Gen equal, two of path E's sources
         converted to the written model's wavs;
      5. the Perth factory on ``perth.pth``: the engine on the card within
         ``PERTH_ATOL`` of its CPU run on step 2's wavs and the reference
         voice, then in the pipeline, the vocoder gained to a speaking
         level: a 2-text call's tokens equal the spread-spectrum call's,
         its int16 wavs differ from that call's and equal the engine
         applied alone to the call's unwatermarked batch; then a 2-text
         stream of ``M_SHORT_TOKENS`` with each engine: every chunk is
         watermarked on the card, the neural stream's chunks equal the
         engine applied alone to its unwatermarked chunks, which equal the
         spread-spectrum stream's.
    Returns step 2's first-call launch counts and the T3 tree step 3 saved
    (CPU tensors in the JAX layouts)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_reference_format as rf
    from torch_perth_ref import PerthNetImplicitRef

    from chatterbox_tpu_torch import ChatterboxTTS, ChatterboxVC, weights
    from chatterbox_tpu_torch.constants import S3GEN_SR
    from chatterbox_tpu_torch.models.watermark import PerthImplicitWatermarker, PerthNetImplicit
    from chatterbox_tpu_torch.pipeline.audio import load_wav
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.pipeline.streaming import StreamConfig, stream_generate_batch

    t0 = time.time()
    ref = ChatterboxTTS.from_random(seed=0)
    conds = random_conditionals(ref.device)
    torch.cuda.synchronize()
    print(f"path M: from_random at full width in {time.time() - t0:.1f} s", flush=True)
    with tempfile.TemporaryDirectory(prefix=".smoke_reference_", dir=HERE) as work:
        ckpt = os.path.join(work, "reference")
        t0 = time.time()
        rf.write_reference_set(
            ckpt, *(weights.to_jax_tree(p) for p in (ref.t3_params, ref.s3gen_params,
                                                     ref.ve_params)),
            conds=[x.cpu().numpy() for x in (*conds.t3, *conds.gen)], t3_prefix="model.",
            weight_norm="parametrizations")
        torch.manual_seed(0)
        torch.save({"model": PerthNetImplicitRef(**PERTH_TOPOLOGY).state_dict()},
                   os.path.join(ckpt, "perth.pth"))
        sizes = {f: os.path.getsize(os.path.join(ckpt, f)) for f in sorted(os.listdir(ckpt))}
        print(f"path M: reference set written in {time.time() - t0:.1f} s: "
              + json.dumps(sizes), flush=True)

        # 1. from_local on the card
        with RssPeak() as rss:
            t0 = time.time()
            tts = ChatterboxTTS.from_local(ckpt)
            torch.cuda.synchronize()
            load_s = time.time() - t0
        print(f"path M: from_local of {sum(sizes.values())} bytes in {load_s:.3f} s; during "
              f"the load {rss} on {card}", flush=True)
        for name in ("t3_params", "s3gen_params", "ve_params"):
            same_params(f"from_local {name}", getattr(tts, name), getattr(ref, name))
        for got, want in zip((*tts.conds.t3, *tts.conds.gen), (*conds.t3, *conds.gen)):
            if got.dtype != want.dtype or not torch.equal(got, want.cpu()):
                fail("path M: the conditionals from conds.pt differ from those written")
        if tts.s3gen_cfg != ref.s3gen_cfg or tts.t3_cfg != ref.t3_cfg:
            fail("path M: from_local's configs differ from the written model's")
        # the written model reads the texts with the set's tokenizer.json too
        ref.tokenizer = tts.tokenizer

        # 2. path A's call on the loaded model against the written model's
        kw = {"seed": 0, "max_new_tokens": MAX_NEW}
        with deterministic_cudnn():
            reset_launch_counts()
            t0 = time.time()
            wavs = tts.generate_batch(TEXTS, **kw)
            torch.cuda.synchronize()
            first = time.time() - t0
            counts = launch_counts()
            tokens = [r.copy() for r in tts.last_speech_tokens]
            want_wavs = ref.generate_batch(TEXTS, conds=conds, **kw)
        check_wavs("M", wavs, N_TEXTS)
        check_launches("M", counts, (_K1A, _K2, _K3, _K4), (_K1B, _K1C, _K2B, _K5),
                       {_K1A: T3_LAYERS * (MAX_NEW - 1)})
        if not all(np.array_equal(a, b) for a, b in zip(tokens, ref.last_speech_tokens)):
            fail("path M: the loaded model's tokens differ from the written model's")
        if not all(np.array_equal(a, b) for a, b in zip(wavs, want_wavs)):
            fail("path M: the loaded model's wavs differ from the written model's")
        audio_s = sum(len(w) for w in wavs) / tts.sr
        print(f"path M: {N_TEXTS} texts, {json.dumps(kw)}: first call {first:.3f} s, audio "
              f"{audio_s:.3f} s, audio_sec_per_s_per_chip_b8 {audio_s / first:.4f}; tokens and "
              f"wavs equal to the written model's (cuDNN deterministic) on {card}", flush=True)
        print("path M: kernel launches " + json.dumps(counts), flush=True)

        # 3. save_native -> from_native
        t0 = time.time()
        tts.save_native(native)
        saved = time.time() - t0
        saved_t3 = weights.jax_layout(tts.t3_params)  # the tree save_native wrote
        t0 = time.time()
        # save_native writes no tokenizer.json (nor does the JAX package's)
        back = ChatterboxTTS.from_native(native, tokenizer_json=os.path.join(ckpt,
                                                                             "tokenizer.json"))
        torch.cuda.synchronize()
        print(f"path M: save_native in {saved:.1f} s, from_native in {time.time() - t0:.1f} s",
              flush=True)
        for name in ("t3_params", "s3gen_params", "ve_params"):
            same_params(f"save_native -> from_native {name}", getattr(back, name),
                        getattr(tts, name))
        # its 2-text call's tokens are held to the loaded model's in step 5
        short = {"seed": 0, "max_new_tokens": M_SHORT_TOKENS}
        back.generate_batch(TEXTS[:2], **short)
        native_tokens = [r.copy() for r in back.last_speech_tokens]
        del back

        # 4. VC from the reference set
        vc = ChatterboxVC.from_local(ckpt)
        same_params("ChatterboxVC.from_local s3gen_params", vc.s3gen_params, ref.s3gen_params)
        srcs = src_paths[:M_VC_SOURCES]
        with deterministic_cudnn():
            got = vc.generate_batch(srcs, target_voice_path=ref_path)
            want = ChatterboxVC(ref.s3gen_params, ref.device, ref.s3gen_cfg).generate_batch(
                srcs, target_voice_path=ref_path)
        check_wavs("M (VC)", got, M_VC_SOURCES)
        if not all(np.array_equal(a, b) for a, b in zip(got, want)):
            fail("path M: ChatterboxVC.from_local's wavs differ from the written model's")
        print(f"path M: ChatterboxVC.from_local: {M_VC_SOURCES} sources equal to the written "
              f"model's", flush=True)
        del vc, ref

        # 5. the neural Perth engine, on the card against the CPU, then in the
        # pipeline
        engine = PerthImplicitWatermarker(checkpoint=os.path.join(ckpt, "perth.pth"))
        if not isinstance(engine, PerthNetImplicit):
            fail(f"path M: the Perth factory gave {type(engine).__name__}")
        # step 2's wavs (random weights: quiet) and the reference voice
        # (synthetic speech at a speaking level)
        voice = load_wav(ref_path, S3GEN_SR)
        batch = np.zeros((len(wavs) + 1, max(len(voice), *(len(w) for w in wavs))), np.float32)
        for i, w in enumerate([*wavs, voice]):
            batch[i, : len(w)] = w
        x = torch.from_numpy(batch)
        t0 = time.time()
        on_card = engine.apply(x.to(tts.device)).cpu()
        card_s = time.time() - t0
        t0 = time.time()
        on_cpu = engine.apply(x)
        err = float((on_card - on_cpu).abs().max())
        peaks = float(np.abs(batch[:-1]).max()), float(np.abs(voice).max())
        print(f"path M: Perth ({engine.n_fft}-point STFT) on {tuple(batch.shape)} (peaks "
              f"{peaks[0]:.4f} for the wavs, {peaks[1]:.4f} for the voice): card {card_s:.3f} s (first call), CPU {time.time() - t0:.3f} s, "
              f"max_abs_err {err:.3e} tol {PERTH_ATOL:.0e}; the voice's largest change "
              f"{float((on_cpu[-1] - x[-1]).abs().max()):.4f}", flush=True)
        if not err <= PERTH_ATOL:
            fail(f"path M: the Perth engine on the card is {err} from its CPU run")
        # the pipeline, its vocoder's magnitudes gained as path J's exact-window
        # check gains them, so that the wavs reach a speaking level and the
        # watermark shows in int16; the spread-spectrum call first
        hift = tts.s3gen_params["hift"]
        post = hift["conv_post"]
        bias = post["b"].clone()
        bias[: tts.s3gen_cfg.hift.istft_n_fft // 2 + 1] += math.log(STREAM_EXACT_GAIN)
        hift["conv_post"] = {**post, "b": bias}
        spread_engine, spy = tts.watermarker, WatermarkSpy(engine)
        try:
            with deterministic_cudnn():
                spread = tts.generate_batch(TEXTS[:2], **short)
                spread_tokens = [r.copy() for r in tts.last_speech_tokens]
                tts.watermarker = spy
                marked = tts.generate_batch(TEXTS[:2], **short)
                if len(spy.seen) != 1:
                    fail(f"path M: the pipeline watermarked {len(spy.seen)} batches, not 1")
                alone = engine.apply(spy.seen[0])
                # a stream with each engine: the chunks go to the card for it
                streams, m_stream = {}, StreamConfig(max_new_tokens=M_SHORT_TOKENS)
                for name, wm in (("spread", spread_engine), ("neural", engine)):
                    tts.watermarker = stream_spy = WatermarkSpy(wm)
                    t0 = time.time()
                    # the chunks in the order they were watermarked: tick by
                    # tick, the rows in order
                    chunks = [c for tick in stream_generate_batch(tts, TEXTS[:2], stream=m_stream,
                                                                  seed=0)
                              for c in tick if c is not None]
                    streams[name] = chunks, stream_spy.seen, time.time() - t0
        finally:
            hift["conv_post"], tts.watermarker = post, spread_engine
        alone = (torch.round(torch.clamp(alone, -1.0, 1.0) * 32767.0).to(torch.int16).cpu()
                 .numpy().astype(np.float32) / 32767.0)
        check_wavs("M (Perth)", marked, 2)
        if not all(np.array_equal(a, b) for a, b in zip(native_tokens, spread_tokens)):
            fail("path M: from_native's tokens differ from the loaded model's")
        if not all(np.array_equal(a, b) for a, b in zip(tts.last_speech_tokens, spread_tokens)):
            fail("path M: the neural engine changed T3's tokens")
        if not all(np.array_equal(w, alone[i, : len(w)]) for i, w in enumerate(marked)):
            fail("path M: the pipeline's neural watermark differs from the engine's alone")
        moved = max(float(np.abs(a - b).max()) for a, b in zip(marked, spread))
        peak = max(float(np.abs(w).max()) for w in marked)
        print(f"path M: the neural engine in the pipeline (vocoder gain {STREAM_EXACT_GAIN:g}, "
              f"peak {peak:.4f}): tokens equal to the spread-spectrum call's, int16 wavs equal "
              f"to the engine applied alone; max |neural - spread-spectrum| {moved:.4f}",
              flush=True)
        if not moved > 0:
            fail("path M: the neural engine's wavs equal the spread-spectrum engine's")
        for name, (chunks, seen, _) in streams.items():
            if not chunks or len(chunks) != len(seen):
                fail(f"path M: the {name} stream watermarked {len(seen)} chunks of "
                     f"{len(chunks)}")
            if any(x.device.type != tts.device.type or x.shape != (1, len(c))
                   for x, c in zip(seen, chunks)):
                fail(f"path M: the {name} stream watermarked a chunk off the card or cut")
        (s_chunks, s_seen, s_wall), (n_chunks, n_seen, n_wall) = (streams["spread"],
                                                                  streams["neural"])
        if not all(torch.equal(a, b) for a, b in zip(s_seen, n_seen)):
            fail("path M: the two streams' unwatermarked chunks differ")
        with deterministic_cudnn():
            alone = [engine.apply(x)[0].cpu().numpy() for x in n_seen]
        if not all(np.array_equal(c, a) for c, a in zip(n_chunks, alone)):
            fail("path M: the stream's neural watermark differs from the engine's alone")
        moved = max(float(np.abs(a - b).max()) for a, b in zip(n_chunks, s_chunks))
        if not moved > 0:
            fail("path M: the neural stream's chunks equal the spread-spectrum stream's")
        print(f"path M: 2-text streams of {M_SHORT_TOKENS} tokens (vocoder gain "
              f"{STREAM_EXACT_GAIN:g}): {len(n_chunks)} chunks each, every one watermarked on "
              f"the card; the neural chunks equal the engine applied alone, the unwatermarked "
              f"chunks equal the spread-spectrum stream's; max |neural - spread-spectrum| "
              f"{moved:.4f}; wall {s_wall:.3f} s spread-spectrum, {n_wall:.3f} s neural (first "
              f"calls) on {card}", flush=True)
    return counts, saved_t3


# path Q: voice embeddings from wavs at any rate, the Kaiser designs, load_params
Q_RATES = (16000, 24000, 44100)
Q_EMBED_ATOL = 1e-4  # tests/test_torch_conditioning.py's card-against-CPU bound
Q_RESAMPLE_ATOL = 1e-5  # fp32 sums of ~88 (kaiser_fast) or ~352 (kaiser_best) terms
Q_RESAMPLE_CALLS = 20


def voice_path(card, native):
    """Path Q: ``ve_embed_from_wavs`` of path D's seeded 10 s synthetic
    voice made at each of ``Q_RATES`` (the full-width ``VoiceEncoderConfig()``
    with the weights ``from_random(seed=0)`` gives it) on the card and on the
    CPU, within ``Q_EMBED_ATOL``, and the cosines of the other rates'
    embeddings to the 16 kHz one; ``resample`` 44.1 -> 16 kHz with
    kaiser_fast and kaiser_best on the card against the CPU, within
    ``Q_RESAMPLE_ATOL``, each timed as the mean of ``Q_RESAMPLE_CALLS`` eager
    calls (between CUDA events on the card: the taps' upload included; by
    the host's clock on the CPU); ``load_params`` of path M's
    ``t3.jax.safetensors`` on the card, bit for bit against the tree path M
    saved (``native``: path M's returns)."""
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten, load_params
    from chatterbox_tpu_torch.core.resample import resample
    from chatterbox_tpu_torch.device import full_fp32
    from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig, ve_embed_from_wavs
    from chatterbox_tpu_torch.pipeline.audio import synthetic_voice

    native_dir, saved_t3 = native
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    cfg = VoiceEncoderConfig()
    ve = {"card": weights.init_voice_encoder(cfg, 5, dev)}  # from_random(seed=0)'s VE
    ve["CPU"] = weights.tree_to(ve["card"], cpu)
    embeds = {}
    for sr in Q_RATES:
        voice = synthetic_voice(1000, REF_SECONDS, sr)  # path D's reference, made at sr
        walls = {}
        for where in ("card", "CPU"):
            t0 = time.time()
            e = ve_embed_from_wavs(ve[where], cfg, voice, sr)
            walls[where] = time.time() - t0
            embeds[sr, where] = e.cpu()
        got, want = embeds[sr, "card"], embeds[sr, "CPU"]
        err = float((got - want).abs().max())
        print(f"path Q: ve_embed_from_wavs of a {REF_SECONDS:.0f} s voice at {sr} Hz "
              f"{tuple(got.shape)}: card vs CPU max_abs_err={err:.3e} tol={Q_EMBED_ATOL:.0e}; "
              f"wall card {walls['card']:.3f} s, CPU {walls['CPU']:.3f} s (first calls)",
              flush=True)
        if got.shape != (1, cfg.speaker_embed_size) or not torch.isfinite(got).all():
            fail(f"path Q: the {sr} Hz embedding is {tuple(got.shape)} or not finite")
        if not err <= Q_EMBED_ATOL:
            fail(f"path Q: the {sr} Hz embedding on the card is {err} from the CPU's")
    base = embeds[Q_RATES[0], "card"][0]
    cosines = {sr: float(embeds[sr, "card"][0] @ base) for sr in Q_RATES[1:]}
    print("path Q: cosine of each rate's embedding (card) to the 16000 Hz one "
          + json.dumps(cosines), flush=True)

    wav = torch.from_numpy(synthetic_voice(1000, REF_SECONDS, 44100))
    for quality in ("kaiser_fast", "kaiser_best"):
        want = resample(wav, 44100, 16000, quality)
        t0 = time.perf_counter()
        for _ in range(Q_RESAMPLE_CALLS):
            resample(wav, 44100, 16000, quality)
        cpu_ms = (time.perf_counter() - t0) * 1e3 / Q_RESAMPLE_CALLS
        x = wav.to(dev)
        with full_fp32():
            got = resample(x, 44100, 16000, quality)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(Q_RESAMPLE_CALLS):
                resample(x, 44100, 16000, quality)
            end.record()
            torch.cuda.synchronize()
        card_ms = start.elapsed_time(end) / Q_RESAMPLE_CALLS
        err = float((got.cpu() - want).abs().max())
        print(f"path Q: resample {quality} 44100 -> 16000 Hz of {REF_SECONDS:.0f} s "
              f"({tuple(got.shape)}): card {card_ms:.4f} ms, CPU {cpu_ms:.3f} ms (means of "
              f"{Q_RESAMPLE_CALLS} eager calls); card vs CPU max_abs_err={err:.3e} "
              f"tol={Q_RESAMPLE_ATOL:.0e} on {card}", flush=True)
        if not err <= Q_RESAMPLE_ATOL:
            fail(f"path Q: resample {quality} on the card is {err} from the CPU's")

    path = os.path.join(native_dir, "t3.jax.safetensors")
    t0 = time.time()
    loaded = load_params(path)
    torch.cuda.synchronize()
    load_s = time.time() - t0
    devices = {str(x.device) for x in flatten(loaded).values() if isinstance(x, torch.Tensor)}
    print(f"path Q: load_params of path M's t3.jax.safetensors ({os.path.getsize(path)} bytes) "
          f"on the card in {load_s:.3f} s, leaves on {sorted(devices)}", flush=True)
    if devices != {"cuda:0"}:
        fail(f"path Q: load_params put leaves on {sorted(devices)}")
    same_params("load_params of t3.jax.safetensors", weights.tree_to(loaded, cpu), saved_t3,
                path="Q")


# path N: T3 training at full width, and cfm_loss at the full flow width
N_BATCH, N_TEXT, N_SPEECH = 8, 128, 512  # 20 s of speech at 25 Hz a row
N_TEXT_LENS, N_SPEECH_LENS = (64, 128), (256, 512)
N_WARM, N_TIMED, N_LR = 2, 4, 1e-4
N_PARAMS = 532_397_056  # T3Config(): Llama-520M, the cond encoder, embeddings and heads
N_SMALL_LAYERS = 4  # the card-against-CPU model: the main path's width, 4 layers
N_SMALL_STEPS = 3
N_LOSS_RTOL = 1e-4  # card against CPU, fp32 without TF32: summation order only
N_GRAD_SHARE = 1e-4  # of each leaf's max, the same
N_UPDATE_ATOL = 2.5e-7  # AdamW from the same gradients: two fp32 ulps at 1.0
N_PARAM_ATOL = N_LR / 20  # after N_SMALL_STEPS steps, but for the outliers below
N_PARAM_OUTLIERS = 1e-4  # the share of elements allowed over N_PARAM_ATOL
N_PARAM_CAP = 3 * N_LR * N_SMALL_STEPS  # any element: ~1.5 lr a step, either sign
CFM_ROWS, CFM_T = 8, 1000
CFM_BLOCKS = 56  # UNet transformer blocks: 4 down + 12 x 4 mid + 4 up, one K3 each
CFM_RTOL = 2.0 ** -7  # K3 against the dense path in bf16: one bf16 rounding of P and out


def train_batch(seed, b=N_BATCH, tt=N_TEXT, ts=N_SPEECH, text_lens=N_TEXT_LENS,
                speech_lens=N_SPEECH_LENS):
    """A seeded T3 training batch (the JAX trainer's keys), right-padded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    return {
        "speaker_emb": rng.standard_normal((b, 256)).astype(np.float32),
        "prompt_tokens": rng.integers(0, 6561, (b, 150)).astype(np.int32),
        "emotion_adv": np.full((b,), 0.5, np.float32),
        "text_tokens": rng.integers(0, 704, (b, tt)).astype(np.int32),
        "text_lens": rng.integers(text_lens[0], text_lens[1] + 1, (b,)).astype(np.int32),
        "speech_tokens": rng.integers(0, 6561, (b, ts)).astype(np.int32),
        "speech_lens": rng.integers(speech_lens[0], speech_lens[1] + 1, (b,)).astype(np.int32),
    }


def train_step_flops(cfg, b, tt, ts):
    """Operations of one train step (forward and backward, 3x the forward's
    products): every Llama matrix product over the B x S positions, the two
    heads over their spans, and the dense attention's full S x S products
    (``core/layers.sdpa`` computes every key, the causal half included);
    the cond encoder's perceiver is under 0.1% and left out."""
    lc = cfg.llama
    s = cfg.n_cond + tt + ts
    hd = lc.num_attention_heads * lc.head_dim
    kvd = lc.num_key_value_heads * lc.head_dim
    c, f = lc.hidden_size, lc.intermediate_size
    layer_w = c * hd + 2 * c * kvd + hd * c + 3 * c * f
    fwd = (2 * lc.num_hidden_layers * layer_w * b * s
           + 2 * c * cfg.text_tokens_dict_size * b * tt
           + 2 * c * cfg.speech_tokens_dict_size * b * ts
           + lc.num_hidden_layers * 4 * b * s * s * hd)
    return 3 * fwd


def check_train_grads(params, grads, batch):
    """Every leaf the loss reaches has a finite gradient with a nonzero
    element (each layer of a stacked Llama leaf on its own); each table's
    rows of tokens at valid positions are nonzero, its rows that no position
    reads exactly 0. The perceiver's key bias is only held finite: a bias
    on every key shifts each query's logits by one constant, which the
    softmax cancels, so its gradient is 0 in exact arithmetic."""
    import torch

    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten

    def rows(key, lens=None, offset=0):
        tok = torch.as_tensor(batch[key]).long()
        if lens is None:
            return set(tok.flatten().tolist()), set(tok.flatten().tolist())
        valid = torch.arange(tok.shape[1])[None] < torch.as_tensor(batch[lens])[:, None]
        return set(tok[valid].tolist()), set(tok.flatten().tolist())

    pos = {"text_pos_emb": (set(range(int(max(batch["text_lens"])))), set(range(N_TEXT))),
           "speech_pos_emb": (set(range(max(int(max(batch["speech_lens"])), 150))),
                              set(range(max(N_SPEECH, 150))))}
    prompt_rows, _ = rows("prompt_tokens")
    speech_valid, speech_any = rows("speech_tokens", "speech_lens")
    tables = {"text_emb": rows("text_tokens", "text_lens"),
              "speech_emb": (speech_valid | prompt_rows, speech_any | prompt_rows), **pos}
    n_checked = 0
    for name, g in flatten(grads).items():
        if not bool(torch.isfinite(g).all()):
            fail(f"path N: the gradient of {name} is not finite")
        table = name.split("/")[0]
        if name == "cond_enc/perceiver/attn/to_k/b":
            continue
        if table in tables:
            valid, used = tables[table]
            nz = g.abs().amax(dim=-1) > 0
            zero_rows = sorted(r for r in valid if not bool(nz[r]))
            stray = [r for r in torch.nonzero(nz).flatten().tolist() if r not in used]
            if zero_rows or stray:
                fail(f"path N: {name}: rows read at valid positions with a zero gradient "
                     f"{zero_rows[:5]}, rows never read with a nonzero one {stray[:5]}")
        elif name.startswith("llama/layers/"):
            per_layer = g.flatten(1).abs().amax(dim=1)
            if not bool((per_layer > 0).all()):
                dead = torch.nonzero(per_layer == 0).flatten().tolist()
                fail(f"path N: {name}: layers {dead} have a zero gradient")
        elif not float(g.abs().max()) > 0:
            fail(f"path N: the gradient of {name} is 0: the loss does not reach it")
        n_checked += 1
    print(f"path N: gradients of {len(flatten(grads))} leaves finite; {n_checked} nonzero "
          f"(stacked Llama leaves layer by layer, tables row by row: read rows nonzero, "
          f"unread rows 0)", flush=True)


def leaf_worst(got, want):
    """Max over leaves of max |got - want| (the trees' leaves in order)."""
    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten

    return max(float((a.cpu() - b.cpu()).abs().max())
               for a, b in zip(flatten(got).values(), flatten(want).values()))


def train_small_against_cpu():
    """T3 with N_SMALL_LAYERS layers at the main path's width, card against
    CPU in fp32 from the same weights and batches:
      1. the first gradients, leaf by leaf, within N_GRAD_SHARE of each
         leaf's max (summation order is all that differs);
      2. one AdamW update on the card from the CPU's gradients and state:
         params, mu and nu within N_UPDATE_ATOL (the same elementwise ops);
      3. N_SMALL_STEPS train steps: losses within N_LOSS_RTOL; params within
         N_PARAM_ATOL except a share of at most N_PARAM_OUTLIERS of the
         elements, all within N_PARAM_CAP. Adam divides each gradient
         element by sqrt(nu) + 1e-8, so an element whose gradient is at the
         two sides' rounding noise (~1e-9 against leaf maxima of ~0.1; a
         few hundred of the 96 M on an H100) takes an update of either sign
         on either side, up to ~1.5 lr a step."""
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten, unflatten
    from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
    from chatterbox_tpu_torch.models.t3.t3 import T3Config
    from chatterbox_tpu_torch.train.train_step import (adamw_init, adamw_update,
                                                       t3_loss_and_grads)
    from chatterbox_tpu_torch.train.trainer import T3Trainer, _batch_to

    cfg = T3Config(llama=LlamaConfig(num_hidden_layers=N_SMALL_LAYERS))
    params = weights.init_t3(cfg, seed=1)
    batches = [train_batch(20 + i, b=2, tt=32, ts=64, text_lens=(20, 32), speech_lens=(40, 64))
               for i in range(N_SMALL_STEPS)]
    t0 = time.time()
    on_card = weights.tree_to(params, "cuda")
    g_card = t3_loss_and_grads(on_card, cfg, _batch_to(batches[0], "cuda"))[3]
    g_cpu = t3_loss_and_grads(params, cfg, _batch_to(batches[0], "cpu"))[3]
    # the perceiver's key bias: 0 in exact arithmetic (see check_train_grads)
    share = max(float((a.cpu() - b).abs().max()) / float(b.abs().max())
                for k, a, b in zip(flatten(g_cpu), flatten(g_card).values(),
                                   flatten(g_cpu).values())
                if k != "cond_enc/perceiver/attn/to_k/b")

    # 2. the update alone, from the same gradients
    p_cpu = unflatten({k: v.clone() for k, v in flatten(params).items()})
    s_card, s_cpu = adamw_init(on_card), adamw_init(p_cpu)
    s_card = adamw_update(on_card, s_card, weights.tree_to(g_cpu, "cuda"), N_LR)
    s_cpu = adamw_update(p_cpu, s_cpu, g_cpu, N_LR)
    upd = max(leaf_worst(on_card, p_cpu), leaf_worst(s_card.mu, s_cpu.mu),
              leaf_worst(s_card.nu, s_cpu.nu))

    # 3. train steps
    card = T3Trainer(cfg, params, learning_rate=N_LR, donate=False)
    cpu = T3Trainer(cfg, params, learning_rate=N_LR, donate=False, device="cpu")
    worst_loss = 0.0
    for b in batches:
        mc, mp = card.step(b), cpu.step(b)
        worst_loss = max(worst_loss, *(abs(mc[k] - mp[k]) / abs(mp[k]) for k in mp))
    diffs = [(a.cpu() - b).abs() for a, b in zip(flatten(card.params).values(),
                                                flatten(cpu.params).values())]
    n = sum(d.numel() for d in diffs)
    worst_p = max(float(d.max()) for d in diffs)
    outliers = sum(int((d > N_PARAM_ATOL).sum()) for d in diffs)
    print(f"path N: {N_SMALL_LAYERS}-layer T3 at width {cfg.dim} ({n} params), card against "
          f"CPU: first gradients' worst leaf {share:.3e} of its max ({share / N_GRAD_SHARE:.3f} "
          f"of {N_GRAD_SHARE:g}); AdamW from the same gradients {upd:.3e} "
          f"({upd / N_UPDATE_ATOL:.3f} of {N_UPDATE_ATOL:g}); {N_SMALL_STEPS} steps: losses rel "
          f"{worst_loss:.3e} ({worst_loss / N_LOSS_RTOL:.3f} of {N_LOSS_RTOL:g}), params: "
          f"{outliers} elements ({outliers / n:.2e}, {outliers / n / N_PARAM_OUTLIERS:.3f} of "
          f"the {N_PARAM_OUTLIERS:g} allowed) over lr/20, the worst {worst_p:.3e} "
          f"({worst_p / N_PARAM_CAP:.3f} of {N_PARAM_CAP:g}); {time.time() - t0:.1f} s",
          flush=True)
    if not (share <= N_GRAD_SHARE and upd <= N_UPDATE_ATOL and worst_loss <= N_LOSS_RTOL
            and outliers <= N_PARAM_OUTLIERS * n and worst_p <= N_PARAM_CAP):
        fail("path N: the small T3's training on the card differs from the CPU's")


def cfm_phase(counts_before_read):
    """cfm_loss at the full flow width on CFM_ROWS rows of CFM_T frames, one
    set of draws: with the kernel under no_grad (the launches counted:
    K3 once a transformer block), against the dense path; the kernel under
    autograd must raise; the dense path's gradient in fp32 must be finite.
    ``counts_before_read`` is called right after the counted call."""
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten
    from chatterbox_tpu_torch.models.s3gen.flow import FlowConfig
    from chatterbox_tpu_torch.train.losses import cfm_draws, cfm_loss
    from chatterbox_tpu_torch.train.train_step import _like

    cfg = FlowConfig()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    flow = weights.init_flow(cfg, seed=0, device=dev, dtype=torch.bfloat16)
    x1, mu, cond = (torch.randn((CFM_ROWS, CFM_T, 80), generator=g, device=dev) * 0.5
                    for _ in range(3))
    spks = torch.randn((CFM_ROWS, 80), generator=g, device=dev)
    lens = torch.linspace(0.7 * CFM_T, CFM_T, CFM_ROWS, device=dev).long()
    mask = torch.arange(CFM_T, device=dev)[None] < lens[:, None]
    draws = cfm_draws(x1, g)
    x1b, mub, spksb, condb = (a.to(torch.bfloat16) for a in (x1, mu, spks, cond))
    bf = (x1b, mask, mub, spksb, condb)
    with torch.no_grad():
        t0 = time.time()
        loss_k = cfm_loss(flow, cfg, *bf, draws=draws)
        torch.cuda.synchronize()
        k_s = time.time() - t0
        counts = counts_before_read()
        t0 = time.time()
        loss_d = cfm_loss(flow, cfg, *bf, draws=draws, use_flash=False)
        torch.cuda.synchronize()
        d_s = time.time() - t0
    rel = abs(float(loss_k) - float(loss_d)) / abs(float(loss_d))
    print(f"path N: cfm_loss at {CFM_ROWS} x {CFM_T} frames, UNet {cfg.estimator.channels} "
          f"channels, {cfg.estimator.num_heads} heads of {cfg.estimator.attention_head_dim}, bf16: "
          f"with K3 {float(loss_k):.6f} ({k_s * 1e3:.1f} ms, first call), dense "
          f"{float(loss_d):.6f} ({d_s * 1e3:.1f} ms); rel {rel:.3e} ({rel / CFM_RTOL:.3f} of "
          f"2^-7)", flush=True)
    if not (math.isfinite(float(loss_k)) and rel <= CFM_RTOL):
        fail("path N: cfm_loss through K3 differs from the dense path")
    est = flow["estimator"]
    live = [x.detach().requires_grad_() for x in flatten(est).values()]
    try:
        cfm_loss({"estimator": _like(est, live)}, cfg, *bf, draws=draws)
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        print(f"path N: cfm_loss through K3 under autograd raises: {e}", flush=True)
    else:
        fail("path N: cfm_loss through K3 under autograd did not raise")
    est32 = {k: v.float() for k, v in flatten(est).items()}
    live = [v.detach().requires_grad_() for v in est32.values()]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    loss = cfm_loss({"estimator": _like(est, live)}, cfg, x1, mask, mu, spks, cond, draws=draws,
                    use_flash=False)
    grads = torch.autograd.grad(loss, live)
    torch.cuda.synchronize()
    if not all(bool(torch.isfinite(x).all()) for x in grads) or not any(
            float(x.abs().max()) > 0 for x in grads):
        fail("path N: cfm_loss's dense gradient is not finite or is all 0")
    print(f"path N: cfm_loss dense in fp32 under autograd: loss {float(loss.detach()):.6f}, "
          f"gradients of {len(grads)} UNet leaves finite in {time.time() - t0:.2f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    return counts


def train_path(card):
    """Path N: T3 training on the card at full width (``T3Config()``, fp32,
    ``weights.init_t3(seed=0)``, batches of N_BATCH rows: 34 cond + 128
    text + 512 speech positions), through ``train.trainer.T3Trainer``:
      1. the gradient of the first batch: every leaf the loss reaches is
         nonzero (``check_train_grads``);
      2. N_WARM + N_TIMED steps on that one batch: losses finite and
         falling; the timed steps by ``runtime.profiling.StageTimer`` (the
         median step, its update stage), tokens/s, the share of the fp32
         bound, peak memory; TF32 off, deterministic algorithms off;
      3. resume under ``torch.use_deterministic_algorithms(True)``: 2 steps,
         ``save``, 2 steps, against ``T3Trainer.resume`` of the file and 2
         steps: losses and every leaf bit for bit;
      4. a small T3 on the card against the CPU (``train_small_against_cpu``);
      5. ``cfm_loss`` at the full flow width (``cfm_phase``).
    The launch counters are set to 0 at the start and read after step 5's
    kernel call: K3 CFM_BLOCKS times, nothing else. Returns those counts."""
    import gc

    import numpy as np
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten
    from chatterbox_tpu_torch.models.t3.t3 import T3Config
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.runtime.profiling import StageTimer
    from chatterbox_tpu_torch.train.train_step import t3_loss_and_grads
    from chatterbox_tpu_torch.train.trainer import T3Trainer, _batch_to

    gc.collect()
    torch.cuda.empty_cache()
    print(f"path N: {torch.cuda.memory_allocated() / 2**30:.2f} GiB held from earlier paths",
          flush=True)
    reset_launch_counts()
    cfg = T3Config()
    t0 = time.time()
    trainer = T3Trainer(cfg, weights.init_t3(cfg, seed=0, device="cuda"), learning_rate=N_LR)
    n_params = sum(x.numel() for x in flatten(trainer.params).values())
    if n_params != N_PARAMS:
        fail(f"path N: T3Config() has {n_params} parameters, not {N_PARAMS}")
    batch = train_batch(0)
    s = cfg.n_cond + N_TEXT + N_SPEECH
    tokens = N_BATCH * s
    print(f"path N: T3Config() {n_params} fp32 parameters on the card in {time.time() - t0:.1f} "
          f"s; batch {N_BATCH} x {s} positions ({tokens} a step)", flush=True)

    # 1. the first gradient reaches every leaf
    check_train_grads(trainer.params, t3_loss_and_grads(
        trainer.params, cfg, _batch_to(batch, trainer.device))[3], batch)

    # 2. warm and timed steps on one batch
    torch.cuda.reset_peak_memory_stats()
    losses, timers = [], []
    for i in range(N_WARM + N_TIMED):
        timer = StageTimer()
        with timer.stage("step", block_on=trainer.device):
            losses.append(trainer.step(batch, timer=timer))
        timers.append(timer)
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    peak_r = torch.cuda.max_memory_reserved() / 2**30
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        fail(f"path N: a loss is not finite: {losses}")
    if not losses[-1]["loss"] < losses[0]["loss"]:
        fail(f"path N: the loss did not fall over {len(losses)} steps on one batch")
    timed = timers[N_WARM:]
    med = {k: float(np.median([t.totals[k] for t in timed])) * 1e3
           for k in ("step", "loss_and_grads", "update")}
    flops = train_step_flops(cfg, N_BATCH, N_TEXT, N_SPEECH)
    bound_ms = flops / PEAK_FP32_FLOPS * 1e3
    upd_bytes = 4 * n_params * 7  # read p, g, mu, nu; write p, mu, nu (fp32)
    upd_bound = upd_bytes / PEAK_BYTES * 1e3
    print(f"path N: losses over {len(losses)} steps on one batch: "
          + ", ".join(f"{m['loss']:.4f}" for m in losses), flush=True)
    print(f"path N: train step median of {N_TIMED}: {med['step']:.1f} ms (loss and gradients "
          f"{med['loss_and_grads']:.1f} ms, AdamW update {med['update']:.2f} ms, bound "
          f"{upd_bound:.2f} ms by bytes, {upd_bound / med['update']:.1%}); "
          f"{tokens / med['step'] * 1e3:.0f} tokens/s; {flops:.4e} operations, fp32 bound "
          f"{bound_ms:.1f} ms, {bound_ms / med['step']:.1%} of it; peak {peak_a:.2f} GiB "
          f"allocated, {peak_r:.2f} GiB reserved; TF32 off, deterministic algorithms off; "
          f"on {card}", flush=True)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # 3. bit-identical resume on the card
    batches = [train_batch(1 + i) for i in range(4)]
    torch.use_deterministic_algorithms(True)
    try:
        with tempfile.TemporaryDirectory(prefix=".smoke_train_", dir=HERE) as work:
            path = os.path.join(work, "train_state.safetensors")
            a = T3Trainer(cfg, weights.init_t3(cfg, seed=0, device="cuda"), learning_rate=N_LR)
            straight = [a.step(b) for b in batches[:2]]
            torch.cuda.synchronize()
            t0 = time.time()
            a.save(path)
            save_s = time.time() - t0
            straight += [a.step(b) for b in batches[2:]]
            t0 = time.time()
            r = T3Trainer.resume(path, cfg, weights.init_t3(cfg, seed=1, device="cuda"),
                                 learning_rate=N_LR)
            torch.cuda.synchronize()
            load_s = time.time() - t0
            size = os.path.getsize(path)
            resumed = [r.step(b) for b in batches[2:]]
        if r.step_num != a.step_num or resumed != straight[2:]:
            fail(f"path N: resumed losses {resumed} differ from {straight[2:]}")
        n_leaves = 0
        for x, y in ((a.params, r.params), (a.opt_state.mu, r.opt_state.mu),
                     (a.opt_state.nu, r.opt_state.nu)):
            for k, v in flatten(x).items():
                if not torch.equal(v, flatten(y)[k]):
                    fail(f"path N: after resume, {k} differs")
                n_leaves += 1
        if not torch.equal(a.opt_state.count, r.opt_state.count):
            fail("path N: after resume, the optimizer count differs")
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"path N: resume bit-identical under torch.use_deterministic_algorithms(True): 4 "
          f"losses and {n_leaves + 1} leaves; the file {size} bytes, save {save_s:.1f} s, "
          f"resume (load) {load_s:.1f} s", flush=True)
    del a, r
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the small model on the card against the CPU
    train_small_against_cpu()

    # 5. cfm_loss at the full flow width
    counts = cfm_phase(launch_counts)
    check_launches("N", counts, (_K3,), (_K1A, _K1B, _K1C, _K2, _K2B, _K4, _K5),
                   {_K3: CFM_BLOCKS})
    print("path N: kernel launches " + json.dumps(counts), flush=True)
    return counts



# ---------------------------------------------------------------------------
# path O: the mesh (data and tensor parallelism on the one card)
# ---------------------------------------------------------------------------

O2_WORLD = 2
O2_LAYERS = 4  # T3 at full width (16 heads of 64, 8 a rank), cut to 4 layers
O2_MAX_NEW = 50
O2_GAP = 1e-4  # a row may part from the single call only at a near-tie of its top two logits
O2_TIMEOUT_S = 300
# O4: leaves of the full-width synthetic model held against the CPU's
O4_LEAVES = (("t3", ("speech_head", "w")), ("s3gen", ("flow", "input_embedding", "w")),
             ("s3gen", ("hift", "conv_pre", "w")))


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def o2_inputs(dev):
    """Path O2's T3 (full width, ``O2_LAYERS`` layers, fp32 from seed 0)
    and its inputs: 8 texts of 64-token ids (SOT/EOT framed, 20-64 long)
    and path A's conditionals broadcast to them."""
    import numpy as np
    import torch

    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
    from chatterbox_tpu_torch.models.t3.t3 import T3Config

    cfg = T3Config(llama=LlamaConfig(num_hidden_layers=O2_LAYERS))
    params = weights.init_t3(cfg, 0, dev, torch.float32)
    rng = np.random.default_rng(11)
    lens = rng.integers(20, TEXT_BUCKET + 1, N_TEXTS).astype(np.int32)
    text = np.zeros((N_TEXTS, TEXT_BUCKET), np.int32)
    for i, n in enumerate(lens):
        text[i, 1:n - 1] = rng.integers(1, 700, n - 2)
        text[i, 0], text[i, n - 1] = cfg.start_text_token, cfg.stop_text_token
    c = random_conditionals(dev).t3
    inp = (torch.from_numpy(text).to(dev), torch.from_numpy(lens).to(dev),
           *(x.expand((N_TEXTS,) + x.shape[1:]) for x in c))
    return cfg, params, inp


def mesh_worker(rank, world, port, out_dir):
    """One of path O2's processes (``chip_smoke.py --mesh-worker``): T3's
    heads split over a (1, world) mesh over ``gloo`` on the one card,
    greedy, its tokens and launch counts written to ``out_dir``."""
    import torch

    from chatterbox_tpu_torch.core.sampling import SamplingConfig
    from chatterbox_tpu_torch.models.t3.t3 import t3_generate
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.parallel.multihost import init_multihost
    from chatterbox_tpu_torch.parallel.sharding import (local_t3_config, make_mesh,
                                                        shard_params, t3_param_specs)
    from chatterbox_tpu_torch.parallel.tensor_parallel import model_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo", timeout_s=O2_TIMEOUT_S)
    mesh = make_mesh((1, world))
    dev = torch.device("cuda")
    cfg, params, inp = o2_inputs(dev)
    local = shard_params(params, mesh, t3_param_specs(params))
    del params
    lcfg = local_t3_config(cfg, world)
    group = mesh.get_group("model")
    with torch.inference_mode(), model_parallel(group):
        t3_generate(local, lcfg, *inp, SamplingConfig(greedy=True), 4)  # K1's workspace, the build
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.time()
        res = t3_generate(local, lcfg, *inp, SamplingConfig(greedy=True), O2_MAX_NEW)
        torch.cuda.synchronize()
    torch.save({"tokens": res.tokens.cpu(), "counts": launch_counts(), "seconds": time.time() - t0,
                "heads": lcfg.llama.num_attention_heads},
               os.path.join(out_dir, f"o2_{rank}.pt"))
    torch.distributed.destroy_process_group()


def o2_logit_gap(params, cfg, inp, step, row):
    """The single call's top-two gap of row ``row``'s processed logits at
    decode step ``step`` (greedy takes the top one)."""
    from chatterbox_tpu_torch.core.sampling import SamplingConfig, cfg_combine, process_logits
    from chatterbox_tpu_torch.models.t3.t3 import t3_generate_resume, t3_generate_start

    sampling = SamplingConfig(greedy=True)
    carry = t3_generate_start(params, cfg, *inp, sampling, O2_MAX_NEW)
    carry, _ = t3_generate_resume(params, cfg, carry, inp[1], sampling, step)
    lg = carry.logits.float()
    b = lg.shape[0] // 2
    lg = process_logits(cfg_combine(lg[:b], lg[b:], sampling.cfg_weight), carry.seen, sampling)
    top = lg[row].topk(2).values
    return float(top[0] - top[1])


def mesh_path(card):
    """Path O, the mesh on the one card (the smoke machine has one; nothing
    past a world of one on separate cards is claimed):
      O1. a world of one over NCCL, ``make_mesh((1, 1))``, and
          ``with_mesh(mesh, model_sharded=True)`` on path A's model: path
          A's call, tokens and wavs equal to path A's bit for bit, K1a/K2/
          K3/K4 launched as on path A;
      O2. two processes on the card over ``gloo``, a (1, 2) mesh: T3 at full
          width (8 heads a rank), ``O2_LAYERS`` layers, fp32, TF32 off,
          greedy, 8 texts, ``O2_MAX_NEW`` tokens: the tokens equal the
          world-of-one call's (a differing row passes only at a near-tie,
          ``O2_GAP``), each process launching K1a, K2 and the decode
          step's glue kernels on its heads;
      O3. ``dryrun_multichip(1)`` on the card;
      O4. ``from_random(synthetic=True)`` at full width: the seconds, every
          leaf finite, the share of three leaves' elements equal to the
          CPU's; ``native_available()`` (a failed native build fails the
          run) and the tokenizer's backend.
    Returns the launch counts of O1's call and O2's two ranks, summed."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from chatterbox_tpu_torch import ChatterboxTTS, weights
    from chatterbox_tpu_torch.core.sampling import SamplingConfig
    from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
    from chatterbox_tpu_torch.models.t3.t3 import T3Config, t3_generate
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts
    from chatterbox_tpu_torch.parallel.dryrun import dryrun_multichip
    from chatterbox_tpu_torch.parallel.multihost import init_multihost
    from chatterbox_tpu_torch.parallel.sharding import make_mesh

    # O1
    t0 = time.time()
    init_multihost(f"127.0.0.1:{_free_port()}", 1, 0)
    print(f"path O1: a world of one over {dist.get_backend()}", flush=True)
    tts = ChatterboxTTS.from_random(
        seed=0, t3_cfg=T3Config(llama=LlamaConfig(num_hidden_layers=TTS_T3_LAYERS)))
    conds = random_conditionals(tts.device)
    kw, _, launched, not_launched = PATHS["A"]
    # cuDNN picks its algorithms call by call (deterministic_cudnn): path A's
    # call is made again on this model under deterministic cuDNN, then under
    # the mesh, and the two wavs held bit for bit; the tokens also against
    # path A's first call
    with deterministic_cudnn():
        wavs_a = tts.generate_batch(TEXTS, conds=conds, seed=0, **kw)
        tts.with_mesh(make_mesh((1, 1)), model_sharded=True)
        reset_launch_counts()
        wavs = tts.generate_batch(TEXTS, conds=conds, seed=0, **kw)
        torch.cuda.synchronize()
    counts = launch_counts()
    print("path O1: kernel launches " + json.dumps(counts), flush=True)
    check_wavs("O1", wavs, N_TEXTS)
    check_launches("O1", counts, launched + _GLUE, not_launched,
                   {_K1A: TTS_T3_LAYERS * (MAX_NEW - 1),
                    **glue_launches(TTS_T3_LAYERS, MAX_NEW - 1)})
    tokens_a, first_wavs = FIRST_CALLS["A"]
    same_tokens = all(np.array_equal(a, b) for a, b in zip(tts.last_speech_tokens, tokens_a))
    same_wavs = all(np.array_equal(a, b) for a, b in zip(wavs, wavs_a))
    drift = max(float(np.abs(a - b).max()) for a, b in zip(wavs, first_wavs))
    print(f"path O1: tokens equal to path A's: {same_tokens}; wavs bit for bit with path A's "
          f"call under deterministic cuDNN: {same_wavs} (max |diff| from path A's first call, "
          f"cuDNN free: {drift:.3e}) ({time.time() - t0:.1f} s)", flush=True)
    if not (same_tokens and same_wavs):
        fail("path O1: the world-of-one mesh changed path A's tokens or wavs")
    del tts
    torch.cuda.empty_cache()

    # O2: the workers start while this process makes the single call
    t0 = time.time()
    with tempfile.TemporaryDirectory(prefix=".smoke_mesh_", dir=HERE) as out_dir:
        port = _free_port()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-worker",
                                   str(r), str(O2_WORLD), str(port), out_dir])
                 for r in range(O2_WORLD)]
        try:
            cfg, params, inp = o2_inputs(torch.device("cuda"))
            with torch.inference_mode():
                single = t3_generate(params, cfg, *inp, SamplingConfig(greedy=True),
                                     O2_MAX_NEW).tokens.cpu()
            rcs = [p.wait(timeout=O2_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(rcs):
            fail(f"path O2: the mesh workers exited {rcs}")
        outs = [torch.load(os.path.join(out_dir, f"o2_{r}.pt")) for r in range(O2_WORLD)]
    for r, out in enumerate(outs):
        c = out["counts"]
        print(f"path O2: rank {r}: {out['heads']} heads, {O2_MAX_NEW} tokens in "
              f"{out['seconds']:.3f} s; launches " + json.dumps(c), flush=True)
        check_launches(f"O2 rank {r}", c, (_K1A, _K2) + _GLUE,
                       (_K1B, _K1C, _K2B, _K3, _K4, _K5),
                       {_K1A: O2_LAYERS * (O2_MAX_NEW - 1), _K2: O2_MAX_NEW - 1,
                        **glue_launches(O2_LAYERS, O2_MAX_NEW - 1)})
        if not torch.equal(out["tokens"], outs[0]["tokens"]):
            fail("path O2: the ranks' tokens differ")
    got = outs[0]["tokens"]
    for row in range(N_TEXTS):
        diff = (got[row] != single[row]).nonzero()
        if len(diff):
            step = int(diff[0])
            gap = o2_logit_gap(params, cfg, inp, step, row)
            print(f"path O2: row {row} parts from the single call at step {step}, where the "
                  f"single call's top-two logit gap is {gap:.3e}", flush=True)
            if gap >= O2_GAP:
                fail(f"path O2: row {row} differs at step {step} with a logit gap of {gap:.3e}")
    print(f"path O2: tokens of {O2_WORLD} x {outs[0]['heads']} heads equal to the world of "
          f"one's on "
          f"{int((got == single).all(dim=1).sum())} of {N_TEXTS} rows ({time.time() - t0:.1f} s)",
          flush=True)
    del params
    torch.cuda.empty_cache()
    counts = {k: counts[k] + sum(out["counts"][k] for out in outs) for k in counts}

    # O3
    t0 = time.time()
    line = dryrun_multichip(1)
    print(f"path O3: {line} ({time.time() - t0:.1f} s)", flush=True)

    # O4
    from chatterbox_tpu_torch.checkpoint.pytree_io import flatten
    from chatterbox_tpu_torch.models.tokenizer import EnTokenizer
    from chatterbox_tpu_torch.native import native_available
    from chatterbox_tpu_torch.pipeline.tts import random_s3gen
    from chatterbox_tpu_torch.runtime.fast_init import synthetic_leaf

    t0 = time.time()
    syn = ChatterboxTTS.from_random(seed=0, synthetic=True)
    torch.cuda.synchronize()
    secs = time.time() - t0
    trees = {"t3": syn.t3_params, "s3gen": syn.s3gen_params, "ve": syn.ve_params}
    bad, n_leaves = [], 0
    for name, tree in trees.items():
        for key, leaf in flatten(tree).items():
            n_leaves += 1
            if not bool(torch.isfinite(torch.as_tensor(leaf).float()).all()):
                bad.append(f"{name}/{key}")
    print(f"path O4: from_random(synthetic=True) at full width in {secs:.2f} s, {n_leaves} "
          f"leaves, non-finite: {bad or 'none'}", flush=True)
    if bad:
        fail(f"path O4: non-finite synthetic leaves {bad}")
    inits = {"t3": lambda d: weights.init_t3(T3Config(), 0, d),
             "s3gen": lambda d: random_s3gen(syn.s3gen_cfg, 0, d)}
    for name, path in O4_LEAVES:
        shapes = weights.jax_layout_meta(inits[name](torch.device("meta")))
        want = synthetic_leaf(shapes, path, device="cpu")
        got = _jax_leaf(trees[name], path)
        share = float((got.float().cpu() == want.to(got.dtype).float()).float().mean())
        print(f"path O4: {name}/{'/'.join(path)} {tuple(want.shape)} {got.dtype}: share of "
              f"elements equal to the CPU's synthetic_like {share:.6f}", flush=True)
    del syn, trees
    torch.cuda.empty_cache()
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_reference_format as rf

    with tempfile.TemporaryDirectory(prefix=".smoke_mesh_", dir=HERE) as d:
        tok_path = os.path.join(d, "tokenizer.json")
        with open(tok_path, "w") as f:
            json.dump(rf.tokenizer_spec(), f)
        backend = EnTokenizer(tok_path).backend
    print(f"path O4: native_available() {native_available()}; the tokenizer's backend "
          f"{backend}", flush=True)
    if not native_available() or backend != "native":
        fail("path O4: the native library did not build or load (g++ is on this machine)")
    dist.destroy_process_group()
    return counts


def _jax_leaf(tree, path):
    """One leaf of a port tree, in the JAX package's layout (its path
    decides the layout, so it is mapped inside a tree of that one path)."""
    from chatterbox_tpu_torch import weights

    leaf = tree
    for p in path:
        leaf = leaf[p]
    for p in reversed(path):
        leaf = {p: leaf}
    leaf = weights.jax_layout(leaf)
    for p in path:
        leaf = leaf[p]
    return leaf


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
        granite_kernel_checks(rows)
        glue_kernel_checks(rows)
        merge_tick_checks(rows, tick_kernel_checks())
        rows.update(probe_kernel_phase())
        t1 = time.time()
        probes, probe_counts = probe_phase(card)
        t2 = time.time()
        reference_phase()
        conditioning_reference(ref_path)
        t3 = time.time()
        counts, cap_checks = main_path(card, ref_path, audio_dir)
        t4r = time.time()
        counts["R"] = granite_path(card, random_conditionals(torch.device("cuda")))
        print(f"path R: {time.time() - t4r:.1f} s", flush=True)
        t4 = time.time()
        vc_counts = vc_path(card, ref_path, src_paths, src_lens)
        t5 = time.time()
        counts["M"], saved_t3 = reference_set_path(card, ref_path, src_paths,
                                                   os.path.join(audio_dir, "native"))
        t6 = time.time()
        voice_path(card, (os.path.join(audio_dir, "native"), saved_t3))
        del saved_t3
        t6q = time.time()
        print(f"path Q: {t6q - t6:.1f} s", flush=True)
        counts["N"] = train_path(card)
        t7 = time.time()
        counts["O"] = mesh_path(card)
        t8 = time.time()
    print(f"phases: start {t0 - t_start:.1f} s, kernels {t1 - t0:.1f} s, probes {t2 - t1:.1f} s, "
          f"reference {t3 - t2:.1f} s, TTS paths {t4 - t3:.1f} s, VC path {t5 - t4:.1f} s, "
          f"reference set (path M) {t6 - t5:.1f} s, voice (path Q) {t6q - t6:.1f} s, "
          f"training (path N) {t7 - t6q:.1f} s, "
          f"mesh (path O) {t8 - t7:.1f} s", flush=True)
    counts["E"] = {k: sum(c[k] for c in vc_counts.values()) for k in vc_counts["fused"]}
    counts["probes"] = probe_counts
    # path I's kernels at its batch: their errors count in the row's
    for key, (err, tol, share, n_rows) in cap_checks.items():
        r = rows[key]
        r["err"], r["share"] = max(r["err"], err), max(r["share"], share)
        r.setdefault("extra", {}).update({"cap_rows": n_rows, "max_abs_err_cap_rows": err,
                                          "err_share_of_tol_cap_rows": share})
    # each P2/P3 variant's launches in the probe phase
    variant_launches = {k: v["launches"] for k, v in probes["P2/P3"]["variants"].items()}

    # "max_abs_err"/"ms" and "max_err"/"kernel_ms" carry the same numbers
    # under the two sets of names that readers of this line expect;
    # "launches" sums the first calls of paths A-O (E: both layouts and the
    # pipelined call; N: cfm_loss's forward; O: O1's call and O2's two ranks)
    # and the probe phase; a probe's row counts its probe's launches in that
    # phase
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
        lib = "none" if r["library_ms"] is None else f"{r['library_ms']:.5f}"
        print(f"kernel {name}: {r['ms']:.5f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{bound_ms / r['ms']:.1%} of the bound; plain {r['plain_ms']:.5f} ms; library "
              f"{lib} ms", flush=True)
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-worker"]:
        mesh_worker(*(int(a) for a in sys.argv[2:5]), sys.argv[5])
    else:
        main()
