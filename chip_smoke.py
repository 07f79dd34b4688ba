"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line):
  1. device: requires CUDA and prints the card's name and power limit;
  2. build: compiles every kernel of ``chatterbox_tpu_torch/csrc`` with nvcc;
  3. kernels: runs K1-K4 at the full-width shapes of the main path, holds each
     against its plain PyTorch version on the same inputs (the limits are
     stated at ``OUT_RTOL``) and times the kernel, the plain version and, as
     a yardstick only, one PyTorch library call for the same function, each
     as device time from a replayed CUDA graph;
  4. reference: a small model with the main path's head width, through the
     port on the card against the port's plain versions on the CPU (see
     ``reference_phase`` for each comparison and its tolerance);
  5. main path: ``ChatterboxTTS.from_random(seed=0)`` at full width (T3 and
     flow in bf16, HiFT in fp32), seeded random conditionals, then
     ``generate_batch`` on 8 texts with ``max_new_tokens=250``; checks the
     wavs and that every kernel's launch counter rose during that call, then
     times a second, warm call (audio seconds per second, per stage) and
     profiles a third (device time by kernel, the device's busy share);
  6. prints the kernel table as one JSON line, the card line, and then
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
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

# H100 SXM published peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# K1, K3 and K4 against their plain versions in bf16 (8 significant bits),
# element by element:
#     |got - want| <= 2^-7 |want| + 2^-7 (P|v|) + 1e-5
# Both sides carry fp32 to the end and round the output once to bf16, which
# parts them by at most one bf16 ulp (<= 2^-7 |want|). K3 and K4 also round
# the softmax probabilities to bf16 before the value product, the kernel the
# unnormalised ones of its online softmax and the plain version the
# normalised ones: each rounding moves p_i by at most 2^-8 of itself, so the
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
PROMPT_TOKENS = 250  # flow prompt: 250 tokens / 500 mel frames
T3_LAYERS, T3_HEADS, HEAD_DIM = 30, 16, 64
N_COND, TEXT_BUCKET, N_BOS = 34, 64, 2
FLOW_HEADS, CONF_HEADS, CONF_C = 8, 8, 512

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
    """K1-K4 at the main path's full-width shapes: check, then time."""
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
    "kv_cache_append": (
        "chatterbox_tpu_torch/csrc/flash_decode.cu",
        "chatterbox_tpu/ops/flash_decode.py:299",
    ),
    "flash_self_attention_packed": (
        "chatterbox_tpu_torch/csrc/flash_attention.cu",
        "chatterbox_tpu/ops/flash_attention.py:126",
    ),
    "flash_relpos_attention": (
        "chatterbox_tpu_torch/csrc/flash_attention.cu",
        "chatterbox_tpu/ops/flash_attention.py:267",
    ),
}


def reference_phase():
    """A small model with the main path's head width (64), run through the
    port on the card and, as the reference, through the port's plain
    versions on the CPU in fp32, on the same weights and inputs:
      - T3 in fp32 (K1 and K2 take fp32): tokens and lengths must be equal,
        greedy and with injected uniforms;
      - the flow in bf16 on the card (K3, K4) against fp32 on the CPU, from
        the same bf16 weights and noise: relative L2 error of the mel within
        5e-2 (8-bit mantissas compounding through ~20 layers and 10 Euler
        steps);
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
    t3_cfg = T3Config(llama=LlamaConfig(hidden_size=256, intermediate_size=512,
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
    for greedy in (True, False):
        out = []
        for p, d in ((p_dev, dev), (p_cpu, cpu)):
            args = [torch.from_numpy(x).to(d) for x in (text, lens, *cond)]
            res = t3_generate(p, t3_cfg, *args, SamplingConfig(greedy=greedy), max_new,
                              uniforms=torch.from_numpy(uniforms).to(d))
            out.append((res.tokens.cpu(), res.lengths.cpu()))
        if not (torch.equal(out[0][0], out[1][0]) and torch.equal(out[0][1], out[1][1])):
            fail(f"reference: T3 tokens on the card differ from the CPU (greedy={greedy})")
    print("reference: T3 fp32 tokens equal to the CPU's, greedy and sampled", flush=True)

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
    mels = []
    for d, dt in ((dev, torch.bfloat16), (cpu, torch.float32)):
        p = weights.tree_to(flow_bf16, d, dt)
        mel, _ = flow_inference(p, flow_cfg, *(torch.from_numpy(x).to(d) for x in inputs))
        mels.append(mel.float().cpu())
    valid = [mels[1][i, : 2 * (n_prompt + int(inputs[1][i]))] for i in range(b)]
    got = [mels[0][i, : len(v)] for i, v in enumerate(valid)]
    rel = max(float((g - v).norm() / v.norm()) for g, v in zip(got, valid))
    print(f"reference: flow mel bf16 card vs fp32 CPU rel_l2_err={rel:.3e} tol=5.0e-02",
          flush=True)
    if not (np.isfinite(rel) and rel <= 5e-2):
        fail(f"reference: flow mel relative error {rel} exceeds 5e-2")

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
    print(f"profile: device busy {busy:.3f} s over {len(ns)} kernel names; profiled wall "
          f"{wall:.3f} s; busy share of the warm call {busy / warm_wall:.4f}", flush=True)
    for name, t in ns.most_common(20):
        print(f"profile: {t / 1e6:10.3f} ms {count[name]:8d} x  {name[:100]}", flush=True)


def main_path(card):
    import torch

    from chatterbox_tpu_torch import ChatterboxTTS
    from chatterbox_tpu_torch.ops import launch_counts, reset_launch_counts

    t0 = time.time()
    tts = ChatterboxTTS.from_random(seed=0)
    conds = random_conditionals(tts.device)
    torch.cuda.synchronize()
    print(f"main path: from_random at full width in {time.time() - t0:.1f} s", flush=True)

    reset_launch_counts()
    t0 = time.time()
    wavs = tts.generate_batch(TEXTS, conds=conds, max_new_tokens=MAX_NEW, seed=0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = launch_counts()

    if len(wavs) != N_TEXTS:
        fail(f"generate_batch returned {len(wavs)} wavs for {N_TEXTS} texts")
    for i, w in enumerate(wavs):
        if w.ndim != 1 or len(w) == 0 or len(w) % 960 != 0:
            fail(f"wav {i}: bad shape {w.shape} (length must be a positive multiple of 960)")
        if not bool(torch.isfinite(torch.as_tensor(w)).all()):
            fail(f"wav {i}: non-finite samples")
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(f"main path: first call {wall:.3f} s for {audio_s:.3f} s of audio "
          f"(stages {json.dumps(tts.last_timings)})", flush=True)

    # a second, warm call on the same inputs: the throughput of the port
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    wavs = tts.generate_batch(TEXTS, conds=conds, max_new_tokens=MAX_NEW, seed=0)
    torch.cuda.synchronize()
    wall = time.time() - t0
    audio_s = sum(len(w) for w in wavs) / tts.sr
    print(
        f"main path: {N_TEXTS} texts, max_new_tokens={MAX_NEW}: warm wall {wall:.3f} s, "
        f"audio {audio_s:.3f} s, audio_sec_per_s_per_chip_b8 {audio_s / wall:.4f}, "
        f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB on {card}",
        flush=True,
    )
    print("main path: warm stages " + json.dumps(tts.last_timings), flush=True)
    profile_call(lambda: tts.generate_batch(TEXTS, conds=conds, max_new_tokens=MAX_NEW, seed=0),
                 wall)
    print("main path: kernel launches " + json.dumps(counts), flush=True)
    return counts


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
    t0 = time.time()
    rows = kernel_phase()
    t1 = time.time()
    reference_phase()
    t2 = time.time()
    counts = main_path(card)
    t3 = time.time()
    print(f"phases: start {t0 - t_start:.1f} s, kernels {t1 - t0:.1f} s, reference "
          f"{t2 - t1:.1f} s, main path {t3 - t2:.1f} s", flush=True)

    # "max_abs_err"/"ms" and "max_err"/"kernel_ms" carry the same numbers
    # under the two sets of names that readers of this line expect
    table = []
    for name, r in rows.items():
        src, replaces = KERNEL_INFO[name]
        bound_ms, bound_by = r["bound"]
        table.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[name], "max_abs_err": r["err"], "max_err": r["err"],
            "tol": r["tol"], "err_share_of_tol": r["share"], "ms": r["ms"],
            "kernel_ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": r["library_ms"],
            "library_max_abs_err": r["library_err"],
        })
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
