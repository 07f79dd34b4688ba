"""P1: T3's decode step split into four 30-layer chains, slope-timed eager and
as a replayed CUDA graph (the port of ``scripts/probe_boundary.py``).

    python -m chatterbox_tpu_torch.probes.boundary [--wquant] [--layers N] [--device cpu]

The chains, on the port's own modules at full width (``LlamaConfig()``,
rows = 16 CFG rows, a cache of S = 384 slots with cur = 256 live):

  matmuls  the layer's products and glue (norm, fused qkv, rope, o, MLP);
           the attention output is replaced by v_new
  noop     the same, with P1's ``noop_copy`` of q in the attention slot
  kernel   the decode-attention kernel K1a alone, 30 chained calls
  full     the whole layer, K1a in the attention slot

Each repetition adds a runtime epsilon to the carried value, as the probe
does. The slope between K = 20 and K = 60 repetitions gives the time of one
chain: eager (how the port decodes today: the host issues every launch) and
replayed from a CUDA graph of the K repetitions (the analogue of the probe's
single ``jit``: no host work between launches). ``noop - matmuls`` is what
30 extra launches cost, ``full - matmuls - kernel`` what interleaving the
attention with the weight stream costs, and ``eager - graph`` of ``full``
the host's launch cost per step. ``--wquant`` runs the int8 weights of
``quantize_llama_weights``. The weights are the port's seeded T3 init in
bf16 with q/k/v fused; K1a reads a (L, 2, rows, H, S, D) cache whose valid
slots are [0, 64) and [66, cur).
"""

import time
from dataclasses import dataclass, replace

import torch

from ..core.layers import rms_norm
from ..models.t3.llama import (LlamaConfig, _mlp, _qkv, _wmat, apply_rope, fuse_qkv_params,
                               quantize_llama_weights, rope_cos_sin, unstack_layers)
from ..ops.flash_decode import device_position, flash_decode_layer_attention
from ..ops.probes import noop_copy
from . import device_name, main

MODES = ("matmuls", "noop", "kernel", "full")
ROW_PREFIX, GAP_END = 64, 66


@dataclass
class Setup:
    cfg: LlamaConfig
    layers: list  # per-layer parameter dicts
    cache: torch.Tensor  # (L, 2, rows, H, S, D)
    row_prefix: torch.Tensor  # (rows,) int32
    gap_end: int
    cur: torch.Tensor  # (1,) int32 on the device: the live length K1 reads
    cos: torch.Tensor
    sin: torch.Tensor
    x0: torch.Tensor  # (rows, 1, C)
    q0: torch.Tensor  # (rows, H, D)
    eps: torch.Tensor  # fp32 scalar on the device


def llama_weights(cfg: LlamaConfig, wquant: bool, device, dtype=torch.bfloat16, seed=0):
    """The port's seeded T3 Llama init in ``dtype``, q/k/v fused, int8 when
    ``wquant``."""
    from ..models.t3.t3 import T3Config
    from ..weights import init_t3

    params = fuse_qkv_params(init_t3(T3Config(llama=cfg), seed, device, dtype)["llama"])
    return quantize_llama_weights(params) if wquant else params


def make_setup(params, cfg: LlamaConfig, rows=16, s=384, cur=256, device="cuda",
               dtype=torch.bfloat16, seed=0) -> Setup:
    """The probe's inputs around ``params`` (a Llama tree): a random cache,
    x0 and q0 scaled by 0.05 from a seeded generator on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    h, d, n_l = cfg.num_attention_heads, cfg.head_dim, cfg.num_hidden_layers

    def randn(*shape):
        return (torch.randn(shape, generator=g, device=device) * 0.05).to(dtype)

    positions = torch.full((rows, 1), cur, dtype=torch.long, device=device)
    cos, sin = rope_cos_sin(cfg, positions)
    return Setup(cfg, unstack_layers(params),
                 randn(n_l, 2, rows, h, s, d),
                 torch.full((rows,), ROW_PREFIX, dtype=torch.int32, device=device), GAP_END,
                 device_position(cur, torch.device(device)), cos, sin,
                 randn(rows, 1, cfg.hidden_size), randn(rows, h, d),
                 torch.tensor(1e-6, dtype=torch.float32, device=device))


def layer_body(st: Setup, lp, x, lid: int, mode: str):
    """One layer of the ``matmuls``, ``noop`` or ``full`` chain
    (probe_boundary.py:124-145)."""
    cfg = st.cfg
    rows, h, d = x.shape[0], cfg.num_attention_heads, cfg.head_dim
    y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
    q, k, v = _qkv(lp, y, cfg)
    q, k = apply_rope(q, k, st.cos, st.sin)
    if mode == "full":
        q1, k1, v1 = (a[:, :, 0].contiguous() for a in (q, k, v))
        a = flash_decode_layer_attention(st.cache, lid, st.cur, st.row_prefix, st.gap_end,
                                         q1, k1, v1).reshape(rows, 1, h * d)
    elif mode == "noop":
        a = noop_copy(q[:, :, 0].contiguous()).reshape(rows, 1, h * d)
    else:  # matmuls
        a = v.transpose(1, 2).reshape(rows, 1, h * d)
    x = x + _wmat(a, lp["o"])
    y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
    return x + _wmat(_mlp(lp, y), lp["down"])


def chain(st: Setup, mode: str, k: int):
    """``k`` repetitions of the mode's 30-layer chain; returns the carried
    value (q for ``kernel``, else the hidden state)."""
    kernel = mode == "kernel"
    c = st.q0 if kernel else st.x0
    for i in range(k):
        c = c + (st.eps * (i + 1) * 1e-30).to(c.dtype)
        for lid, lp in enumerate(st.layers):
            if kernel:
                c = flash_decode_layer_attention(st.cache, lid, st.cur, st.row_prefix, st.gap_end,
                                                 c, c, c)
            else:
                c = layer_body(st, lp, c, lid, mode)
    return c


def _time(fn, iters):
    """Best milliseconds of ``fn()`` between CUDA events over ``iters``."""
    best = float("inf")
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def chain_ms(st: Setup, mode: str, k1: int, k2: int, iters: int, graph: bool) -> float:
    """Milliseconds of one chain: the slope of the best time of k1 and k2
    repetitions over ``iters`` runs (a replay is cheap: 3 ``iters`` of it),
    issued eagerly or replayed from a CUDA graph of them."""
    times = {}
    for k in (k1, k2):
        if graph:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):  # allocations and handles outside the capture
                chain(st, mode, 1)
            torch.cuda.current_stream().wait_stream(side)
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                chain(st, mode, k)
            times[k] = _time(g.replay, 3 * iters)
            del g
        else:
            times[k] = _time(lambda: chain(st, mode, k), iters)
    return (times[k2] - times[k1]) / (k2 - k1)


def kernels_per_chain(st: Setup, mode: str) -> int:
    """Kernels one chain launches, counted by torch.profiler's CUDA activity
    (copies and memsets not counted)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        chain(st, mode, 1)
        torch.cuda.synchronize()
    return sum(1 for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and not e.name().startswith(("Memcpy", "Memset")))


def _split(ms):
    out = {"chain_ms": ms}
    out["boundary_ms_30calls"] = ms["noop"] - ms["matmuls"]
    out["interleave_extra_ms"] = ms["full"] - ms["matmuls"] - ms["kernel"]
    return out


@torch.inference_mode()
def run(device, wquant: bool = False, rows: int = 16, s: int = 384, cur: int = 256,
        k1: int = 20, k2: int = 60, iters: int = 3, layers: int = 30):
    """The four chains of ``layers`` layers at full width, eager and as a
    CUDA graph (CUDA only; on the CPU each chain runs once and nothing is
    timed). Returns the results: ms per chain and mode, the boundary and
    interleave terms, the kernels per chain, and the split of a decode step
    (``full``) into the host's launch cost, the weight stream with its glue,
    and the attention kernel."""
    cfg = replace(LlamaConfig(), num_hidden_layers=layers)
    t0 = time.time()
    st = make_setup(llama_weights(cfg, wquant, device), cfg, rows, s, cur, device)
    out = {"probe": "P1 decode-step boundary", "device": device_name(device), "rows": rows,
           "s": s, "cur": cur, "wquant": wquant, "layers": layers}
    if device.type != "cuda":
        for mode in MODES:
            if not bool(torch.isfinite(chain(st, mode, 1).float()).all()):
                raise AssertionError(f"P1 {mode}: the chain gave non-finite values")
        return out
    for mode in MODES:  # a first call of each (builds the kernels)
        chain(st, mode, 1)
    eager = {m: chain_ms(st, m, k1, k2, iters, graph=False) for m in MODES}
    graph = {m: chain_ms(st, m, k1, k2, iters, graph=True) for m in MODES}
    out["eager"], out["graph"] = _split(eager), _split(graph)
    out["kernels_per_chain"] = {m: kernels_per_chain(st, m) for m in MODES}
    out["step_split_ms"] = {"launch": eager["full"] - graph["full"],
                            "weights_and_glue": graph["matmuls"],
                            "attention": graph["kernel"],
                            "interleave": graph["full"] - graph["matmuls"] - graph["kernel"]}
    out["seconds"] = time.time() - t0
    return out


def _options(ap):
    ap.add_argument("--wquant", action="store_true", help="int8 weights")
    ap.add_argument("--layers", type=int, default=30, help="depth (the width stays full)")


if __name__ == "__main__":
    main(run, __doc__.splitlines()[0], _options)
