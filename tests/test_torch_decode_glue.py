"""The Llama decode step's glue kernels (``ops/decode_glue.py``,
``csrc/decode_glue.cu``): on the CPU, each plain version against the eager
chain it replaced, and ``llama_decode_step`` against that chain's step, bit
for bit; on the card, each kernel against its plain version, the fused step
in every variant of the loop, and a full-width step's launches.

This file imports neither JAX nor the JAX package, so its card tests run on
the machine with the card, without the repo's conftest:

    python -m pytest tests/test_torch_decode_glue.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.core.layers import rms_norm, split_heads
from chatterbox_tpu_torch.core.sampling import SamplingConfig
from chatterbox_tpu_torch.models.t3 import llama as tl
from chatterbox_tpu_torch.models.t3 import t3 as tt
from chatterbox_tpu_torch.ops import decode_glue as dg
from chatterbox_tpu_torch.ops import flash_decode as fd
from chatterbox_tpu_torch.runtime import profiling

# (rows, hidden, query heads, KV heads, FFN): T3's at cell A's 128 CFG rows,
# and a tiny one with grouped K/V
WIDTHS = {"t3": (128, 1024, 16, 16, 4096), "tiny": (3, 128, 2, 1, 64)}
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32}
EPS = 1e-5
D = 64


def _randn(*shape, seed, dtype=torch.float32, device="cpu", scale=1.0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))
    return x.to(device=device, dtype=dtype).contiguous()


# ---------------------------------------------------------------------------
# the CPU: each plain version is the eager chain it replaced
# ---------------------------------------------------------------------------


def _norm_inputs(width, dtype, case, device="cpu", seed=0):
    """(x, r or None, scale): ``layer0`` has no residual to add, ``final``
    is the final norm after the last ``down`` product, ``residual`` a
    layer's norm after its ``o`` or ``down`` product."""
    b, c = WIDTHS[width][:2]
    x = _randn(b, 1, c, seed=seed, dtype=dtype, device=device, scale=4.0)
    r = None if case == "layer0" else _randn(b, 1, c, seed=seed + 1, dtype=dtype, device=device)
    scale = _randn(c, seed=seed + 2 + (case == "final"), dtype=dtype, device=device) + 1
    return x, r, scale


@pytest.mark.parametrize("case", ["layer0", "residual", "final"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_add_rms_norm_plain_is_the_eager_chain(dtype, width, case):
    x, r, scale = _norm_inputs(width, DTYPES[dtype], case)
    h = x if r is None else x + r
    h32 = h.float()
    var = torch.mean(h32 * h32, dim=-1, keepdim=True)
    want = (h32 * torch.rsqrt(var + EPS)).to(h.dtype) * scale
    for fn in (dg.add_rms_norm_plain, dg.add_rms_norm):
        got_h, got_y = fn(x, r, scale, EPS)
        assert torch.equal(got_h, h) and torch.equal(got_y, want)
        assert torch.equal(got_y, rms_norm({"scale": scale}, h, EPS))


def _qkv_inputs(width, dtype, layout, device="cpu", seed=10):
    """q, k, v rows (B, 1, H * D): views of one fused product, or three."""
    b, _, hq, hkv, _ = WIDTHS[width]
    widths = [hq * D, hkv * D, hkv * D]
    if layout == "fused":
        qkv = _randn(b, 1, sum(widths), seed=seed, dtype=dtype, device=device, scale=3.0)
        q, k, v = qkv.split(widths, dim=-1)
    else:
        q, k, v = (_randn(b, 1, w, seed=seed + i, dtype=dtype, device=device, scale=3.0)
                   for i, w in enumerate(widths))
    pos = torch.arange(b, device=device)[:, None] * 37 + 5
    cos, sin = tl.rope_cos_sin(tl.LlamaConfig(head_dim=D), pos)
    new_kv = torch.full((3, 2, b, hkv, D), 7.0, dtype=dtype, device=device)
    return q, k, v, cos, sin, new_kv


@pytest.mark.parametrize("layout", ["fused", "separate"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_split_kv_plain_is_the_eager_chain(dtype, width, layout):
    """apply_rope on the split heads, q made contiguous, and the new K/V
    written into layer 1's slices of the step's (L, 2, B, Hkv, D); the
    other layers' slices untouched."""
    q, k, v, cos, sin, new_kv = _qkv_inputs(width, DTYPES[dtype], layout)
    hq, hkv = WIDTHS[width][2:4]
    qh, kh = tl.apply_rope(split_heads(q, hq), split_heads(k, hkv), cos, sin)
    want_kv = new_kv.clone()
    want_kv[1, 0] = kh[:, :, 0]
    want_kv[1, 1] = split_heads(v, hkv)[:, :, 0]
    for fn in (dg.rope_split_kv_plain, dg.rope_split_kv):
        got_kv = new_kv.clone()
        q1 = fn(q, k, v, cos, sin, got_kv, 1)
        assert q1.is_contiguous() and torch.equal(q1, qh[:, :, 0])
        assert torch.equal(got_kv, want_kv)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_silu_mul_plain_is_the_mlp_activation(dtype, width):
    """The gated MLP's activation of ``_mlp`` (dense and int8 weights)."""
    b, c, _, _, f = WIDTHS[width]
    dt = DTYPES[dtype]
    y = _randn(b, 1, c, seed=20, dtype=dt)
    lp = {"gate_up": {"w": _randn(2 * f, c, seed=21, dtype=dt, scale=0.1)}}
    for p in (lp, tl.quantize_llama_weights({"layers": lp})["layers"]):
        want = tl._mlp(p, y)
        for fn in (dg.silu_mul_plain, dg.silu_mul):
            assert torch.equal(fn(tl._wmat(y, p["gate_up"])), want)


TINY = tl.LlamaConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=3,
                      num_attention_heads=2, num_key_value_heads=2, head_dim=64)


def _eager_chain_step(params, cfg, x, cache, write_pos, positions, row_prefix, gap_end,
                      align_layer=None, text_slice=None):
    """``llama_decode_step`` as it was before its glue was fused: every
    operation of the layer eager."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    b = x.shape[0]
    quant = isinstance(cache, tl.QuantCache)
    cos, sin = tl.rope_cos_sin(cfg, positions)
    kv_dtype = cache.tail.dtype if quant else cache.dtype
    new_kv = torch.empty((cfg.num_hidden_layers, 2, b, cfg.num_key_value_heads, d),
                         dtype=kv_dtype, device=x.device)
    attn = None
    for i, lp in enumerate(tl.unstack_layers(params)):
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q, k, v = tl._qkv(lp, y, cfg)
        q, k = tl.apply_rope(q, k, cos, sin)
        q1, k1, v1 = (t[:, :, 0].contiguous() for t in (q, k, v))
        if quant:
            a = fd.flash_decode_layer_attention_int8(
                cache.values, cache.scales, cache.tail, None, i, write_pos, row_prefix,
                gap_end, q1, k1, v1)
        elif i == align_layer:
            a, m, l = fd.flash_decode_layer_attention_stats(
                cache, i, write_pos, row_prefix, gap_end, q1, k1, v1)
            attn = tl._text_probs(cache, i, q1, m, l, text_slice, row_prefix)
        else:
            a = fd.flash_decode_layer_attention(cache, i, write_pos, row_prefix, gap_end,
                                                q1, k1, v1)
        x = x + tl._wmat(a.reshape(b, 1, h * d), lp["o"])
        y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        x = x + tl._wmat(tl._mlp(lp, y), lp["down"])
        new_kv[i, 0] = k1
        new_kv[i, 1] = v1
    tl.kv_cache_write(cache, new_kv, write_pos)
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps), attn


def _clone(cache):
    if isinstance(cache, tl.QuantCache):
        return tl.QuantCache(*(t.clone() for t in cache))
    return cache.clone()


def _equal(a, b):
    if isinstance(a, tl.QuantCache):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


VARIANTS = ("bf16-cache", "int8-cache", "alignment", "int8-weights", "separate-qkv")


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_step_on_the_cpu_is_the_eager_chain(dtype, variant):
    """Three decode steps after a prefill: hidden, the text attention and
    the cache equal the eager chain's bit for bit, and no layer counts as
    fused off the card."""
    dt = DTYPES[dtype]
    params = weights.init_t3(tt.T3Config(llama=TINY), 4, "cpu", dt)["llama"]
    params["final_ln"]["scale"] = _randn(TINY.hidden_size, seed=5, dtype=dt) + 1
    if variant != "separate-qkv":
        params = tl.fuse_qkv_params(params)
    if variant == "int8-weights":
        params = tl.quantize_llama_weights(params)
    b, t0, s = 3, 13, 32
    x0 = _randn(b, t0, TINY.hidden_size, seed=6, dtype=dt)
    valid = torch.ones((b, t0), dtype=torch.bool)
    valid[1, 9:] = False
    pos = torch.arange(t0)[None].repeat(b, 1)
    _, cache = tl.llama_prefill(params, TINY, x0, pos, valid, s,
                                cache_quant=variant == "int8-cache")
    row_prefix = torch.tensor([t0, 9, t0], dtype=torch.int32)
    align = dict(align_layer=1, text_slice=(2, 11)) if variant == "alignment" else {}
    want_cache, got_cache = _clone(cache), _clone(cache)
    profiling.enable()
    try:
        profiling.take()
        for step in range(3):
            x = _randn(b, 1, TINY.hidden_size, seed=7 + step, dtype=dt)
            positions = row_prefix.long()[:, None] + step
            args = (x, t0 + step, positions, row_prefix, t0)
            want = _eager_chain_step(params, TINY, args[0], want_cache, *args[1:], **align)
            got = tl.llama_decode_step(params, TINY, args[0].clone(), got_cache, *args[1:],
                                       **align)
            assert torch.equal(got[0], want[0]) and _equal(got_cache, want_cache)
            assert (got[1] is None) == (want[1] is None)
            if want[1] is not None:
                assert torch.equal(got[1], want[1])
    finally:
        profiling.disable()
    assert "t3.glue_fused_layers" not in profiling.take().counts


# ---------------------------------------------------------------------------
# the card: each kernel against its plain version, the fused step
# ---------------------------------------------------------------------------

# the norm's limit, {dtype: (rtol, atol)}: in bf16 one ulp of the output
# (2^-7 |want|), which both sides round from fp32, and 1e-5 for rsqrt's
# argument, an fp32 sum in another order; in fp32 a few ulps of that sum and
# of rsqrt (2^-18 |want|, 32 ulps of 2^-23)
NORM_TOL = {"bf16": (2.0 ** -7, 1e-5), "fp32": (2.0 ** -18, 1e-7)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["layer0", "residual", "final"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_add_rms_norm_matches_plain(cuda, dtype, width, case):
    """The residual add exact, written over r (x untouched); the norm
    within its limit, the elements that differ counted."""
    x, r, scale = _norm_inputs(width, DTYPES[dtype], case, device=cuda, seed=30)
    x0 = x.clone()
    want_h, want_y = dg.add_rms_norm_plain(x, r, scale, EPS)
    want_h = want_h.clone()
    before = dg.add_rms_norm.launches
    got_h, got_y = dg.add_rms_norm(x, r, scale, EPS)
    torch.cuda.synchronize()
    assert dg.add_rms_norm.launches == before + 1
    assert torch.equal(x, x0) and torch.equal(got_h, want_h)
    assert got_h is (x if r is None else r)
    rtol, atol = NORM_TOL[dtype]
    diff = (got_y.float() - want_y.float()).abs()
    share = float((diff / (rtol * want_y.float().abs() + atol)).max())
    n_diff = int((diff > 0).sum())
    print(f"add_rms_norm {dtype} {width} {case}: {n_diff} of {diff.numel()} elements differ, "
          f"the worst at {share:.3f} of its limit")
    assert share <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["fused", "separate"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_rope_split_kv_matches_plain(cuda, dtype, width, layout):
    q, k, v, cos, sin, new_kv = _qkv_inputs(width, DTYPES[dtype], layout, device=cuda, seed=40)
    want_kv = new_kv.clone()
    want_q = dg.rope_split_kv_plain(q, k, v, cos, sin, want_kv, 2)
    before = dg.rope_split_kv.launches
    got_q = dg.rope_split_kv(q, k, v, cos, sin, new_kv, 2)
    torch.cuda.synchronize()
    assert dg.rope_split_kv.launches == before + 1
    assert torch.equal(got_q, want_q) and torch.equal(new_kv, want_kv)


@pytest.mark.cuda
@pytest.mark.parametrize("scale", [1.0, 30.0])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_silu_mul_matches_plain(cuda, dtype, width, scale):
    """Exact, also where exp(-g) overflows (g far below 0)."""
    b, _, _, _, f = WIDTHS[width]
    gu = _randn(b, 1, 2 * f, seed=50, dtype=DTYPES[dtype], device=cuda, scale=scale)
    before = dg.silu_mul.launches
    got = dg.silu_mul(gu)
    torch.cuda.synchronize()
    assert dg.silu_mul.launches == before + 1
    assert torch.equal(got, dg.silu_mul_plain(gu))


@pytest.mark.cuda
def test_glue_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x, r, scale = _norm_inputs("tiny", torch.float16, "residual", device=cuda)
    with pytest.raises(ValueError):
        dg.add_rms_norm(x, r, scale, EPS)  # fp16
    x, r, scale = _norm_inputs("tiny", torch.bfloat16, "residual", device=cuda)
    with pytest.raises(ValueError):
        dg.add_rms_norm(x, r, scale.float(), EPS)  # dtypes mixed
    with pytest.raises(ValueError):
        dg.add_rms_norm(x, r, scale[:-8], EPS)
    q, k, v, cos, sin, new_kv = _qkv_inputs("tiny", torch.bfloat16, "separate", device=cuda)
    with pytest.raises(ValueError):
        dg.rope_split_kv(q, k, v, cos, sin, new_kv, 3)  # past the last layer
    with pytest.raises(ValueError):
        dg.rope_split_kv(q, k, v, cos.to(torch.bfloat16), sin, new_kv, 0)
    with pytest.raises(ValueError):
        dg.rope_split_kv(q, k, v, cos, sin, new_kv.float(), 0)  # new_kv not q's dtype
    with pytest.raises(ValueError):
        dg.silu_mul(_randn(3, 1, 2 * 68, seed=1, dtype=torch.bfloat16, device=cuda))
    with pytest.raises(ValueError):
        dg.silu_mul(_randn(3, 1, 2 * 64, seed=1, dtype=torch.float16, device=cuda))


GLUE = ("add_rms_norm", "rope_split_kv", "silu_mul")


def _glue_launches():
    return {n: getattr(dg, n).launches for n in GLUE}


# the fused step's hidden output against the eager chain's, as a share of
# the latter's largest magnitude: in bf16, norms' flipped roundings carried
# through the layers (a few ulps of the hidden state's scale); in fp32 a few
# ulps of fp32 carried likewise
STEP_TOL = {"bf16": 0.05, "fp32": 1e-4}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_every_step_variant_runs_through_the_kernels(cuda, dtype, variant):
    """On the card, in bf16 and in fp32, each variant's step launches each
    kernel as often as it has layers (the norm twice a layer and once at
    the end) and counts its layers as fused; its hidden output stays within
    the noise of the eager chain's."""
    dt = DTYPES[dtype]
    params = weights.init_t3(tt.T3Config(llama=TINY), 4, cuda, dt)["llama"]
    if variant != "separate-qkv":
        params = tl.fuse_qkv_params(params)
    if variant == "int8-weights":
        params = tl.quantize_llama_weights(params)
    b, t0, s = 3, 13, 32
    x0 = _randn(b, t0, TINY.hidden_size, seed=6, dtype=dt, device=cuda)
    pos = torch.arange(t0, device=cuda)[None].repeat(b, 1)
    _, cache = tl.llama_prefill(params, TINY, x0, pos, None, s,
                                cache_quant=variant == "int8-cache")
    row_prefix = torch.full((b,), t0, dtype=torch.int32, device=cuda)
    align = dict(align_layer=1, text_slice=(2, 11)) if variant == "alignment" else {}
    x = _randn(b, 1, TINY.hidden_size, seed=7, dtype=dt, device=cuda)
    args = (t0, row_prefix.long()[:, None], row_prefix, t0)
    want, _ = _eager_chain_step(params, TINY, x, _clone(cache), *args, **align)
    before = _glue_launches()
    profiling.enable()
    try:
        profiling.take()
        got, attn = tl.llama_decode_step(params, TINY, x, cache, *args, **align)
    finally:
        profiling.disable()
    torch.cuda.synchronize()
    n = TINY.num_hidden_layers
    launched = {k: v - before[k] for k, v in _glue_launches().items()}
    assert launched == {"add_rms_norm": 2 * n + 1, "rope_split_kv": n, "silu_mul": n}
    assert profiling.take().counts.get("t3.glue_fused_layers") == n
    assert (attn is not None) == (variant == "alignment")
    err = float((got.float() - want.float()).abs().max())
    assert err <= STEP_TOL[dtype] * float(want.float().abs().max()), err


@pytest.mark.cuda
def test_full_width_step_launches_at_most_12_a_layer(cuda):
    """T3 at its published widths (30 layers, bf16, fused q/k/v) on 4 texts
    with CFG: the replayed steps launch at most 12 device operations a
    layer (the 9 of a layer, the embedding, head, sampling and K2 over 30),
    and each capture counts 30 fused layers."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg = tt.T3Config()
    p = weights.init_t3(cfg, 0, cuda, torch.bfloat16)
    p["llama"] = tl.fuse_qkv_params(p["llama"])
    rng = np.random.default_rng(3)
    b, tmax, n = 4, 24, cfg.llama.num_hidden_layers
    text = torch.from_numpy(rng.integers(1, 700, (b, tmax)).astype(np.int32)).to(cuda)
    text[:, 0], text[:, -1] = cfg.start_text_token, cfg.stop_text_token
    lens = torch.full((b,), tmax, dtype=torch.int32, device=cuda)
    ins = (text, lens, torch.from_numpy(rng.standard_normal((b, 256)).astype(np.float32)).to(cuda),
           torch.from_numpy(rng.integers(0, 6561, (b, 150)).astype(np.int32)).to(cuda),
           torch.full((b,), 0.5, device=cuda))
    sampling = SamplingConfig(cfg_weight=0.5)
    profiling.enable()
    try:
        profiling.take()
        cy = tt.t3_generate_start(p, cfg, *ins, sampling, 40,
                                  generator=torch.Generator(cuda).manual_seed(1))
        cy, _ = tt.t3_generate_resume(p, cfg, cy, lens, sampling, 4)  # eager, then captured
    finally:
        profiling.disable()
    forwards = [s for s in profiling.take().spans if s.name == "t3.forward"]
    assert forwards and all(s.counts.get("t3.glue_fused_layers") == n for s in forwards)
    torch.cuda.synchronize()
    steps = 16
    i0 = cy.i
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cy, _ = tt.t3_generate_resume(p, cfg, cy, lens, sampling, steps)
        torch.cuda.synchronize()
    assert cy.i - i0 == steps
    ops = [e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA]
    per_step = len(ops) / steps
    print(f"T3 at {n} layers: {per_step:.1f} device operations a replayed step "
          f"({per_step / n:.2f} a layer)")
    assert 0 < per_step <= 12 * n
