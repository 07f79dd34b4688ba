"""T3's decode step as CUDA graphs (``models/t3/t3.py``: ``_StepGraphs``):
the positions the kernels read from device memory, on the CPU through their
plain versions, and on the card the graphed loop against the eager one, bit
for bit.

This file imports neither JAX nor the JAX package, so its card tests run on
the machine with the card, without the repo's conftest:

    python -m pytest tests/test_torch_t3_graph.py -q --noconftest -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.core.sampling import SamplingConfig
from chatterbox_tpu_torch.models.t3 import llama as tl
from chatterbox_tpu_torch.models.t3 import t3 as tt
from chatterbox_tpu_torch.ops import flash_decode as fd
from chatterbox_tpu_torch.ops import kernels
from chatterbox_tpu_torch.runtime import profiling

W = fd.TAIL_W


def _randn(*shape, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return x.to(device=device, dtype=dtype).contiguous()


def _pos(n, device="cpu"):
    return torch.tensor([n], dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# the CPU: plain versions given a device position
# ---------------------------------------------------------------------------

# cur_len % 8 in {0, 1, 7}: a tail of 0 and 1 slots, and the step that
# closes the tail
CUR_LENS = (48, 49, 55)


def _k1_inputs(seed):
    cache = _randn(2, 2, 3, 2, 64, 64, seed=seed)
    q, kn, vn = (_randn(3, 2, 64, seed=seed + i) for i in (1, 2, 3))
    rp = torch.tensor([10, 17, 20], dtype=torch.int32)
    return cache, q, kn, vn, rp


@pytest.mark.parametrize("cur_len", CUR_LENS)
def test_k1_plain_takes_a_device_cur_len(cur_len):
    cache, q, kn, vn, rp = _k1_inputs(1)
    for fn in (fd.flash_decode_layer_attention, fd.flash_decode_layer_attention_plain):
        want = fn(cache, 1, cur_len, rp, 24, q, kn, vn)
        assert torch.equal(fn(cache, 1, _pos(cur_len), rp, 24, q, kn, vn), want)
    out, m, l = fd.flash_decode_layer_attention_stats(cache, 1, _pos(cur_len), rp, 24, q, kn, vn)
    want = fd.flash_decode_layer_attention_stats_plain(cache, 1, cur_len, rp, 24, q, kn, vn)
    for a, b in zip((out, m, l), want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cur_len", CUR_LENS)
def test_k1cd_plain_takes_a_device_cur_len(cur_len):
    """K1c+d derives merge_base = cur_len // 8 * 8 from a device cur_len."""
    kv = _randn(2, 2, 3, 2, 64, 64, seed=5)
    cache8, scales = fd.quantize_kv(kv)
    mb = cur_len // W * W
    tail = kv[:, :, :, :, mb:mb + W].contiguous()
    _, q, kn, vn, rp = _k1_inputs(6)
    want = fd.flash_decode_layer_attention_int8_plain(cache8, scales, tail, mb, 1, cur_len, rp,
                                                      24, q, kn, vn)
    for fn in (fd.flash_decode_layer_attention_int8, fd.flash_decode_layer_attention_int8_plain):
        got = fn(cache8, scales, tail, None, 1, _pos(cur_len), rp, 24, q, kn, vn)
        assert torch.equal(got, want)
    with pytest.raises(ValueError):  # the kernel derives merge_base: none may be given
        fd.flash_decode_layer_attention_int8(cache8, scales, tail, mb, 1, _pos(cur_len), rp, 24,
                                             q, kn, vn)


@pytest.mark.parametrize("cur_len", CUR_LENS)
def test_k2_plain_takes_a_device_pos(cur_len):
    """K2 writes slot pos of the cache, and slot pos % 8 of the tail (a ring
    of 8), as the int positions the loop passed before."""
    new = _randn(2, 2, 3, 2, 64, seed=7)
    for s, slot in ((64, cur_len), (W, cur_len - cur_len // W * W)):
        cache = _randn(2, 2, 3, 2, s, 64, seed=8)
        want = fd.kv_cache_append_plain(cache.clone(), new, slot)
        for fn in (fd.kv_cache_append, fd.kv_cache_append_plain):
            assert torch.equal(fn(cache.clone(), new, _pos(cur_len)), want)


@pytest.mark.parametrize("cur_len", CUR_LENS)
def test_k2b_plain_takes_a_device_pos(cur_len):
    """K2b given the step's write slot, as an int or on the device,
    quantizes the tail into the slots it closes, [cur_len - 7, cur_len + 1),
    and writes nothing at other slots."""
    tail = _randn(2, 2, 3, 2, W, 64, seed=9, dtype=torch.float32) * 3
    cache8 = torch.zeros((2, 2, 3, 2, 64, 64), dtype=torch.int8)
    scales = torch.ones((2, 2, 3, 2, 64))
    want = (cache8.clone(), scales.clone())
    if (cur_len + 1) % W == 0:
        q8, sc = fd.quantize_kv(tail)
        want[0][..., cur_len + 1 - W:cur_len + 1, :] = q8
        want[1][..., cur_len + 1 - W:cur_len + 1] = sc
    for fn in (fd.kv_cache_quantize_write, fd.kv_cache_quantize_write_plain):
        for pos in (cur_len, _pos(cur_len)):
            got = (cache8.clone(), scales.clone())
            fn(*got, tail, pos)
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k2b_device_pos_off_the_merge_leaves_cache_untouched():
    """Every write slot that closes no tail leaves the cache and its scales
    as they were, as an int and on the device."""
    tail = _randn(1, 2, 2, 2, W, 64, seed=10) * 3
    cache8 = torch.full((1, 2, 2, 2, 40, 64), 5, dtype=torch.int8)
    scales = torch.full((1, 2, 2, 2, 40), 0.5)
    for w in range(40):
        if (w + 1) % W:
            for pos in (w, _pos(w)):
                a, b = cache8.clone(), scales.clone()
                fd.kv_cache_quantize_write(a, b, tail, pos)
                assert torch.equal(a, cache8) and torch.equal(b, scales), w


def test_k2b_prefill_is_the_write_slot_s0_minus_1():
    """The prefill's s0 tokens are K2b's case pos = s0 - 1, n = s0: they go
    to slots [0, s0), whatever s0 % 8."""
    for s0 in (5, 8, 19):
        src = _randn(1, 2, 2, 2, s0, 64, seed=s0) * 2
        cache8 = torch.zeros((1, 2, 2, 2, 40, 64), dtype=torch.int8)
        scales = torch.ones((1, 2, 2, 2, 40))
        fd.kv_cache_quantize_write(cache8, scales, src, s0 - 1)
        q8, sc = fd.quantize_kv(src)
        assert torch.equal(cache8[..., :s0, :], q8) and torch.equal(scales[..., :s0], sc)
        assert not cache8[..., s0:, :].any() and bool((scales[..., s0:] == 1).all())


def test_k1cd_takes_only_its_own_merge_base():
    """K1c+d's merge_base is cur_len // 8 * 8, which the kernel derives: any
    other value is refused, on either side."""
    kv = _randn(2, 2, 3, 2, 64, 64, seed=11)
    cache8, scales = fd.quantize_kv(kv)
    tail = kv[:, :, :, :, 48:48 + W].contiguous()
    _, q, kn, vn, rp = _k1_inputs(12)
    for fn in (fd.flash_decode_layer_attention_int8, fd.flash_decode_layer_attention_int8_plain):
        assert torch.equal(fn(cache8, scales, tail, 48, 1, 53, rp, 24, q, kn, vn),
                           fn(cache8, scales, tail, None, 1, 53, rp, 24, q, kn, vn))
        with pytest.raises(ValueError):
            fn(cache8, scales, tail, 40, 1, 48, rp, 24, q, kn, vn)


def test_seen_scatter_equals_index_assignment():
    """The repetition penalty's mask: ``scatter_`` (no sync) as the index
    assignment it replaced."""
    g = torch.Generator().manual_seed(0)
    seen = torch.rand((5, 300), generator=g) < 0.1
    tok = torch.randint(0, 300, (5,), generator=g, dtype=torch.int32)
    want = seen.clone()
    want[torch.arange(5), tok.long()] = True
    got = seen.clone()
    got.scatter_(1, tok[:, None].long(), True)
    assert torch.equal(got, want)


def test_cached_inv_freq_equals_rope_inv_freq():
    cfg = tl.LlamaConfig(head_dim=64)
    inv = tl._inv_freq(cfg, "cpu")
    assert inv.dtype == torch.float32
    np.testing.assert_array_equal(inv.numpy(), tl.rope_inv_freq(cfg))
    assert tl._inv_freq(cfg, torch.device("cpu")) is inv  # made once


# ---------------------------------------------------------------------------
# a tiny T3 (head dim 64, the kernels'), on either device
# ---------------------------------------------------------------------------

T3 = tt.T3Config(alignment_layer=1, llama=tl.LlamaConfig(
    hidden_size=128, intermediate_size=256, num_hidden_layers=3, num_attention_heads=2,
    num_key_value_heads=2, head_dim=64))
MAX_NEW = 40


def _t3(device, dtype):
    """Tiny T3 weights whose EOS logit rides hidden channel 0, so that rows
    stop at different steps."""
    p = weights.init_t3(T3, 0, device, dtype)
    w = p["speech_head"]["w"]
    w[T3.stop_speech_token] = 0
    w[T3.stop_speech_token, 0] = 2.0
    return p


def _inputs(device, tmax, b=3):
    """(text (B, tmax) with SOT/EOT framing, right-padded; lens; speaker
    embedding; prompt tokens; emotion)."""
    rng = np.random.default_rng(3)
    lens = np.minimum(np.array([tmax, tmax - 2, tmax - 1])[:b], tmax)
    text = np.zeros((b, tmax), np.int32)
    for i, n in enumerate(lens):
        text[i, 0], text[i, n - 1] = T3.start_text_token, T3.stop_text_token
        text[i, 1:n - 1] = rng.integers(1, 700, n - 2)
    spk = rng.standard_normal((b, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (b, 150)).astype(np.int32)
    emo = np.full((b,), 0.5, np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (text, lens.astype(np.int32), spk,
                                                          prompt, emo))


def test_device_step_follows_the_host_through_chunks_and_breaks():
    """On the CPU (every step eager): the device's step counter and cache
    slot equal the host's step after every chunk, including a chunk that
    ends at a done check which finds every row done."""
    p = _t3("cpu", torch.float32)
    ins = _inputs("cpu", 7)
    sampling = SamplingConfig(cfg_weight=0.5)
    cy = tt.t3_generate_start(p, T3, *ins, sampling, MAX_NEW, cache_quant=True,
                              generator=torch.Generator().manual_seed(1))
    whole = tt.t3_generate(p, T3, *ins, sampling, MAX_NEW, cache_quant=True,
                           generator=torch.Generator().manual_seed(1))
    while True:
        cy, res = tt.t3_generate_resume(p, T3, cy, ins[1], sampling, 3)
        assert int(cy.step) == cy.i and int(cy.pos) == cy.s0 + cy.i
        if bool(cy.done.all()) or cy.i >= MAX_NEW:
            break
    assert torch.equal(res.tokens, whole.tokens) and torch.equal(res.lengths, whole.lengths)
    assert res.steps == whole.steps


# ---------------------------------------------------------------------------
# the card: the graphed loop against the eager one
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode step is captured only on the card")
    return torch.device("cuda")


def _eager(p, cy, text_lens, sampling, n_steps):
    """The loop of ``t3_generate_resume`` with the step body called
    directly, eagerly, on the current stream."""
    max_new = cy.tokens.shape[1]
    i_end = min(cy.i + n_steps, max_new)
    si = tt._step_inputs(p, T3, cy, text_lens, sampling)
    while cy.i < i_end:
        tok = tt._sample_part(cy, si)
        cy.i += 1
        if cy.i == max_new:
            break
        if (cy.i % tt.DONE_CHECK_EVERY == 0 or cy.i == i_end) and bool(cy.done.all()):
            tt._advance(cy)
            break
        tt._forward_part(cy, si, tok)
    return cy, tt._carry_result(cy, T3.stop_speech_token)


def _run(p, ins, sampling, quant, draw, chunk, graphed):
    """(carry, result, K1/K2 launches) of one run: the loop in chunks of
    ``chunk`` steps (None: one), graphed or eager."""
    uniforms = draw if isinstance(draw, torch.Tensor) else None
    gen = None if uniforms is not None else torch.Generator(ins[0].device).manual_seed(draw)
    before = {k: fn.launches for k, fn in kernels().items()}
    cy = tt.t3_generate_start(p, T3, *ins, sampling, MAX_NEW, quant, uniforms=uniforms,
                              generator=gen)
    while True:
        n = chunk or MAX_NEW
        if graphed:
            cy, res = tt.t3_generate_resume(p, T3, cy, ins[1], sampling, n)
        else:
            cy, res = _eager(p, cy, ins[1], sampling, n)
        if bool(cy.done.all()) or res.steps >= MAX_NEW:
            break
    torch.cuda.synchronize()
    launches = {k: fn.launches - before[k] for k, fn in kernels().items()}
    return cy, res, launches


# (KV cache, CFG weight, draws: a seed or injected uniforms, chunk, min_new_tokens,
# text bucket): the bucket sets the prefill length s0 = 34 + bucket + BOS tokens,
# and with it where in the tail of 8 the int8 cache's merges fall
CASES = {
    "bf16-cfg-seed": ("bf16", 0.5, 11, None, 0, 4),
    "int8-cfg-seed-s0mod8=0": ("int8", 0.5, 12, None, 0, 4),
    "int8-cfg-seed-s0mod8=3": ("int8", 0.5, 13, None, 0, 7),
    "int8-cfg-seed-s0mod8=7": ("int8", 0.5, 14, None, 0, 11),
    "bf16-nocfg-uniforms": ("bf16", 0.0, "uniforms", None, 0, 6),
    "int8-nocfg-uniforms-chunks3": ("int8", 0.0, "uniforms", 3, 0, 5),
    "bf16-cfg-seed-chunks5-minnew3": ("bf16", 0.5, 15, 5, 3, 9),
    "int8-cfg-seed-chunks3-minnew3": ("int8", 0.5, 16, 3, 3, 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_graphed_loop_equals_the_eager_loop(cuda, case):
    """Tokens, lengths, the step count, the cache (the int8 values, scales
    and tail) and the kernels' launch counts of the graphed loop equal the
    eager loop's bit for bit; every step but the first replays the graphs,
    and a replayed ``t3.step`` holds no host sync. Both loops run the fused
    step (bf16, head dim 64): its glue kernels launch, and the eager step
    and the capture each count every layer as fused."""
    kv, cfg_w, draw, chunk, min_new, tmax = CASES[case]
    p = _t3(cuda, torch.bfloat16)
    ins = _inputs(cuda, tmax)
    s0 = T3.n_cond + tmax + (2 if cfg_w > 0 else 1)
    if kv == "int8":
        assert s0 % W == {4: 0, 7: 3, 11: 7, 5: 0}[tmax]
    sampling = SamplingConfig(cfg_weight=cfg_w, min_new_tokens=min_new)
    if draw == "uniforms":
        draw = torch.from_numpy(np.random.default_rng(2).random((MAX_NEW, 3), np.float32))
    quant = kv == "int8"
    e_cy, e_res, e_launch = _run(p, ins, sampling, quant, draw, chunk, graphed=False)
    profiling.enable()
    try:
        profiling.take()
        g_cy, g_res, g_launch = _run(p, ins, sampling, quant, draw, chunk, graphed=True)
    finally:
        profiling.disable()
    rec = profiling.take()
    assert torch.equal(g_res.tokens, e_res.tokens)
    assert torch.equal(g_res.lengths, e_res.lengths)
    assert g_res.steps == e_res.steps and g_cy.i == e_cy.i
    caches = ((g_cy.cache, e_cy.cache) if quant else ((g_cy.cache,), (e_cy.cache,)))
    for got, want in zip(*caches):
        assert torch.equal(got, want)
    assert g_launch == e_launch
    assert g_launch["flash_decode_layer_attention_int8" if quant
                    else "flash_decode_layer_attention"] > 0
    n = T3.llama.num_hidden_layers
    forwards = g_launch["rope_split_kv"] // n
    assert forwards > 0 and g_launch["rope_split_kv"] == g_launch["silu_mul"] == n * forwards
    assert g_launch["add_rms_norm"] == (2 * n + 1) * forwards
    fused = [s.counts.get("t3.glue_fused_layers") for s in rec.spans if s.name == "t3.forward"]
    assert fused and all(c == n for c in fused)
    steps = [s for s in rec.spans if s.name == "t3.step"]
    graphed = [s for s in steps if s.counts.get("t3.graph_steps")]
    eager = [s for s in steps if s.counts.get("t3.eager_steps")]
    assert len(steps) == g_cy.i and len(graphed) + len(eager) == len(steps)
    assert len(eager) == 1 and steps[0] in eager  # the first step only
    assert len([s for s in rec.spans if s.name == "t3.capture"]) == 1
    assert all(s.counts.get(profiling.HOST_SYNCS, 0) == 0 for s in graphed)
    assert g_cy.graphs is not None


@pytest.mark.cuda
def test_the_watchdog_stays_eager(cuda):
    """The alignment watchdog's step reads the step on the host: every step
    runs eagerly, and nothing is captured."""
    p = _t3(cuda, torch.bfloat16)
    ins = _inputs(cuda, 6)
    sampling = SamplingConfig()
    profiling.enable()
    try:
        profiling.take()
        res = tt.t3_generate(p, T3, *ins, sampling, 24, alignment=True,
                             generator=torch.Generator(cuda).manual_seed(3))
    finally:
        profiling.disable()
    rec = profiling.take()
    steps = [s for s in rec.spans if s.name == "t3.step"]
    assert steps and all(s.counts.get("t3.eager_steps") == 1 for s in steps)
    assert not [s for s in rec.spans if s.name == "t3.capture"]
    torch.cuda.synchronize()
    assert int(res.lengths.max()) <= 24
