"""T3 on the Granite 4.0-H backbone (``models/t3/granite_hybrid.py``): the
port's prefill and graphed-loop decode against the plain reference
(``benchmark/reference/granite_hybrid.py``: each row alone, no pads, the
Mamba recurrence token by token), the chunked scan, the Mamba-2 update and
K1a's query-head groups against their plain forms, the batch cap's count of
the state, and the paths the backbone refuses.

On the CPU at a tiny fp32 size (seconds); the card tests (marked ``cuda``)
check the update kernel and K1a at G = 4 against their plain versions and
the graphed step against the eager one, bit for bit. This file imports
neither JAX nor the JAX package:

    python -m pytest tests/test_torch_t3_hybrid.py -q --noconftest -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.reference import granite_hybrid as rg
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.core.sampling import SamplingConfig, cfg_combine
from chatterbox_tpu_torch.models.t3 import granite_hybrid as gh
from chatterbox_tpu_torch.models.t3 import t3 as tt
from chatterbox_tpu_torch.ops import flash_decode as fd
from chatterbox_tpu_torch.ops import ssm_decode as sd

# two Mamba layers, attention, Mamba, attention; 4 Mamba heads of 16 with a
# state of 8 and chunks of 8 (the prefill spans several); 4 query heads on
# 2 KV heads
TINY = gh.GraniteHybridConfig(
    hidden_size=64, intermediate_size=96, num_hidden_layers=5,
    layer_types=("mamba", "mamba", "attention", "mamba", "attention"), num_attention_heads=4,
    num_key_value_heads=2, attention_multiplier=1 / 16, mamba_n_heads=4, mamba_d_head=16,
    mamba_d_state=8, mamba_chunk_size=8)
T3 = tt.GraniteT3Config(granite=TINY)
MAX_NEW = 12
CFG = 0.5


def _ref_config(cfg: gh.GraniteHybridConfig):
    fields = {f.name for f in dataclasses.fields(rg.GraniteConfig)}
    return rg.T3Config(granite=rg.GraniteConfig(**{k: getattr(cfg, k) for k in fields}))


def _inputs(lens, seed=0, tmax=None):
    """(text (B, tmax) framed and right-padded, lens, speaker embedding,
    prompt tokens, emotion) for rows of the given text lengths."""
    rng = np.random.default_rng(seed)
    b, tmax = len(lens), tmax or max(lens)
    text = np.zeros((b, tmax), np.int32)
    for i, n in enumerate(lens):
        text[i, 0], text[i, n - 1] = T3.start_text_token, T3.stop_text_token
        text[i, 1:n - 1] = rng.integers(1, 700, n - 2)
    spk = rng.standard_normal((b, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (b, 150)).astype(np.int32)
    return tuple(torch.from_numpy(x) for x in (text, np.asarray(lens, np.int32), spk, prompt,
                                               np.full((b,), 0.5, np.float32)))


@pytest.fixture(scope="module")
def params():
    return weights.init_t3(T3, 0, "cpu", torch.float32)


def _decode_logits(p, ins, sampling, max_new=MAX_NEW):
    """The CFG-combined logits before every step (prefill's, then each
    decode step's) and the served tokens, stepping the carry one step a
    call."""
    b = ins[0].shape[0]
    cy = tt.t3_generate_start(p, T3, *ins, sampling, max_new,
                              generator=torch.Generator().manual_seed(1))
    logs = [cfg_combine(cy.logits[:b], cy.logits[b:], CFG)]
    for _ in range(max_new - 1):
        cy, res = tt.t3_generate_resume(p, T3, cy, ins[1], sampling, 1)
        logs.append(cfg_combine(cy.logits[:b], cy.logits[b:], CFG))
    return torch.stack(logs, dim=1), res.tokens


def test_prefill_then_decode_gives_the_references_logits(params):
    """Rows of text lengths 9, 5 and 7 (pads in mid-sequence), CFG on: the
    logits the decode loop saw at every step equal the reference's full
    forward over each row alone. Both are fp32; the tolerance covers the
    order of the sums (the chunked scan against the token loop, batched
    against single-row products), which moves logits of ~0.1 by ~1e-7."""
    ins = _inputs([9, 5, 7])
    got, tokens = _decode_logits(params, ins, SamplingConfig(cfg_weight=CFG))
    rc = _ref_config(TINY)
    text, lens, spk, prompt, emo = ins
    for r in range(3):
        cond = rg.cond_prefix(params, rc, spk[r:r + 1], prompt[r:r + 1], emo[r:r + 1])
        want = rg.t3_step_logits(params, rc, cond, text[r, :lens[r]], tokens[r], CFG)
        torch.testing.assert_close(got[r], want, rtol=0, atol=2e-6)
        assert want.abs().max() > 0.01  # the comparison is not of zeros


def test_a_row_alone_equals_the_row_in_a_padded_batch(params):
    """Greedy decoding of a 5-token text alone (no pads) and beside a
    9-token one (4 pads in its gap): the same logits at every step, within
    the order of the fp32 sums."""
    sampling = SamplingConfig(cfg_weight=CFG, greedy=True)
    both, tok_both = _decode_logits(params, _inputs([9, 5]), sampling)
    ins = _inputs([9, 5])
    alone_ins = tuple(x[1:] for x in ins)
    alone_ins = (alone_ins[0][:, :5],) + alone_ins[1:]
    alone, tok_alone = _decode_logits(params, alone_ins, sampling)
    assert torch.equal(tok_both[1], tok_alone[0])
    torch.testing.assert_close(both[1], alone[0], rtol=0, atol=2e-6)


def _recurrence(x, dt, A, B, C):
    """The Mamba-2 recurrence token by token from a zero state."""
    b, t, h, p = x.shape
    s = torch.zeros((b, h, p, B.shape[-1]))
    ys = []
    for j in range(t):
        s = torch.exp(dt[:, j] * A)[..., None, None] * s + \
            (dt[:, j, :, None] * x[:, j])[..., None] * B[:, j, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", s, C[:, j]))
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("t", [5, 8, 21])
def test_chunked_scan_equals_the_recurrence_across_chunks(t):
    """``ssd_chunked`` with chunks of 8 over 5 (one short chunk), 8 and 21
    (two whole chunks and a padded one) positions equals the token loop,
    outputs and final state."""
    g = torch.Generator().manual_seed(t)
    x = torch.randn((2, t, 3, 4), generator=g)
    dt = F.softplus(torch.randn((2, t, 3), generator=g) - 2)
    A = -torch.rand(3, generator=g) * 4 - 0.5
    B, C = (torch.randn((2, t, 5), generator=g) for _ in range(2))
    y, s = gh.ssd_chunked(x, dt, A, B, C, 8)
    want_y, want_s = _recurrence(x, dt, A, B, C)
    torch.testing.assert_close(y, want_y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s, want_s, rtol=1e-5, atol=1e-5)


def _update_inputs(rows, h, p, n, dtype=torch.float32, device="cpu", seed=0):
    g = torch.Generator().manual_seed(seed)
    conv_dim = h * p + 2 * n

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g) * scale).to(device)

    return dict(
        conv_state=r(2, rows, conv_dim, 3).to(dtype), ssm_state=r(2, rows, h, p, n, scale=0.3),
        zxbcdt=r(rows, h * p + conv_dim + h).to(dtype), conv_w=r(conv_dim, 4, scale=0.5),
        conv_b=r(conv_dim, scale=0.1), dt_bias=r(h) - 3, A=-torch.rand(h, generator=g).to(device)
        * 8 - 1, D=r(h))


def test_update_plain_equals_one_reference_step():
    """The plain update of layer 1 against the equations written out: the
    conv over the three kept inputs and the new one, SiLU, softplus, the
    state update and y = s C + D x; the conv state moves on by one token
    and layer 0 is left alone."""
    h, p, n = 3, 4, 5
    a = _update_inputs(2, h, p, n)
    before = {k: v.clone() for k, v in a.items()}
    y = sd.ssm_decode_update_plain(a["conv_state"], a["ssm_state"], 1, a["zxbcdt"], a["conv_w"],
                                   a["conv_b"], a["dt_bias"], a["A"], a["D"])
    di = h * p
    xbc = before["zxbcdt"][:, di:2 * di + 2 * n]
    dt = F.softplus(before["zxbcdt"][:, 2 * di + 2 * n:] + before["dt_bias"])
    win = torch.cat([before["conv_state"][1], xbc[..., None]], dim=-1)
    xc = F.silu(torch.einsum("rck,ck->rc", win, before["conv_w"]) + before["conv_b"])
    x, B, C = xc[:, :di].view(2, h, p), xc[:, di:di + n], xc[:, di + n:]
    s = (torch.exp(dt * before["A"])[..., None, None] * before["ssm_state"][1]
         + (dt[..., None] * x)[..., None] * B[:, None, None])
    want = torch.einsum("rhpn,rn->rhp", s, C) + before["D"][:, None] * x
    torch.testing.assert_close(y, want.reshape(2, di), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(a["ssm_state"][1], s, rtol=1e-5, atol=1e-6)
    assert torch.equal(a["conv_state"][1], win[..., 1:])
    assert torch.equal(a["ssm_state"][0], before["ssm_state"][0])
    assert torch.equal(a["conv_state"][0], before["conv_state"][0])


def _gqa_inputs(g, device="cpu", dtype=torch.float32, b=3, hkv=2, s=96):
    gen = torch.Generator().manual_seed(g)

    def r(*shape):
        return torch.randn(shape, generator=gen).to(device=device, dtype=dtype).contiguous()

    cache = r(2, 2, b, hkv, s, 64)
    q, kn, vn = r(b, g * hkv, 64), r(b, hkv, 64), r(b, hkv, 64)
    rp = torch.tensor([10, 17, 20][:b], dtype=torch.int32, device=device)
    return cache, q, kn, vn, rp


def test_k1a_plain_groups_equal_sdpa_on_repeated_kv():
    """K1a's plain path with 2 query heads a KV head and the softmax scale
    1/64: query head j reads KV head j // 2, as SDPA over the repeated K/V
    of the valid slots (the row's prefix and [gap_end, cur_len)) and the
    current token."""
    cache, q, kn, vn, rp = _gqa_inputs(2)
    cur_len, gap_end, scale = 70, 24, 1 / 64
    got = fd.flash_decode_layer_attention(cache, 1, cur_len, rp, gap_end, q, kn, vn, scale=scale)
    k = torch.cat([cache[1, 0, :, :, :cur_len], kn[:, :, None]], dim=2).repeat_interleave(2, 1)
    v = torch.cat([cache[1, 1, :, :, :cur_len], vn[:, :, None]], dim=2).repeat_interleave(2, 1)
    idx = torch.arange(cur_len + 1)
    keep = (idx[None] < rp[:, None]) | (idx[None] >= gap_end)
    want = F.scaled_dot_product_attention(q[:, :, None], k, v, attn_mask=keep[:, None, None],
                                          scale=scale)[:, :, 0]
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_k1b_and_k1cd_refuse_query_groups():
    cache, q, kn, vn, rp = _gqa_inputs(4)
    with pytest.raises(ValueError, match="one query head"):
        fd.flash_decode_layer_attention_stats(cache, 1, 40, rp, 24, q, kn, vn)
    cache8, scales = fd.quantize_kv(cache)
    with pytest.raises(ValueError, match="one query head"):
        fd.flash_decode_layer_attention_int8(cache8, scales, cache[:, :, :, :, :8].contiguous(),
                                             None, 1, 40, rp, 24, q, kn, vn)


def test_batch_cap_counts_the_state():
    """A text's bytes on the Granite backbone are its two rows' KV cache of
    the attention layers and their state (conv inputs and fp32 recurrence),
    and the one-shot cap divides the budget by them."""
    from chatterbox_tpu_torch.pipeline import tts as ptts

    s = -(-(34 + 64 + 2 + 250) // 128) * 128
    kv = 2 * 2 * 2 * 2 * 16 * s * 2  # 2 attention layers, k/v, 2 rows, 2 KV heads of 16
    state = 2 * 3 * ((4 * 16 + 2 * 8) * 3 * 2 + 4 * 16 * 8 * 4)  # 2 rows, 3 Mamba layers
    assert gh.state_bytes_per_row(TINY, 2) * 2 == state
    assert ptts._cache_row_bytes(TINY, 250, 64, 2) == kv + state
    full = gh.GRANITE_4_0_H_MICRO
    assert gh.state_bytes_per_row(full, 2) == 36 * (4352 * 3 * 2 + 64 * 64 * 128 * 4)
    tts = ptts.ChatterboxTTS({}, {}, "cpu", t3_cfg=T3)
    tts.cache_budget_bytes = 10 * (kv + state) + 1
    tts.max_device_batch = 10 ** 6
    assert tts._budget_batch_cap(250, False, 64) == 10
    # at 1000 tokens the auto policy would take the int8 cache; the backbone's is bf16
    assert tts._kv_quant_for(1000)
    tts.cache_budget_bytes = 10 * ptts._cache_row_bytes(TINY, 1000, 64, 2)
    assert tts._budget_batch_cap(1000, False, 64) == 10


def test_published_widths():
    c = gh.GRANITE_4_0_H_MICRO
    assert (c.hidden_size, c.num_hidden_layers, c.intermediate_size) == (2048, 40, 8192)
    assert c.attention_layers == (5, 15, 25, 35) and len(c.mamba_layers) == 36
    assert (c.num_attention_heads, c.num_key_value_heads, c.head_dim) == (32, 8, 64)
    assert (c.d_inner, c.conv_dim, c.in_proj_dim) == (4096, 4352, 8512)
    assert tt.GraniteT3Config(granite=c).dim == 2048 and tt.T3Config().granite is None


def test_refused_paths_raise(params):
    """The int8 KV cache, the alignment watchdog, tensor parallelism,
    int8 weights and training each raise a ValueError naming the backbone."""
    ins = _inputs([9, 5])
    s = SamplingConfig(cfg_weight=CFG)
    for kw in (dict(cache_quant=True), dict(alignment=True)):
        with pytest.raises(ValueError, match="Granite"):
            tt.t3_generate(params, T3, *ins, s, 4, generator=torch.Generator().manual_seed(0),
                           **kw)
    with pytest.raises(ValueError, match="Granite"):
        tt.t3_forward(params, T3, ins[2], ins[3], ins[4], ins[0], ins[1],
                      torch.zeros((2, 4), dtype=torch.int32), torch.tensor([4, 3]))
    from chatterbox_tpu_torch.pipeline import tts as ptts
    from chatterbox_tpu_torch.runtime.precision import apply_tts_precision

    tts = ptts.ChatterboxTTS(params, {"flow": {}}, "cpu", t3_cfg=T3)
    with pytest.raises(ValueError, match="Granite"):
        tts.with_mesh(None, model_sharded=True)
    with pytest.raises(ValueError, match="Granite"):
        apply_tts_precision(tts, torch.float32, weight_quant=True)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU path")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_kernel_equals_its_plain_version(cuda, dtype):
    """The kernel at the published head (64 x 128, conv 4) over 3 heads and
    5 rows, three steps in a row (the B/C conv state shifted by the row's
    last head): y, the state and the conv inputs as the plain version's."""
    a = _update_inputs(5, 3, 64, 128, dtype, cuda, seed=4)
    b = {k: v.clone() for k, v in a.items()}
    for _ in range(3):
        zx = torch.randn_like(a["zxbcdt"], dtype=torch.float32).to(dtype)
        got = sd.ssm_decode_update(a["conv_state"], a["ssm_state"], 1, zx, a["conv_w"],
                                   a["conv_b"], a["dt_bias"], a["A"], a["D"])
        want = sd.ssm_decode_update_plain(b["conv_state"], b["ssm_state"], 1, zx, b["conv_w"],
                                          b["conv_b"], b["dt_bias"], b["A"], b["D"])
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(a["ssm_state"], b["ssm_state"], rtol=1e-4, atol=1e-5)
        assert torch.equal(a["conv_state"], b["conv_state"])


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1a_query_groups_equal_the_plain_version(cuda, dtype, g):
    """K1a with 4 query heads a KV head and the scale 1/64 (the Granite
    attention layers), and with one and the default scale (T3's Llama)."""
    cache, q, kn, vn, rp = _gqa_inputs(g, cuda, dtype)
    scale = 1 / 64 if g > 1 else None
    for cur_len in (30, 70, 96):
        got = fd.flash_decode_layer_attention(cache, 1, cur_len, rp, 24, q, kn, vn, scale=scale)
        want = fd.flash_decode_layer_attention_plain(cache, 1, cur_len, rp, 24, q, kn, vn,
                                                     scale=scale)
        tol = 1e-5 if dtype == torch.float32 else 2e-2
        torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_k1a_groups_of_two_sizes_on_one_cache(cuda):
    """K1a with G = 1 and then G = 4 on one cache, and G = 1 again: each
    size of launch has a workspace of its own, so the wider launch writes
    no partial past the narrower one's, and every launch gives the plain
    version's output."""
    cache, q4, kn, vn, rp = _gqa_inputs(4, cuda)
    q1 = q4[:, ::4].contiguous()
    for q, scale in ((q1, None), (q4, 1 / 64), (q1, None)):
        got = fd.flash_decode_layer_attention(cache, 1, 70, rp, 24, q, kn, vn, scale=scale)
        want = fd.flash_decode_layer_attention_plain(cache, 1, 70, rp, 24, q, kn, vn,
                                                     scale=scale)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert sorted(fd._workspaces[cache]) == [3 * 2, 3 * 2 * 4]


@pytest.mark.cuda
def test_graphed_hybrid_step_equals_the_eager_step(cuda):
    """A tiny fp32 T3 on the Granite backbone with the published Mamba head
    (64 x 128) and query groups of 4: the graphed loop (one eager step, then replays) and the
    eager loop give the same tokens, bit for bit."""
    cfg = dataclasses.replace(TINY, hidden_size=256, mamba_n_heads=2, mamba_d_head=64,
                              mamba_d_state=128, num_attention_heads=4, num_key_value_heads=1,
                              attention_multiplier=1 / 64)
    t3c = tt.GraniteT3Config(granite=cfg)
    p = weights.init_t3(t3c, 0, cuda, torch.float32)
    ins = tuple(x.to(cuda) for x in _inputs([9, 5]))
    s = SamplingConfig(cfg_weight=CFG)
    runs = []
    for graphed in (True, False):
        cy = tt.t3_generate_start(p, t3c, *ins, s, 20,
                                  generator=torch.Generator(cuda).manual_seed(3))
        if graphed:
            cy, res = tt.t3_generate_resume(p, t3c, cy, ins[1], s, 20)
            assert cy.graphs is not None
        else:
            si = tt._step_inputs(p, t3c, cy, ins[1], s)
            while cy.i < 20:
                tok = tt._sample_part(cy, si)
                cy.i += 1
                if cy.i == 20:
                    break
                tt._forward_part(cy, si, tok)
            res = tt._carry_result(cy, t3c.stop_speech_token)
        runs.append(res.tokens.cpu())
    assert torch.equal(runs[0], runs[1])
