"""The port's T3 with the int8 KV cache (``cache_quant``) and with the
alignment watchdog (``alignment``), held against ``chatterbox_tpu/models/t3``
on the same weights (CPU, fp32; the JAX side runs its Pallas kernels in
interpret mode, on its (D, S) cache layout with the 8-token tail).

Tokens and ``steps`` must be exactly equal; for sampled decoding the JAX key
chain's uniforms are fed to the port (``torch_parity.jax_uniforms``). The int8
carry is held bit for bit where both sides quantize the same K/V: the port's
fp32 K/V differ from XLA's in round-off (about 1e-7), enough to move a
value across a rounding boundary of the int8 grid now and then, so the
end-to-end check allows one int8 step there."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (J_T3, P_T3, assert_close, eos_boosted_t3_params, gen_inputs, j,
                          jax_uniforms, t, t3_params)

from chatterbox_tpu.core.sampling import SamplingConfig as JSampling
from chatterbox_tpu.models.t3 import alignment as ja
from chatterbox_tpu.models.t3 import llama as jl
from chatterbox_tpu.models.t3 import t3 as jt
from chatterbox_tpu_torch.core.sampling import SamplingConfig as PSampling
from chatterbox_tpu_torch.models.t3 import alignment as pa
from chatterbox_tpu_torch.models.t3 import llama as pl
from chatterbox_tpu_torch.models.t3 import t3 as pt

EOS = J_T3.stop_speech_token
S_CACHE = 128
N_STEPS = 20
# the alignment layer of the 2-layer tiny Llama, as test_alignment.py sets it
J_T3_ALIGN = dataclasses.replace(J_T3, alignment_layer=1)
P_T3_ALIGN = dataclasses.replace(P_T3, alignment_layer=1)


def test_quantize_kv_matches_jax_bit_for_bit():
    """Random tokens, all-zero (padding) tokens and tokens whose values fall
    exactly half-way between two int8 steps (ties round to even), against
    ``quantize_kv`` compiled, as the JAX decode loop runs it (XLA turns its
    division by 127 into a multiply by the fp32 reciprocal)."""
    rng = np.random.default_rng(0)
    kv = (rng.standard_normal((2, 2, 3, 2, 40, 32)) * 3).astype(np.float32)
    kv[..., 5, :] = 0.0
    kv[0, 0, 0, 0, 7, :5] = [127.0, 0.5, 1.5, -2.5, 126.5]  # scale 1: ties
    got_q, got_s = pl.quantize_kv(t(kv))
    want_q, want_s = jax.jit(jl.quantize_kv)(j(kv))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q[0, 0, 0, 0, 7, :5].tolist() == [127, 0, 2, -2, 126]
    assert (got_q[..., 5, :] == 0).all() and (got_s[..., 5] == np.float32(1e-8)).all()


@pytest.fixture(scope="module")
def jax_int8_decode():
    """A prefill of 21 tokens (not a multiple of 8) and 20 decode steps
    through the JAX package with ``cache_quant`` (three merges of the tail).
    Returns the inputs, each step's hidden state and the JAX carry (int8
    (D, S) cache, scales, tail) after the prefill and after every step."""
    jp, _ = t3_params()
    rng = np.random.default_rng(1)
    b, s0, c = 3, 21, 64
    x = (rng.standard_normal((b, s0, c)) * 0.5).astype(np.float32)
    lens = np.array([s0, s0 - 7, s0 - 3])
    valid = np.arange(s0)[None] < lens[:, None]
    pos = np.where(valid, np.cumsum(valid, 1) - 1, 0).astype(np.int32)
    # the last prefill slot sits past the text-padding gap, as BOS does
    row_prefix, gap_end = (lens - 1).astype(np.int32), s0 - 1
    embs = (rng.standard_normal((N_STEPS, b, 1, c)) * 0.5).astype(np.float32)
    # compiled, as inside t3_generate (XLA's quantize_kv arithmetic, see
    # test_quantize_kv_matches_jax_bit_for_bit)
    _, carry = jax.jit(lambda *a: jl.llama_prefill(
        jp["llama"], J_T3.llama, *a, S_CACHE, ds_layout=True, cache_quant=True))(
            j(x), j(pos), j(valid))
    # the unquantized prefill K/V, for the port's carry driven by JAX's K/V
    _, kv_prefill = jl.llama_prefill(jp["llama"], J_T3.llama, j(x), j(pos), j(valid), S_CACHE)

    @jax.jit
    def step(emb, carry, wp):
        rope = (j(row_prefix) + 3 + wp - s0)[:, None]
        slots = jnp.arange(S_CACHE)[None]
        alm = (slots < j(row_prefix)[:, None]) | ((slots >= gap_end) & (slots <= wp))
        h, carry, _ = jl.llama_decode_step(jp["llama"], J_T3.llama, emb, carry, wp, rope, alm,
                                           pallas_valid=(j(row_prefix), gap_end), ds_layout=True)
        return h, carry

    carries, hidden = [tuple(np.asarray(a) for a in carry)], []
    for i in range(N_STEPS):
        h, carry = step(j(embs[i]), carry, jnp.int32(s0 + i))
        hidden.append(np.asarray(h))
        carries.append(tuple(np.asarray(a) for a in carry))
    return dict(x=x, pos=pos, valid=valid, row_prefix=row_prefix, gap_end=gap_end, embs=embs,
                s0=s0, hidden=hidden, carries=carries, kv_prefill=np.asarray(kv_prefill))


def _port_carry(carry):
    """A JAX carry (int8 (L, 2, B, H, D, S), scales, tail) in the port's
    (S, D) layout."""
    c8, sc, tail = carry
    return c8.transpose(0, 1, 2, 3, 5, 4), sc, tail


def test_int8_cache_carry_matches_jax_bit_for_bit(jax_int8_decode):
    """The port's int8 carry (K2b over the prefill, then K2 into the tail and
    K2b every 8th step, through ``kv_cache_write``), driven by the K/V that
    JAX computed, equals the JAX carry bit for bit after the prefill and
    after each of the 20 steps."""
    r = jax_int8_decode
    s0, kv = r["s0"], t(r["kv_prefill"])
    values = torch.zeros(kv.shape, dtype=torch.int8)
    scales = torch.ones(kv.shape[:5])
    pl.kv_cache_quantize_write(values, scales, kv[..., :s0, :].contiguous(), s0 - 1)
    tail = torch.zeros(kv.shape[:4] + (pl.TAIL_W, kv.shape[-1]))
    mb0 = s0 // pl.TAIL_W * pl.TAIL_W
    tail[..., :s0 - mb0, :] = kv[..., mb0:s0, :]
    cache = pl.QuantCache(values, scales, tail)
    for i, want in enumerate(r["carries"]):
        if i > 0:  # the step's K/V, as JAX wrote them into its tail
            wp = s0 + i - 1
            new_kv = torch.from_numpy(want[2][:, :, :, :, wp % pl.TAIL_W].copy())
            pl.kv_cache_write(cache, new_kv, wp)
        for got, w, name in zip(cache, _port_carry(want), ("values", "scales", "tail")):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=f"{name} after step {i}")


def test_int8_decode_matches_jax(jax_int8_decode):
    """The port's own prefill and 20 decode steps with ``cache_quant``:
    hidden states at the fp32 tolerance of ``test_llama_decode_step_matches_jax``
    (the int8 reads agree, the arithmetic around them differs in
    round-off), and a carry within one int8 step of JAX's."""
    r = jax_int8_decode
    _, pp = t3_params()
    _, cache = pl.llama_prefill(pp["llama"], P_T3.llama, t(r["x"]), t(r["pos"]), t(r["valid"]),
                                S_CACHE, cache_quant=True)
    assert isinstance(cache, pl.QuantCache) and cache.values.dtype == torch.int8
    assert tuple(cache.tail.shape) == (2, 2, 3, 2, pl.TAIL_W, 32)
    s0 = r["s0"]
    for i in range(N_STEPS):
        rope = (r["row_prefix"] + 3 + i)[:, None].astype(np.int32)
        h, attn = pl.llama_decode_step(pp["llama"], P_T3.llama, t(r["embs"][i]), cache, s0 + i,
                                       t(rope), t(r["row_prefix"]), r["gap_end"])
        assert attn is None
        assert_close(h, r["hidden"][i], 2e-5, 1e-5, msg=f"step {i}")
    values, scales, tail = _port_carry(r["carries"][-1])
    step_diff = np.abs(cache.values.numpy().astype(np.int32) - values)
    assert step_diff.max() <= 1 and (step_diff > 0).mean() < 1e-4
    assert_close(cache.scales, scales, 0.0, 1e-6)
    assert_close(cache.tail, tail, 1e-6)


def _generate_both(jcfg, pcfg, greedy, cfg_weight, max_new=24, seed=11, **kw):
    jp, pp = eos_boosted_t3_params()
    text, lens, spk, prompt, emo = gen_inputs()
    samp = dict(greedy=greedy, cfg_weight=cfg_weight)
    want = jt.t3_generate(jax.tree.map(jnp.asarray, jp), jcfg, j(text), j(lens), j(spk),
                          j(prompt), j(emo), jax.random.PRNGKey(seed), JSampling(**samp),
                          max_new, **kw)
    uniforms = None if greedy else t(jax_uniforms(seed, max_new, len(lens)))
    got = pt.t3_generate(pp, pcfg, t(text), t(lens), t(spk), t(prompt), t(emo),
                         PSampling(**samp), max_new, uniforms=uniforms, **kw)
    return got, want


def _assert_same_tokens(got, want):
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)


@pytest.mark.parametrize("greedy,cfg_weight", [(True, 0.5), (True, 0.0), (False, 0.5),
                                               (False, 0.0)])
def test_t3_generate_int8_cache_tokens_exact(greedy, cfg_weight):
    _assert_same_tokens(*_generate_both(J_T3, P_T3, greedy, cfg_weight, cache_quant=True))


@pytest.mark.parametrize("greedy,cfg_weight", [(True, 0.5), (False, 0.5), (False, 0.0)])
def test_t3_generate_alignment_tokens_exact(greedy, cfg_weight):
    """The watchdog reads layer 1's text attention, rebuilt from K1b's
    stats; ``cache_quant`` is asked for and must be forced off."""
    _assert_same_tokens(*_generate_both(J_T3_ALIGN, P_T3_ALIGN, greedy, cfg_weight,
                                        alignment=True, cache_quant=True))


def test_alignment_layer_text_probs_match_jax():
    """One decode step with the alignment layer on: the rebuilt head-mean
    text attention equals the JAX package's (Pallas stats path)."""
    jp, pp = t3_params()
    rng = np.random.default_rng(4)
    b, s0, c, lo, hi = 3, 21, 64, 2, 16
    x = (rng.standard_normal((b, s0, c)) * 0.5).astype(np.float32)
    valid = np.ones((b, s0), bool)
    pos = np.tile(np.arange(s0, dtype=np.int32), (b, 1))
    _, cache = jl.llama_prefill(jp["llama"], J_T3.llama, j(x), j(pos), j(valid), S_CACHE)
    row_prefix, gap_end, wp = np.array([16, 9, 12], np.int32), hi, s0
    emb = (rng.standard_normal((b, 1, c)) * 0.5).astype(np.float32)
    rope = np.full((b, 1), s0, np.int32)
    slots = np.arange(S_CACHE)[None]
    alm = (slots < row_prefix[:, None]) | ((slots >= gap_end) & (slots <= wp))
    hj, _, attn_j = jl.llama_decode_step(
        jp["llama"], J_T3.llama, j(emb), cache, wp, j(rope), j(alm), collect_attn_layer=1,
        pallas_valid=(j(row_prefix), gap_end), attn_slice=(lo, hi))
    hp, attn_p = pl.llama_decode_step(pp["llama"], P_T3.llama, t(emb), t(np.asarray(cache)), wp,
                                      t(rope), t(row_prefix), gap_end, align_layer=1,
                                      text_slice=(lo, hi))
    assert_close(hp, np.asarray(hj), 2e-5, 1e-5)
    assert tuple(attn_p.shape) == (b, hi - lo)
    assert_close(attn_p, np.asarray(attn_j)[:, lo:hi], 1e-6)
    assert float(attn_p[1, row_prefix[1] - lo:].abs().max()) == 0.0  # past the row's text


def _alignment_script(steps=40, s=12):
    """Per-step attention rows (steps, 3, s) that walk each row's state
    through the watchdog's cases: row 0 advances one column a step to the
    end and parks on the last token (completion, then long tail); row 1
    advances, then attends to early text after completion (repetition);
    row 2 never attends to its first four columns (a false start that
    lasts) and jumps between the others (discontinuity)."""
    rng = np.random.default_rng(5)
    rows = np.abs(rng.standard_normal((steps, 3, s)).astype(np.float32)) * 0.02
    for i in range(steps):
        rows[i, 0, min(i, s - 1)] += 0.9
        rows[i, 1, min(i, s - 1) if i < 14 else 1] += 0.9
        rows[i, 2, 4 + (i * 5) % (s - 6)] += 0.9
    return rows


def test_alignment_step_matches_jax():
    s, vocab = 12, 8194
    rows = _alignment_script(s=s)
    lens = np.array([s, s, s - 2], np.int32)
    logits = np.random.default_rng(6).standard_normal((len(rows), 3, vocab)).astype(np.float32)
    js, ps = ja.init_align_state(3, 1, s), pa.init_align_state(3, s)
    forced = np.zeros(3, bool)
    for i in range(len(rows)):
        js, jl_out = ja.alignment_step(js, j(rows[i]), j(lens), jnp.int32(i), j(logits[i]), EOS)
        ps, pl_out = pa.alignment_step(ps, t(rows[i]), t(lens), i, t(logits[i]), EOS)
        for name, got, want in zip(pa.AlignState._fields, ps, js):
            assert_close(got, np.asarray(want), 1e-6, msg=f"{name} at step {i}")
        assert_close(pl_out, np.asarray(jl_out), 1e-6, msg=f"logits at step {i}")
        forced |= pl_out[:, EOS].numpy() >= pa.BIG
    # the script reaches the cases it is meant to cover
    assert ps.complete[:2].all() and forced[:2].all() and not bool(ps.started[2])
    assert float(ps.tail_mass[0].max()) >= 10.0 and float(ps.rep_sum[1]) > 5.0


@pytest.mark.parametrize("setting,match", [
    (dict(llama=dataclasses.replace(P_T3.llama, num_key_value_heads=1)), "num_key_value_heads"),
    (dict(alignment_layer=9), "alignment_layer 9"),  # the 2-layer model has no layer 9
])
def test_alignment_raises_on_settings_it_cannot_serve(setting, match):
    """Where the JAX package asserts (unequal KV heads) or clamps silently
    (an alignment layer past the last), the port raises a ValueError that
    names the setting, on weights of that config."""
    from chatterbox_tpu_torch import weights

    cfg = dataclasses.replace(P_T3_ALIGN, **setting)
    pp = weights.init_t3(cfg, seed=0)
    text, lens, spk, prompt, emo = gen_inputs()
    with pytest.raises(ValueError, match=match):
        pt.t3_generate(pp, cfg, t(text), t(lens), t(spk), t(prompt), t(emo),
                       PSampling(greedy=True), 4, alignment=True)
