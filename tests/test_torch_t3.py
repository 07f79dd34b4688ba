"""The port's T3 (Llama backbone, conditioning prefix, CFG decode loop),
held against ``chatterbox_tpu/models/t3`` on the same weights (CPU, fp32).

Tokens and lengths must be exactly equal. For sampled decoding the JAX key
chain of ``t3_generate`` (``key, sub = split(key); u = uniform(sub, (B,))``
per step) is rebuilt in JAX and its uniforms are fed to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (J_T3, P_T3, assert_close, eos_boosted_t3_params, gen_inputs, j,
                          jax_uniforms, t, t3_params)

from chatterbox_tpu.core.sampling import SamplingConfig as JSampling
from chatterbox_tpu.models.t3 import llama as jl
from chatterbox_tpu.models.t3 import t3 as jt
from chatterbox_tpu_torch.core.sampling import SamplingConfig as PSampling
from chatterbox_tpu_torch.models.t3 import llama as pl
from chatterbox_tpu_torch.models.t3 import t3 as pt

EOS = J_T3.stop_speech_token


def _prefill_inputs(seed, b=3, t_len=20, c=64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, t_len, c)) * 0.5).astype(np.float32)
    lens = np.array([t_len, t_len - 7, t_len - 3])[:b]
    valid = np.arange(t_len)[None] < lens[:, None]
    pos = np.where(valid, np.cumsum(valid, 1) - 1, 0).astype(np.int32)
    return x, pos, valid


def test_rope_inv_freq_llama3():
    np.testing.assert_array_equal(pl.rope_inv_freq(pl.LLAMA_520M), jl.rope_inv_freq(jl.LLAMA_520M))
    np.testing.assert_array_equal(pl.rope_inv_freq(P_T3.llama), jl.rope_inv_freq(J_T3.llama))


def test_llama_prefill_matches_jax():
    jp, pp = t3_params()
    x, pos, valid = _prefill_inputs(0)
    hj, cj = jl.llama_prefill(jp["llama"], J_T3.llama, j(x), j(pos), j(valid), 128)
    hp, cp = pl.llama_prefill(pp["llama"], P_T3.llama, t(x), t(pos), t(valid), 128)
    assert tuple(cp.shape) == (2, 2, 3, 2, 128, 32)
    for row, n in enumerate(valid.sum(1)):  # pad positions' hidden is unused
        assert_close(hp[row, :n], np.asarray(hj)[row, :n], 2e-5, 1e-5)
    assert_close(cp, np.asarray(cj), 2e-5, 1e-5)


def test_llama_decode_step_matches_jax():
    """One step after a prefill, with a text-padding gap: the port writes
    the new K/V at write_pos in place, JAX returns the updated cache."""
    jp, pp = t3_params()
    x, pos, valid = _prefill_inputs(1)
    _, cj = jl.llama_prefill(jp["llama"], J_T3.llama, j(x), j(pos), j(valid), 128)
    b, s0 = x.shape[0], x.shape[1]
    row_prefix = valid.sum(1).astype(np.int32) - 1  # the last prefill slot sits past the gap
    gap_end = s0 - 1
    write_pos = s0 + 2  # two decoded tokens already cached
    rng = np.random.default_rng(2)
    cache_np = np.asarray(cj).copy()
    cache_np[..., s0:write_pos, :] = rng.standard_normal(cache_np[..., s0:write_pos, :].shape)
    cache = t(cache_np)
    emb = (rng.standard_normal((b, 1, 64)) * 0.5).astype(np.float32)
    rope = (row_prefix + 3)[:, None].astype(np.int32)
    slots = np.arange(128)[None]
    attn_len_mask = (slots < row_prefix[:, None]) | ((slots >= gap_end) & (slots <= write_pos))
    hj, cj2, _ = jl.llama_decode_step(
        jp["llama"], J_T3.llama, j(emb), j(cache_np), write_pos, j(rope), j(attn_len_mask),
        pallas_valid=(j(row_prefix), gap_end))
    hp, attn = pl.llama_decode_step(pp["llama"], P_T3.llama, t(emb), cache, write_pos, t(rope),
                                    t(row_prefix), gap_end)
    assert attn is None
    assert_close(hp, np.asarray(hj), 2e-5, 1e-5)
    assert_close(cache, np.asarray(cj2), 2e-5, 1e-5)


@pytest.mark.parametrize("greedy,cfg_weight,top_p,min_new", [
    (True, 0.5, 1.0, 0),
    (True, 0.0, 1.0, 3),
    (False, 0.5, 1.0, 0),
    (False, 0.0, 0.8, 0),
])
def test_t3_generate_tokens_exact(greedy, cfg_weight, top_p, min_new):
    jp, pp = eos_boosted_t3_params()
    text, lens, spk, prompt, emo = gen_inputs()
    max_new, seed = 24, 11
    kw = dict(greedy=greedy, cfg_weight=cfg_weight, top_p=top_p, min_new_tokens=min_new)
    want = jt.t3_generate(jax.tree.map(jnp.asarray, jp), J_T3, j(text), j(lens), j(spk),
                          j(prompt), j(emo), jax.random.PRNGKey(seed), JSampling(**kw), max_new)
    uniforms = None if greedy else t(jax_uniforms(seed, max_new, len(lens)))
    got = pt.t3_generate(pp, P_T3, t(text), t(lens), t(spk), t(prompt), t(emo),
                         PSampling(**kw), max_new, uniforms=uniforms)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)


def test_t3_generate_stops_rows_with_eos_padding():
    """The boosted head stops rows at different steps: each row is EOS from
    its length on, and ``steps`` is where the JAX loop would have exited."""
    _, pp = eos_boosted_t3_params()
    text, lens, spk, prompt, emo = gen_inputs()
    u = t(np.random.default_rng(4).random((40, 3)).astype(np.float32))
    res = pt.t3_generate(pp, P_T3, t(text), t(lens), t(spk), t(prompt), t(emo),
                         PSampling(), 40, uniforms=u)
    toks, n = res.tokens.numpy(), res.lengths.numpy()
    assert len(set(n.tolist())) > 1 and n.max() < 40
    for row in range(3):
        assert (toks[row, n[row]:] == EOS).all() and (toks[row, :n[row]] != EOS).all()
    assert res.steps == n.max() + 1


def test_t3_generate_draws_from_a_generator_by_default():
    _, pp = t3_params()
    text, lens, spk, prompt, emo = gen_inputs()
    args = (pp, P_T3, t(text), t(lens), t(spk), t(prompt), t(emo), PSampling(), 6)
    a = pt.t3_generate(*args, generator=torch.Generator().manual_seed(1)).tokens
    b = pt.t3_generate(*args, generator=torch.Generator().manual_seed(1)).tokens
    c = pt.t3_generate(*args, generator=torch.Generator().manual_seed(2)).tokens
    assert torch.equal(a, b) and not torch.equal(a, c)
