"""The port's ``ChatterboxTTS`` end to end (text -> T3 -> token compaction ->
S3Gen -> spread-spectrum watermark -> int16 PCM), held against the JAX
package's ``ChatterboxTTS`` with the same weights and conditionals (CPU).

The vocoder noise is zeroed on both sides, as ``test_from_local.py`` does;
the CFM noise buffer is the same numpy draw in both packages, and the
watermark is deterministic, so it stays on."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    J_S3GEN, J_T3, P_S3GEN, P_T3, loud_s3gen_params, ref_inputs, t3_params, zero_vocoder_noise,
)

TEXTS = ["Hello world.", "A somewhat longer test sentence."]
MAX_NEW = 12
# the alignment layer of the 2-layer tiny Llama, as test_alignment.py sets it
J_T3_ALIGN = dataclasses.replace(J_T3, alignment_layer=1)
P_T3_ALIGN = dataclasses.replace(P_T3, alignment_layer=1)


@pytest.fixture(scope="module")
def jax_tts(tmp_path_factory):
    from chatterbox_tpu.models.s3gen.s3gen import RefDict
    from chatterbox_tpu.pipeline.conditionals import Conditionals, T3CondData
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS

    rng = np.random.default_rng(9)
    conds = Conditionals(
        T3CondData(rng.standard_normal((1, 256)).astype(np.float32),
                   rng.integers(0, 6561, (1, 150)).astype(np.int32),
                   np.full((1,), 0.5, np.float32)),
        RefDict(*ref_inputs(10)),
    )
    tts = ChatterboxTTS(
        t3_params=jax.tree.map(jnp.asarray, t3_params()[0]),
        s3gen_params=jax.tree.map(jnp.asarray, loud_s3gen_params()[0]),
        ve_params={}, tokenizer=None, t3_cfg=J_T3, s3gen_cfg=J_S3GEN,
        conds=jax.tree.map(jnp.asarray, conds), kv_quant=False,
    )
    out = tmp_path_factory.mktemp("native")
    tts.save_native(out)
    return tts, out


@pytest.fixture(scope="module")
def jax_wavs(jax_tts):
    from chatterbox_tpu.models.s3gen import s3gen as js

    tts, _ = jax_tts
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        return tts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW)
    finally:
        js.hift_generate = real


@pytest.fixture
def zero_port_noise(monkeypatch):
    from chatterbox_tpu_torch.models.s3gen import s3gen as ps

    monkeypatch.setattr(ps, "hift_generate", zero_vocoder_noise(ps.hift_generate, torch.zeros))


@pytest.fixture(scope="module")
def jax_variant_wavs(jax_tts):
    """The JAX pipeline's wavs with its int8 KV cache switched on
    (``kv_quant``), and with the alignment watchdog (which forces the
    working-dtype cache), at zero vocoder noise."""
    from chatterbox_tpu.models.s3gen import s3gen as js

    tts, _ = jax_tts
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    tts.kv_quant, tts.t3_cfg = True, J_T3_ALIGN
    try:
        return {alignment: tts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW,
                                              alignment=alignment)
                for alignment in (False, True)}
    finally:
        js.hift_generate = real
        tts.kv_quant, tts.t3_cfg = False, J_T3


def _port_tts(t3_cfg=P_T3, **kw):
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    return ChatterboxTTS(t3_params()[1], loud_s3gen_params()[1], "cpu", t3_cfg=t3_cfg,
                         s3gen_cfg=P_S3GEN, **kw)


def _check(got, want):
    assert len(got) == len(want) == len(TEXTS)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and len(g) % 960 == 0
        assert np.abs(w).max() > 0.01  # > 300 int16 steps, not a few
        # test_hifigan.py's full-inference tolerance; int16 PCM on both sides
        np.testing.assert_allclose(g, w, atol=5e-3)


def test_generate_batch_matches_jax(jax_tts, jax_wavs, zero_port_noise):
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    tts = _port_tts()
    conds = Conditionals.load(jax_tts[1] / "conds.safetensors")
    _check(tts.generate_batch(TEXTS, conds=conds, greedy=True, max_new_tokens=MAX_NEW), jax_wavs)


@pytest.mark.parametrize("alignment", [False, True])
def test_generate_batch_int8_cache_and_alignment_match_jax(jax_tts, jax_variant_wavs,
                                                          zero_port_noise, alignment):
    """``kv_quant=True`` on both sides: T3 runs the int8 cache, unless the
    watchdog is on, which forces the working-dtype (here fp32) cache. The
    watchdog reads layer 1 of the 2-layer T3."""
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    tts = _port_tts(P_T3_ALIGN, kv_quant=True)
    conds = Conditionals.load(jax_tts[1] / "conds.safetensors")
    got = tts.generate_batch(TEXTS, conds=conds, greedy=True, max_new_tokens=MAX_NEW,
                             alignment=alignment)
    assert tts.last_timings["kv_cache"] == ("fp32" if alignment else "int8")
    assert tts.last_timings["alignment"] is alignment
    _check(got, jax_variant_wavs[alignment])


def test_kv_quant_policy_matches_jax(jax_tts, monkeypatch):
    """The int8 cache from 500 tokens on unless set explicitly, as in the
    JAX package; CHATTERBOX_KV_QUANT=1/0 sets it when the constructor does
    not."""
    monkeypatch.delenv("CHATTERBOX_KV_QUANT", raising=False)
    jtts = jax_tts[0]
    port = _port_tts()
    assert port.kv_quant is None
    assert not port._kv_quant_for(499) and port._kv_quant_for(500)
    try:
        for flag in (None, True, False):
            port.kv_quant = jtts.kv_quant = flag
            for n in (12, 250, 499, 500, 1000):
                assert port._kv_quant_for(n) == jtts._kv_quant_for(n), (flag, n)
    finally:
        jtts.kv_quant = False
    monkeypatch.setenv("CHATTERBOX_KV_QUANT", "1")
    assert _port_tts().kv_quant is True and _port_tts(kv_quant=False).kv_quant is False
    monkeypatch.setenv("CHATTERBOX_KV_QUANT", "0")
    assert _port_tts()._kv_quant_for(1000) is False


def test_from_native_matches_jax(jax_tts, jax_wavs, zero_port_noise):
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    tts = ChatterboxTTS.from_native(jax_tts[1], device="cpu")
    assert tts.t3_cfg == P_T3 and tts.s3gen_cfg == P_S3GEN and tts.conds is not None
    _check(tts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW), jax_wavs)


def test_generate_returns_k_variants(jax_tts):
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    tts = _port_tts()
    tts.conds = Conditionals.load(jax_tts[1] / "conds.safetensors")
    w = tts.generate("Short.", max_new_tokens=8, seed=1, num_return_sequences=3)
    assert w.ndim == 2 and w.shape[0] == 3 and np.isfinite(w).all()
    assert not np.array_equal(w[0], w[1]) or not np.array_equal(w[1], w[2])


def test_punc_norm_and_buckets():
    from chatterbox_tpu.pipeline import tts as jt
    from chatterbox_tpu_torch.pipeline import tts as pt

    for s in ["", "hello  world", "Hi there…", "test;", "a: b - c", "“quoted”"]:
        assert pt.punc_norm(s) == jt.punc_norm(s)
    assert pt.TEXT_BUCKETS == jt.TEXT_BUCKETS and pt.TOKEN_BUCKETS == jt.TOKEN_BUCKETS


@pytest.fixture(scope="module")
def jax_turbo_wavs(jax_tts):
    """The JAX pipeline's wavs at ``flow_steps=4`` (zero vocoder noise)."""
    from chatterbox_tpu.models.s3gen import s3gen as js

    tts, _ = jax_tts
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        return tts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW, flow_steps=4)
    finally:
        js.hift_generate = real


def test_flow_steps_env_knob_and_validation(monkeypatch):
    """CHATTERBOX_FLOW_STEPS sets the CFM Euler step count at construction,
    as the JAX package's (test_pipeline.py:264-290): unset keeps 10, the
    rest of the config stays as it is, and a value that is not an integer
    >= 1 fails at construction."""
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JTTS

    monkeypatch.delenv("CHATTERBOX_FLOW_STEPS", raising=False)
    base = _port_tts()
    assert base.s3gen_cfg == P_S3GEN and base.s3gen_cfg.flow.n_timesteps == 10
    monkeypatch.setenv("CHATTERBOX_FLOW_STEPS", "6")
    six = _port_tts()
    want = JTTS(t3_params={}, s3gen_params={}, ve_params={}, tokenizer=None, s3gen_cfg=J_S3GEN)
    assert six.s3gen_cfg.flow.n_timesteps == want.s3gen_cfg.flow.n_timesteps == 6
    assert six.s3gen_cfg.flow.estimator == base.s3gen_cfg.flow.estimator
    assert six.s3gen_cfg.tokenizer == base.s3gen_cfg.tokenizer
    for bad in ("0", "-3", "four"):
        monkeypatch.setenv("CHATTERBOX_FLOW_STEPS", bad)
        with pytest.raises(ValueError, match="CHATTERBOX_FLOW_STEPS"):
            _port_tts()


def test_per_call_flow_steps_matches_jax(jax_tts, jax_turbo_wavs, zero_port_noise, monkeypatch):
    """``flow_steps=4`` for one call (test_pipeline.py:293-310): the same T3
    tokens and lengths, a different wav, the default tier unchanged on the
    next call; the wavs within the pipeline limit of the JAX package's at
    the same ``flow_steps``; ``flow_steps=0`` raises."""
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    monkeypatch.delenv("CHATTERBOX_FLOW_STEPS", raising=False)
    tts = _port_tts()
    conds = Conditionals.load(jax_tts[1] / "conds.safetensors")
    kw = dict(conds=conds, greedy=True, max_new_tokens=MAX_NEW)
    base = tts.generate_batch(TEXTS, **kw)
    base_tokens = tts.last_speech_tokens
    turbo = tts.generate_batch(TEXTS, flow_steps=4, **kw)
    assert tts.last_timings["flow_steps"] == 4
    for a, b in zip(base_tokens, tts.last_speech_tokens):
        np.testing.assert_array_equal(a, b)
    assert [len(w) for w in base] == [len(w) for w in turbo]
    assert not all(np.array_equal(a, b) for a, b in zip(base, turbo))
    _check(turbo, jax_turbo_wavs)
    again = tts.generate_batch(TEXTS, **kw)
    assert tts.last_timings["flow_steps"] == 10
    for a, b in zip(base, again):
        np.testing.assert_array_equal(a, b)
    for bad in (0, -1):
        with pytest.raises(ValueError, match="flow_steps"):
            tts.generate_batch(TEXTS, flow_steps=bad, **kw)


def test_generate_batch_int8_weights_match_jax(jax_tts, zero_port_noise):
    """``apply_tts_precision(weight_quant=True)`` end to end on both sides
    (test_weight_quant.py::test_pipeline_weight_quant_smoke), kept in fp32
    so that the comparison holds the int8 layout and not bf16 round-off:
    the wavs within the pipeline limit of the JAX package's, and
    ``_unfuse_qkv`` back to the canonical layout gives the dense model's
    int8-rounded weights."""
    from chatterbox_tpu.models.s3gen import s3gen as js
    from chatterbox_tpu.runtime.precision import apply_tts_precision as j_apply
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals
    from chatterbox_tpu_torch.runtime.precision import apply_tts_precision

    jtts, native = jax_tts
    saved = jtts.t3_params, jtts.s3gen_params
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        j_apply(jtts, dtype=jnp.float32, weight_quant=True)
        want = jtts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW)
    finally:
        js.hift_generate = real
        jtts.t3_params, jtts.s3gen_params = saved
    tts = apply_tts_precision(_port_tts(), dtype=torch.float32, weight_quant=True)
    assert tts._runtime_llama_layout(tts.t3_params)
    conds = Conditionals.load(native / "conds.safetensors")
    _check(tts.generate_batch(TEXTS, conds=conds, greedy=True, max_new_tokens=MAX_NEW), want)
    tts._unfuse_qkv()
    layers = tts.t3_params["llama"]["layers"]
    assert not tts._runtime_llama_layout(tts.t3_params) and layers["q"]["w"].dtype == torch.float32
