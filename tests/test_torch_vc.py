"""The port's ``ChatterboxVC`` end to end (int16 source packing -> masked S3
tokens -> S3Gen with the target voice's RefDict -> watermark -> int16 PCM),
held against the JAX package's ``ChatterboxVC`` with the same weights and
audio (CPU, fp32).

The vocoder noise is zeroed on both sides, as ``test_torch_pipeline.py``
does; the CFM noise is the same numpy draw in both packages, and the
watermark is deterministic, so it stays on. The UNet runs fused (K3 on both
sides) and, in the port, also unfused (K5), against the JAX fused run:
the JAX dispatch cannot run unfused weights with its flash kernels on
(``test_torch_kernels.py::test_unet_attn_dispatch_matches_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import J_S3GEN, P_S3GEN, s3gen_with_conditioning, zero_vocoder_noise

from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.pipeline.audio import save_wav, synthetic_voice

SOURCES = [synthetic_voice(21, 1.0, 16000), synthetic_voice(22, 0.6, 16000)]


@pytest.fixture(scope="module")
def target_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("voice") / "target.wav"
    save_wav(path, synthetic_voice(23, 1.2, 24000), 24000)
    return path


@pytest.fixture(scope="module")
def jax_vc_wavs(target_wav):
    from chatterbox_tpu.models.s3gen import s3gen as js
    from chatterbox_tpu.pipeline.vc import ChatterboxVC

    params = jax.tree.map(jnp.asarray, s3gen_with_conditioning()[0])
    vc = ChatterboxVC(s3gen_params=params, s3gen_cfg=J_S3GEN)
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        wavs = vc.generate_batch(SOURCES, target_voice_path=str(target_wav), seed=3)
    finally:
        js.hift_generate = real
    return vc, wavs


@pytest.fixture
def zero_port_noise(monkeypatch):
    from chatterbox_tpu_torch.models.s3gen import s3gen as ps

    monkeypatch.setattr(ps, "hift_generate", zero_vocoder_noise(ps.hift_generate, torch.zeros))


def test_vc_tokens_exact(jax_vc_wavs):
    """The masked batch of the two sources, packed through int16: the S3
    tokens equal the JAX package's."""
    from chatterbox_tpu.models.s3tokenizer import s3_tokenize as j_tokenize
    from chatterbox_tpu_torch.models.s3tokenizer import s3_tokenize
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    jvc, _ = jax_vc_wavs
    batch, n_toks, bucket = ChatterboxVC._pack_sources(SOURCES)
    j_batch, j_toks, j_bucket = jvc._pack_sources(SOURCES)
    np.testing.assert_array_equal(batch, j_batch)
    np.testing.assert_array_equal(n_toks, j_toks)
    assert bucket == j_bucket == 64 * 640 and list(n_toks) == [25, 15]
    wav16 = batch.astype(np.float32) / 32768.0
    want, _ = j_tokenize(jvc.s3gen_params["tokenizer"], J_S3GEN.tokenizer, jnp.asarray(wav16),
                         wav_lens=jnp.asarray(n_toks * 640))
    got, _ = s3_tokenize(s3gen_with_conditioning()[1]["tokenizer"], P_S3GEN.tokenizer,
                         torch.from_numpy(wav16), wav_lens=torch.from_numpy(n_toks) * 640)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layout", ["fused", "unfused"])
def test_vc_generate_batch_matches_jax(jax_vc_wavs, target_wav, zero_port_noise, layout):
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    jvc, want = jax_vc_wavs
    params = s3gen_with_conditioning()[1]
    if layout == "unfused":
        params = {**params, "flow": weights.split_unet_qkv(params["flow"])}
        assert "to_q" in params["flow"]["estimator"]["down_tf"][0]["attn"]
    vc = ChatterboxVC(params, "cpu", P_S3GEN)
    got = vc.generate_batch(SOURCES, target_voice_path=target_wav, seed=3)
    np.testing.assert_array_equal(vc.ref_dict.prompt_token.numpy(),
                                  np.asarray(jvc.ref_dict.prompt_token))
    assert len(got) == len(want) == 2
    for g, w, n in zip(got, want, (25, 15)):
        assert g.dtype == np.float32 and g.shape == w.shape == (n * 960,)
        assert np.abs(w).max() > 0.01  # > 300 int16 steps, not a few
        np.testing.assert_allclose(g, w, atol=5e-3)  # test_hifigan.py's full-inference limit
    single = vc.generate(SOURCES[1], seed=3)
    assert single.shape == (1, 15 * 960)


def test_vc_flow_steps_env_knob_and_validation(monkeypatch):
    """CHATTERBOX_FLOW_STEPS covers VC too (test_pipeline.py:277-281), and an
    invalid value fails at construction."""
    from chatterbox_tpu.pipeline.vc import ChatterboxVC as JVC
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    monkeypatch.setenv("CHATTERBOX_FLOW_STEPS", "6")
    vc = ChatterboxVC({}, "cpu", P_S3GEN)
    assert vc.s3gen_cfg.flow.n_timesteps == JVC(s3gen_params={}).s3gen_cfg.flow.n_timesteps == 6
    assert vc.s3gen_cfg.flow.estimator == P_S3GEN.flow.estimator
    for bad in ("0", "x"):
        monkeypatch.setenv("CHATTERBOX_FLOW_STEPS", bad)
        with pytest.raises(ValueError, match="CHATTERBOX_FLOW_STEPS"):
            ChatterboxVC({}, "cpu", P_S3GEN)


def test_vc_per_call_flow_steps_matches_jax(jax_vc_wavs, target_wav, zero_port_noise,
                                            monkeypatch):
    """``flow_steps=4`` for one call (test_pipeline.py:313-327): the same
    lengths, a different wav than the default tier's, within the pipeline
    limit of the JAX package's ``generate_batch(..., flow_steps=4)``; a
    value below 1 raises."""
    from chatterbox_tpu.models.s3gen import s3gen as js
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    monkeypatch.delenv("CHATTERBOX_FLOW_STEPS", raising=False)
    jvc, base = jax_vc_wavs
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        want = jvc.generate_batch(SOURCES, seed=3, flow_steps=4)
    finally:
        js.hift_generate = real
    vc = ChatterboxVC(s3gen_with_conditioning()[1], "cpu", P_S3GEN)
    got = vc.generate_batch(SOURCES, target_voice_path=target_wav, seed=3, flow_steps=4)
    assert vc.last_timings["flow_steps"] == 4
    for g, w, b in zip(got, want, base):
        assert g.shape == w.shape == b.shape and not np.array_equal(w, b)
        np.testing.assert_allclose(g, w, atol=5e-3)  # test_hifigan.py's full-inference limit
    with pytest.raises(ValueError, match="flow_steps"):
        vc.generate(SOURCES[0], seed=3, flow_steps=0)


def test_hift_bf16_env_matches_jax_vc(jax_vc_wavs, target_wav, zero_port_noise, monkeypatch):
    """``CHATTERBOX_HIFT_BF16=1`` (read at construction, as the JAX VC's
    field): the port's VC runs its vocoder trunk in bf16, as the JAX VC does
    with the flag. The two bf16 trunks round differently, so the wavs are
    held by SNR (over 20 dB, ``test_hift_bf16_trunk_against_fp32``'s bound)
    against the JAX VC's with the flag, and differ from the JAX VC's fp32
    wavs (the trunk really ran bf16)."""
    from chatterbox_tpu.models.s3gen import s3gen as js
    from chatterbox_tpu.pipeline.vc import ChatterboxVC as JVC
    from chatterbox_tpu_torch.models.s3gen import s3gen as ps
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    jvc0, fp32 = jax_vc_wavs
    monkeypatch.setenv("CHATTERBOX_HIFT_BF16", "1")
    jvc = JVC(s3gen_params=jvc0.s3gen_params, s3gen_cfg=J_S3GEN)
    assert jvc.hift_bf16
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        want = jvc.generate_batch(SOURCES, target_voice_path=str(target_wav), seed=3)
    finally:
        js.hift_generate = real
    vc = ChatterboxVC(s3gen_with_conditioning()[1], "cpu", P_S3GEN)
    assert vc.hift_bf16
    seen = []
    inner = ps.hift_generate
    monkeypatch.setattr(ps, "hift_generate", lambda *a, **kw: seen.append(kw["compute_dtype"])
                        or inner(*a, **kw))
    got = vc.generate_batch(SOURCES, target_voice_path=target_wav, seed=3)
    assert seen == [torch.bfloat16]
    for g, w, f in zip(got, want, fp32):
        assert g.shape == w.shape and np.isfinite(g).all()
        snr = 10 * np.log10(float((w.astype(np.float64) ** 2).mean())
                            / float(((g - w).astype(np.float64) ** 2).mean()))
        assert snr > 20.0, snr
        assert not np.array_equal(g, f)
