"""The port's conditioning path (resampling, the three mel frontends, the
Kaldi fbank, the voice encoder, CAMPPlus, the S3 tokenizer, ``embed_ref``
and ``prepare_conditionals``), held against the JAX package on the same
tiny weights and the same seeded audio (CPU, fp32).

Limits: 1e-5 absolute on linear outputs and 1e-4 on log ones, fp32
round-off over sums of at most a few thousand terms; S3 tokens exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    J_S3GEN, J_T3, J_VE, P_S3GEN, P_T3, P_VE, assert_close, cond_params, j,
    s3gen_with_conditioning, t, t3_params, zero_vocoder_noise,
)

from chatterbox_tpu.core import dsp as jd
from chatterbox_tpu.core import fbank as jf
from chatterbox_tpu.core import layers as jl
from chatterbox_tpu.core import resample as jr
from chatterbox_tpu.models import s3tokenizer as js3
from chatterbox_tpu.models import voice_encoder as jve
from chatterbox_tpu.models.s3gen import s3gen as js
from chatterbox_tpu.models.s3gen import xvector as jx
from chatterbox_tpu_torch.core import dsp as pd
from chatterbox_tpu_torch.core import fbank as pf
from chatterbox_tpu_torch.core import layers as pl
from chatterbox_tpu_torch.core import resample as pr
from chatterbox_tpu_torch.models import s3tokenizer as ps3
from chatterbox_tpu_torch.models import voice_encoder as pve
from chatterbox_tpu_torch.models.s3gen import s3gen as ps
from chatterbox_tpu_torch.models.s3gen import xvector as px
from chatterbox_tpu_torch.pipeline.audio import save_wav, synthetic_voice

RNG = np.random.default_rng(0)


def _r(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _voice(seed, seconds, sr, gain=1.0):
    """A seeded voiced signal, (1, T) float32."""
    return (synthetic_voice(seed, seconds, sr) * gain)[None]


@pytest.fixture(scope="module")
def params():
    return cond_params()


# ---------------------------------------------------------------------------
# frontends
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orig,new", [(24000, 16000), (16000, 24000)])
def test_resample(orig, new):
    x = np.concatenate([_voice(1, 0.3, orig), _voice(2, 0.3, orig)])
    want = np.asarray(jr.resample(j(x), orig, new))
    got = pr.resample(t(x), orig, new)
    assert tuple(got.shape) == want.shape == (2, int(np.ceil(x.shape[1] * new / orig)))
    assert_close(got, want, 1e-5)
    assert_close(pr.resample(t(x[0]), orig, new), want[0], 1e-5)


def test_mel_frontends():
    """The log frontends within 1e-4; the voice encoder's power mel, whose
    values reach ~8 on this input, within 1e-5 absolute plus 1e-6 of
    itself (a few fp32 ulps)."""
    y24 = np.concatenate([_voice(3, 0.5, 24000), _voice(4, 0.5, 24000)])
    y16 = np.concatenate([_voice(5, 0.5, 16000), _voice(6, 0.5, 16000)])
    np.testing.assert_array_equal(pd.mel_filterbank(24000, 1920, 80, 0.0, 8000.0),
                                  jd.mel_filterbank(24000, 1920, 80, 0.0, 8000.0))
    got = pd.s3gen_mel_spectrogram(t(y24))
    assert tuple(got.shape) == (2, 80, y24.shape[1] // 480)
    assert_close(got, np.asarray(jd.s3gen_mel_spectrogram(j(y24))), 1e-4)
    got = pd.s3tok_log_mel_spectrogram(t(y16))
    assert tuple(got.shape) == (2, 128, y16.shape[1] // 160)
    assert_close(got, np.asarray(jd.s3tok_log_mel_spectrogram(j(y16))), 1e-4)
    got = pd.ve_mel_spectrogram(t(y16))
    want = np.asarray(jd.ve_mel_spectrogram(j(y16)))
    assert tuple(got.shape) == (2, 40, 1 + y16.shape[1] // 160) and want.max() > 1
    assert_close(got, want, 1e-5, 1e-6)


def test_kaldi_fbank():
    y = np.concatenate([_voice(7, 0.4, 16000), _voice(8, 0.4, 16000)])
    want = np.asarray(jf.kaldi_fbank(j(y)))
    got = pf.kaldi_fbank(t(y))
    assert tuple(got.shape) == want.shape == (2, 1 + (y.shape[1] - 400) // 160, 80)
    assert_close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_batch_norm_lstm():
    c = 6
    bn = {"mean": _r(c), "var": np.abs(_r(c)) + 0.5, "scale": _r(c), "bias": _r(c)}
    x = _r(2, 5, c)
    for p in (bn, {"mean": bn["mean"], "var": bn["var"]}):  # affine and affine-free
        assert_close(pl.batch_norm({k: t(v) for k, v in p.items()}, t(x)),
                     jl.batch_norm({k: j(v) for k, v in p.items()}, j(x)), 1e-5)
    layers = [{"w_ih": _r(c, 4 * 8, scale=0.4), "w_hh": _r(8, 4 * 8, scale=0.4), "b": _r(32)},
              {"w_ih": _r(8, 4 * 8, scale=0.4), "w_hh": _r(8, 4 * 8, scale=0.4), "b": _r(32)}]
    want_y, want_h = jl.lstm([{k: j(v) for k, v in lp.items()} for lp in layers], j(x))
    got_y, got_h = pl.lstm([{k: t(v) for k, v in lp.items()} for lp in layers], t(x))
    assert_close(got_y, np.asarray(want_y), 1e-5)
    for g, w in zip(got_h, want_h):
        assert_close(g, np.asarray(w), 1e-5)


@pytest.mark.parametrize("kw", [dict(padding=(5, 5)), dict(padding=(2, 4), stride=2)])
def test_grouped_conv1d(kw):
    """The FSMN's depthwise conv: JAX weight (W, 1, C) -> the port's (C, 1, W)."""
    x, w, b = _r(2, 13, 6), _r(11, 1, 6, scale=0.3), _r(6)
    want = jl.conv1d({"w": j(w), "b": j(b)}, j(x), groups=6, **kw)
    got = pl.conv1d({"w": t(w.transpose(2, 1, 0)), "b": t(b)}, t(x), groups=6, **kw)
    assert_close(got, np.asarray(want), 1e-5)


@pytest.mark.parametrize("kw", [dict(padding=1), dict(stride=(2, 1), padding=1),
                                dict(stride=(2, 1)), dict(padding=((0, 2), (1, 0)))])
def test_conv2d(kw):
    """(B, H, W, C) with JAX weight (KH, KW, Cin, Cout) -> the port's
    (Cout, Cin, KH, KW)."""
    x, w, b = _r(2, 9, 7, 3), _r(3, 3, 3, 5, scale=0.3), _r(5)
    want = jl.conv2d({"w": j(w), "b": j(b)}, j(x), **kw)
    got = pl.conv2d({"w": t(w.transpose(3, 2, 0, 1)), "b": t(b)}, t(x), **kw)
    assert tuple(got.shape) == want.shape
    assert_close(got, np.asarray(want), 1e-5)


# ---------------------------------------------------------------------------
# the voice encoder and CAMPPlus
# ---------------------------------------------------------------------------


def test_ve_embed_from_mels_masks_padded_windows(params):
    """Two rows of one padded length: the second's last window reaches into
    zero padding and is left out of its average by ``n_valid_windows``; it
    then equals its unpadded embedding."""
    jp, pp = params
    jve_p = jax.tree.map(jnp.asarray, jp["ve"])
    mels = np.abs(_r(2, 300, 40))
    mels[1, 260:] = 0.0
    nv = np.array([3, 2], np.int32)
    want = np.asarray(jve.ve_embed_from_mels(jve_p, J_VE, j(mels), n_valid_windows=j(nv)))
    got = pve.ve_embed_from_mels(pp["ve"], P_VE, t(mels), t(nv))
    assert np.isfinite(want).all() and tuple(got.shape) == (2, 256)
    assert_close(got, want, 1e-4)
    alone = pve.ve_embed_from_mels(pp["ve"], P_VE, t(mels[1:, :260]))
    assert_close(got[1], alone[0].numpy(), 1e-4)
    assert_close(pve.ve_embed_from_mels(pp["ve"], P_VE, t(mels)),
                 np.asarray(jve.ve_embed_from_mels(jve_p, J_VE, j(mels))), 1e-4)


def test_campplus_embed_wav(params):
    jp, pp = params
    wav = np.concatenate([_voice(9, 1.2, 16000), _voice(10, 1.2, 16000)])
    want = np.asarray(jax.jit(lambda p, w: jx.campplus_embed_wav(p, J_S3GEN.campplus, w))(
        jp["campplus"], j(wav)))
    got = px.campplus_embed_wav(pp["campplus"], P_S3GEN.campplus, t(wav))
    assert tuple(got.shape) == (2, 192) and np.isfinite(want).all()
    assert_close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# the S3 tokenizer
# ---------------------------------------------------------------------------


def test_s3_tokens_exact_unmasked_and_masked(params):
    """As test_s3tokenizer.py: mels straight into the encoder, without a
    mask and with a masked batch of two lengths (pad tokens 0)."""
    jp, pp = params
    encode = jax.jit(lambda p, m, n=None: js3.s3_encode_mels(p, J_S3GEN.tokenizer, m, mel_lens=n))
    jt = jp["tokenizer"]
    mels = _r(2, 96, 128)
    want, want_lens = encode(jt, j(mels))
    got, got_lens = ps3.s3_encode_mels(pp["tokenizer"], P_S3GEN.tokenizer, t(mels))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert len(np.unique(got.numpy())) > 5  # the FSQ digits vary, not a constant token
    lens = np.array([96, 57], np.int32)
    mels[1, 57:] = 0.0
    want, want_lens = encode(jt, j(mels), j(lens))
    got, got_lens = ps3.s3_encode_mels(pp["tokenizer"], P_S3GEN.tokenizer, t(mels), t(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert (got[1, 57 // 4:] == 0).all()


def test_s3_tokenize_wavs_masked_batch(params):
    """From padded 16 kHz wavs with ``wav_lens``, the VC path's call: the
    short row's tokens equal its tokens alone."""
    jp, pp = params
    wav = np.zeros((2, 16000), np.float32)
    wav[0] = _voice(11, 1.0, 16000)[0]
    wav[1, :9600] = _voice(12, 0.6, 16000)[0]
    lens = np.array([16000, 9600], np.int32)
    want, _ = jax.jit(lambda p, w, n: js3.s3_tokenize(p, J_S3GEN.tokenizer, w, wav_lens=n))(
        jp["tokenizer"], j(wav), j(lens))
    got, got_lens = ps3.s3_tokenize(pp["tokenizer"], P_S3GEN.tokenizer, t(wav), wav_lens=t(lens))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got_lens.numpy(), [25, 15])
    alone, _ = ps3.s3_tokenize(pp["tokenizer"], P_S3GEN.tokenizer, t(wav[1:, :9600]))
    np.testing.assert_array_equal(got[1, :15].numpy(), alone[0].numpy())


def test_pad_to_token_multiple_and_drop_invalid_tokens():
    for n in (0, 1, 639, 640, 1000):
        x = np.ones(n, np.float32)
        np.testing.assert_array_equal(ps3.pad_to_token_multiple(x), js3.pad_to_token_multiple(x))
        np.testing.assert_array_equal(ps3.pad_to_token_multiple(x, 24000),
                                      js3.pad_to_token_multiple(x, 24000))
    for row in ([6561, 5, 7, 6562, 9], [1, 2, 7000, 3], [4, 6562]):
        np.testing.assert_array_equal(ps3.drop_invalid_tokens(np.array(row)),
                                      js3.drop_invalid_tokens(np.array(row)))
    assert ps3.FSQ_TANH_SCALE == js3.FSQ_TANH_SCALE


# ---------------------------------------------------------------------------
# embed_ref and prepare_conditionals
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sr", [24000, 16000])
def test_embed_ref(params, sr):
    """Tokens exact; prompt_feat and the x-vector within 1e-4. At 16 kHz
    the wav goes 16k -> 24k for the mels (2:1 mel:token reconciliation)."""
    jp, pp = params
    wav = _voice(13, 1.3, sr)
    want = jax.jit(lambda p, w: js.embed_ref(p, J_S3GEN, w, sr))(jp, j(wav))
    got = ps.embed_ref(pp, P_S3GEN, t(wav), sr)
    np.testing.assert_array_equal(got.prompt_token.numpy(), np.asarray(want.prompt_token))
    np.testing.assert_array_equal(got.prompt_token_len.numpy(), np.asarray(want.prompt_token_len))
    assert got.prompt_feat.shape[1] == 2 * got.prompt_token.shape[1]
    assert_close(got.prompt_feat, np.asarray(want.prompt_feat), 1e-4)
    assert_close(got.embedding, np.asarray(want.embedding), 1e-4)


@pytest.fixture(scope="module")
def ref_wav(tmp_path_factory):
    """A 7.5 s synthetic reference WAV: longer than the T3 prompt's 6 s cap,
    with 0.5 s of silence to trim."""
    path = tmp_path_factory.mktemp("ref") / "ref.wav"
    save_wav(path, np.concatenate([np.zeros(12000, np.float32), _voice(14, 7.0, 24000)[0]]),
             24000)
    return path


@pytest.fixture(scope="module")
def both_conds(params, ref_wav):
    """prepare_conditionals of both packages on the reference WAV."""
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JTTS
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS as PTTS

    jp, pp = params
    path = ref_wav
    j_tts = JTTS(t3_params=jax.tree.map(jnp.asarray, t3_params()[0]),
                 s3gen_params=jax.tree.map(jnp.asarray, {k: jp[k] for k in ("campplus", "tokenizer")}),
                 ve_params=jax.tree.map(jnp.asarray, jp["ve"]), tokenizer=None,
                 s3gen_cfg=J_S3GEN, ve_cfg=J_VE)
    p_tts = PTTS(t3_params()[1], {k: pp[k] for k in ("campplus", "tokenizer")}, "cpu",
                 s3gen_cfg=P_S3GEN, ve_params=pp["ve"], ve_cfg=P_VE)
    return j_tts.prepare_conditionals(str(path), 0.7), p_tts.prepare_conditionals(path, 0.7), p_tts


def test_prepare_conditionals_matches_jax(both_conds):
    want, got, tts = both_conds
    assert tts.conds is got
    assert all(np.isfinite(np.asarray(x)).all() for x in (*want.t3, *want.gen))
    assert tuple(got.t3.prompt_tokens.shape) == (1, 150)
    np.testing.assert_array_equal(got.t3.prompt_tokens.numpy(), np.asarray(want.t3.prompt_tokens))
    assert_close(got.t3.speaker_emb, np.asarray(want.t3.speaker_emb), 1e-4)
    assert_close(got.t3.emotion_adv, np.asarray(want.t3.emotion_adv), 0)
    np.testing.assert_array_equal(got.gen.prompt_token.numpy(), np.asarray(want.gen.prompt_token))
    assert tuple(got.gen.prompt_feat.shape) == (1, 2 * 188, 80)  # 7.5 s: 187.5 tokens, padded
    assert_close(got.gen.prompt_feat, np.asarray(want.gen.prompt_feat), 1e-4)
    assert_close(got.gen.embedding, np.asarray(want.gen.embedding), 1e-4)


def test_prepared_conditionals_cross_load(both_conds, tmp_path):
    """The port's Conditionals.save loads in JAX's Conditionals.load, and
    the JAX package's save in the port's load, with the same dtypes."""
    from chatterbox_tpu.pipeline.conditionals import Conditionals as JConditionals
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    want, got, _ = both_conds
    got.save(tmp_path / "port.safetensors")
    back = JConditionals.load(tmp_path / "port.safetensors")
    for a, b in zip(list(got.t3) + list(got.gen), list(back.t3) + list(back.gen)):
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want.save(tmp_path / "jax.safetensors")
    mine = Conditionals.load(tmp_path / "jax.safetensors")
    for a, b in zip(list(mine.t3) + list(mine.gen), list(want.t3) + list(want.gen)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_tts_generate_from_audio_prompt_matches_jax(ref_wav, monkeypatch):
    """``generate(text, audio_prompt_path=...)``: conditionals from the wav,
    then T3 and S3Gen, greedy, against the JAX package's ``generate``, with
    the vocoder noise zeroed on both sides as test_torch_pipeline.py does."""
    from chatterbox_tpu.models.s3gen import s3gen as js
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JTTS
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    monkeypatch.setattr(ps, "hift_generate", zero_vocoder_noise(ps.hift_generate, torch.zeros))

    (jp, pp), (jc, pc) = s3gen_with_conditioning(), cond_params()
    jtts = JTTS(t3_params=jax.tree.map(jnp.asarray, t3_params()[0]),
                s3gen_params=jax.tree.map(jnp.asarray, jp),
                ve_params=jax.tree.map(jnp.asarray, jc["ve"]), tokenizer=None, t3_cfg=J_T3,
                s3gen_cfg=J_S3GEN, ve_cfg=J_VE, kv_quant=False)
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        want = jtts.generate("Hello there.", audio_prompt_path=str(ref_wav), exaggeration=0.6,
                             greedy=True, max_new_tokens=10)
    finally:
        js.hift_generate = real
    tts = ChatterboxTTS(t3_params()[1], pp, "cpu", t3_cfg=P_T3, s3gen_cfg=P_S3GEN,
                        ve_params=pc["ve"], ve_cfg=P_VE)
    got = tts.generate("Hello there.", audio_prompt_path=ref_wav, exaggeration=0.6,
                       greedy=True, max_new_tokens=10)
    assert float(tts.conds.t3.emotion_adv[0]) == pytest.approx(0.6)
    assert got.shape == want.shape and np.abs(want).max() > 0.01
    np.testing.assert_allclose(got, want, atol=5e-3)
