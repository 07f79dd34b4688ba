"""The port's streaming path, held against ``chatterbox_tpu`` on the same
weights (CPU, fp32; the JAX side runs its Pallas kernels in interpret mode):

  - T3's resumable carry: chunked decoding equals one-shot decoding (chunk
    sizes that cross the int8 cache's 8-slot tail at a prefill length that
    is not a multiple of 8), and the port's start/resume equals the JAX
    package's under its key chain's uniforms;
  - HiFT's chunked vocoding: ``f0_cum_init``/``return_f0`` against JAX, and
    two pieces against one; the bf16 trunk against the fp32 one;
  - ``stream_generate_batch`` against JAX's, tick by tick, with the vocoder
    noise zeroed on both sides and JAX's uniforms fed to the port's carry,
    and that comparison failing a port with a streaming bug planted;
    a 1-row lockstep group against ``stream_generate``; a stream's length
    against ``generate_batch``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (J_S3GEN, J_T3, P_S3GEN, P_T3, assert_close, eos_boosted_t3_params,
                          gen_inputs, j, jax_uniforms, loud_s3gen_params, ref_inputs, t,
                          t3_params, zero_vocoder_noise)

from chatterbox_tpu.core.sampling import SamplingConfig as JSampling
from chatterbox_tpu.models.s3gen import hifigan as jh
from chatterbox_tpu.models.t3 import t3 as jt
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.core.sampling import SamplingConfig as PSampling
from chatterbox_tpu_torch.models.s3gen import hifigan as ph
from chatterbox_tpu_torch.models.t3 import t3 as pt
from chatterbox_tpu_torch.models.t3.llama import QuantCache

MAX_NEW = 24


def _port_inputs():
    text, lens, spk, prompt, emo = gen_inputs()
    return t(text), t(lens), t(spk), t(prompt), t(emo)


@pytest.mark.parametrize("cache_quant", [False, True], ids=["fp32_cache", "int8_cache"])
@pytest.mark.parametrize("n", [1, 3, 8, 10])
def test_chunked_decode_equals_one_shot(cache_quant, n):
    """Sampled decoding from one generator seed, as ``t3_generate`` and as
    start + resume chunks of n steps. The prefill holds 34 + 16 + 2 = 52
    slots, so the int8 cache's groups of 8 close at steps 3, 11, 19: chunks
    end inside a group and the tail must carry over."""
    _, pp = eos_boosted_t3_params()
    text, lens, spk, prompt, emo = _port_inputs()
    samp = PSampling(cfg_weight=0.5)
    want = pt.t3_generate(pp, P_T3, text, lens, spk, prompt, emo, samp, MAX_NEW,
                          generator=torch.Generator().manual_seed(5), cache_quant=cache_quant)
    carry = pt.t3_generate_start(pp, P_T3, text, lens, spk, prompt, emo, samp, MAX_NEW,
                                 cache_quant=cache_quant,
                                 generator=torch.Generator().manual_seed(5))
    assert carry.s0 % 8 == 4
    assert isinstance(carry.cache, QuantCache if cache_quant else torch.Tensor)
    ends = []
    while True:
        i0 = carry.i
        carry, res = pt.t3_generate_resume(pp, P_T3, carry, lens, samp, n)
        ends.append(carry.i)
        assert carry.i <= min(i0 + n, MAX_NEW)
        if bool(carry.done.all()) or res.steps >= MAX_NEW:
            break
    # every chunk that did not finish the rows stopped at exactly i + n
    assert all(e == min((k + 1) * n, MAX_NEW) for k, e in enumerate(ends[:-1]))
    np.testing.assert_array_equal(res.tokens.numpy(), want.tokens.numpy())
    np.testing.assert_array_equal(res.lengths.numpy(), want.lengths.numpy())
    assert res.steps == want.steps
    assert len(set(want.lengths.tolist())) > 1  # rows stop at different steps


@pytest.mark.parametrize("cache_quant", [False, True], ids=["fp32_cache", "int8_cache"])
def test_start_resume_matches_jax(cache_quant):
    """JAX's ``t3_generate_start`` and ``t3_generate_resume`` in chunks of 5
    from ``PRNGKey(seed)``, against the port's with that key chain's
    uniforms in the carry: tokens, lengths and steps after every chunk."""
    jp, pp = eos_boosted_t3_params()
    text, lens, spk, prompt, emo = gen_inputs()
    seed, n = 11, 5
    jsamp, psamp = JSampling(cfg_weight=0.5), PSampling(cfg_weight=0.5)
    jparams = jax.tree.map(jnp.asarray, jp)
    jcarry = jt.t3_generate_start(jparams, J_T3, j(text), j(lens), j(spk), j(prompt), j(emo),
                                  jax.random.PRNGKey(seed), jsamp, MAX_NEW,
                                  cache_quant=cache_quant)
    pcarry = pt.t3_generate_start(pp, P_T3, t(text), t(lens), t(spk), t(prompt), t(emo), psamp,
                                  MAX_NEW, cache_quant=cache_quant,
                                  uniforms=t(jax_uniforms(seed, MAX_NEW, len(lens))))
    step = jax.jit(lambda c: jt.t3_generate_resume(jparams, J_T3, c, j(lens), jsamp, n))
    while True:
        jcarry, want = step(jcarry)
        pcarry, got = pt.t3_generate_resume(pp, P_T3, pcarry, t(lens), psamp, n)
        np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
        np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
        assert got.steps == int(want.steps)
        np.testing.assert_array_equal(pcarry.done.numpy(), np.asarray(jcarry.done))
        if bool(np.asarray(jcarry.done).all()) or int(want.steps) >= MAX_NEW:
            break
    assert int(want.steps) > n  # more than one chunk ran


def _mel(seed, b, t_mel):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t_mel, 80)) * 0.5 - 4.0).astype(np.float32)


def voiced_s3gen_params():
    """``loud_s3gen_params`` with the f0 predictor's classifier 60x: the
    random predictor gives a few Hz, below the 10 Hz voicing threshold, so
    the sines (and their phase) would never sound; 60x puts f0 near 150 Hz."""
    jp, _ = loud_s3gen_params()
    f0p = dict(jp["hift"]["f0_predictor"])
    f0p["classifier"] = {k: v * 60.0 for k, v in f0p["classifier"].items()}
    jp = {**jp, "hift": {**jp["hift"], "f0_predictor": f0p}}
    return jp, weights.from_jax_tree(jp)


@pytest.fixture(scope="module")
def hift_params():
    jp, pp = voiced_s3gen_params()
    return jax.tree.map(jnp.asarray, jp["hift"]), pp["hift"]


def test_hift_f0_cum_and_return_f0_match_jax(hift_params):
    """A phase offset of 0.37 and 12.81 cycles, with injected noise and
    ``n_valid``, on a voiced f0 near 150 Hz: the wav at
    ``test_torch_s3gen.py``'s tolerance (2e-3). The f0 (60x a random
    predictor's output) at 1e-4 relative, and the source at 5e-4: the ninth
    harmonic's phase is a fp32 cumulative sum of ~900 cycles over the 0.48 s,
    whose ulp is ~6e-5 of a cycle, and the two packages sum in other orders."""
    jp, pp = hift_params
    cfg_j, cfg_p = J_S3GEN.hift, P_S3GEN.hift
    mel, n_valid = _mel(4, 2, 24), np.array([24, 17], np.int32)
    rng = np.random.default_rng(5)
    h = cfg_j.nb_harmonics + 1
    phase = rng.uniform(-np.pi, np.pi, (2, h)).astype(np.float32)
    add = rng.standard_normal((2, h, 24 * 480)).astype(np.float32)
    cum = np.array([0.37, 12.81], np.float32)
    w_wav, w_src, w_f0 = jh.hift_generate(jp, cfg_j, j(mel), phase_noise=j(phase),
                                          additive_noise=j(add), f0_cum_init=j(cum),
                                          return_f0=True, n_valid=j(n_valid))
    g_wav, g_src, g_f0 = ph.hift_generate(pp, cfg_p, t(mel), phase_noise=t(phase),
                                          additive_noise=t(add), f0_cum_init=t(cum),
                                          return_f0=True, n_valid=t(n_valid))
    assert min(float(g_f0[0].min()), float(g_f0[1, :17].min())) > 10.0  # voiced
    assert_close(g_f0, np.asarray(w_f0), 1e-3, 1e-4)
    assert_close(g_src, np.asarray(w_src), 5e-4)
    assert_close(g_wav, np.asarray(w_wav), 2e-3)
    # the offset moves the source: it is not ignored
    plain_src = ph.hift_generate(pp, cfg_p, t(mel), phase_noise=t(phase), additive_noise=t(add),
                                 n_valid=t(n_valid))[1]
    assert float((plain_src - g_src).abs().max()) > 1e-2


def test_hift_two_pieces_reproduce_one_shot(hift_params):
    """The port's version of ``test_hift_chunked_sine_phase_continuity``:
    a mel vocoded in one piece and in two, the second starting at frame k
    with ctx frames of context and the f0 integral before them as
    ``f0_cum_init``; away from the window's edge the pieces agree. The f0
    predictor is set to a constant 151.3 Hz (classifier weight 0, bias
    151.3), so that the sines sound and the f0 of the context frames has no
    edge effects of its own: the phase carried over is then all that keeps
    the pieces together (36.312 cycles before frame k - ctx)."""
    _, pp = hift_params
    cfg = P_S3GEN.hift
    cls = pp["f0_predictor"]["classifier"]
    pp = {**pp, "f0_predictor": {**pp["f0_predictor"], "classifier": {
        "w": torch.zeros_like(cls["w"]), "b": torch.full_like(cls["b"], 151.3)}}}
    t_mel, k, ctx = 48, 24, 12
    mel = t(_mel(0, 1, t_mel))
    h, ups = cfg.nb_harmonics + 1, cfg.upsample_total
    phase = torch.zeros((1, h))
    full, _, f0 = ph.hift_generate(pp, cfg, mel, phase_noise=phase,
                                   additive_noise=torch.zeros((1, h, t_mel * ups)), return_f0=True)
    cum = torch.tensor([float(np.sum(f0[0, : k - ctx].numpy())) * ups / cfg.sampling_rate])

    def second_piece(f0_cum_init):
        chunk, _ = ph.hift_generate(pp, cfg, mel[:, k - ctx:], phase_noise=phase,
                                    additive_noise=torch.zeros((1, h, (t_mel - k + ctx) * ups)),
                                    f0_cum_init=f0_cum_init)
        return chunk[0, ctx * ups:].numpy()

    got, want = second_piece(cum), full[0, k * ups:].numpy()
    lo, hi = int(0.2 * len(got)), int(0.8 * len(got))
    err = np.abs(got[lo:hi] - want[lo:hi]).max()
    ref = np.abs(want[lo:hi]).max() + 1e-6
    assert err / ref < 0.05, (err, ref)
    # without the phase carried over, the second piece's sines restart
    assert np.abs(second_piece(None)[lo:hi] - want[lo:hi]).max() / ref > 0.2


def test_hift_bf16_trunk_against_fp32(hift_params):
    """``compute_dtype=torch.bfloat16`` runs the conv trunk in bf16: the
    output stays close to the fp32 vocoder (SNR over 20 dB on these random
    weights) and differs from it (the trunk really ran bf16); f0 and the
    source, computed before the trunk, are unchanged."""
    _, pp = hift_params
    cfg = P_S3GEN.hift
    mel, n_valid = t(_mel(6, 2, 24)), torch.tensor([24, 19], dtype=torch.int32)
    h = cfg.nb_harmonics + 1
    kw = dict(phase_noise=torch.zeros((2, h)), additive_noise=torch.zeros((2, h, 24 * 480)),
              n_valid=n_valid, return_f0=True)
    w32, s32, f32 = ph.hift_generate(pp, cfg, mel, **kw)
    w16, s16, f16 = ph.hift_generate(pp, cfg, mel, compute_dtype=torch.bfloat16, **kw)
    assert w16.dtype == torch.float32 and torch.isfinite(w16).all()
    assert torch.equal(s16, s32) and torch.equal(f16, f32)
    d = (w16 - w32).double()
    snr = 10 * np.log10(float((w32.double() ** 2).mean()) / float((d ** 2).mean()))
    assert 20.0 < snr < 200.0, snr


# ---------------------------------------------------------------------------
# the pipeline's streams
# ---------------------------------------------------------------------------

STREAM = dict(chunk_tokens=6, first_chunk_tokens=3, flow_ctx_tokens=6, hift_ctx_frames=8,
              max_new_tokens=18)
TEXTS = ["First speaker line.", "A different, longer second line."]
SEED = 5


def _conds_np():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((1, 256)).astype(np.float32),
            rng.integers(0, 6561, (1, 150)).astype(np.int32), np.full((1,), 0.5, np.float32),
            ref_inputs(10))


@pytest.fixture(scope="module")
def jax_streams():
    """JAX's ``stream_generate_batch`` over TEXTS, every tick's entries, with
    the vocoder's phase and additive noise zeroed."""
    from chatterbox_tpu.models.s3gen.s3gen import RefDict
    from chatterbox_tpu.pipeline import streaming as js
    from chatterbox_tpu.pipeline.conditionals import Conditionals, T3CondData
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS

    spk, prompt, emo, ref = _conds_np()
    conds = Conditionals(T3CondData(spk, prompt, emo), RefDict(*ref))
    tts = ChatterboxTTS(
        t3_params=jax.tree.map(jnp.asarray, t3_params()[0]),
        s3gen_params=jax.tree.map(jnp.asarray, voiced_s3gen_params()[0]),
        ve_params={}, tokenizer=None, t3_cfg=J_T3, s3gen_cfg=J_S3GEN,
        conds=jax.tree.map(jnp.asarray, conds), kv_quant=False,
    )
    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    try:
        return list(js.stream_generate_batch(tts, TEXTS, stream=js.StreamConfig(**STREAM),
                                             seed=SEED))
    finally:
        js.hift_generate = real


def _port_tts():
    from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    spk, prompt, emo, ref = _conds_np()
    conds = Conditionals(T3CondData(t(spk), t(prompt), t(emo)), RefDict(*map(t, ref)))
    return ChatterboxTTS(t3_params()[1], voiced_s3gen_params()[1], "cpu", t3_cfg=P_T3,
                         s3gen_cfg=P_S3GEN, conds=conds, kv_quant=False)


# a chunk's error rms against its rms: the port sits near 1e-3 (int16
# rounding on both sides); a wrong phase carry, noise window or vocoder span
# puts every chunk it touches near 0.9
STREAM_REL_RMS = 1e-2


def _port_streams(monkeypatch, fault=None):
    """The port's ``stream_generate_batch`` over TEXTS as ``jax_streams``
    runs JAX's: the vocoder noise zeroed, JAX's uniforms injected at
    ``t3_generate_start``. ``fault`` plants one streaming bug: ``f0_phase``
    drops the carried phase (``f0_cum_init``), ``noise_window`` reads the
    CFM noise by the window's relative position, ``vocoder_span`` shifts
    each row's vocoder span by one frame."""
    from chatterbox_tpu_torch.pipeline import streaming as ps

    real_start = ps.t3_generate_start
    uniforms = t(jax_uniforms(SEED, STREAM["max_new_tokens"], len(TEXTS)))

    def start(*a, **kw):
        kw.pop("generator")
        return real_start(*a, uniforms=uniforms, **kw)

    monkeypatch.setattr(ps, "t3_generate_start", start)
    hift = zero_vocoder_noise(ps.hift_generate, torch.zeros)
    if fault == "f0_phase":
        quiet = hift

        def hift(p, cfg, mel, **kw):
            return quiet(p, cfg, mel, **{**kw, "f0_cum_init": torch.zeros_like(kw["f0_cum_init"])})
    monkeypatch.setattr(ps, "hift_generate", hift)
    real_synth = ps._ChunkSynthesizer._synth
    if fault == "noise_window":
        monkeypatch.setattr(ps._ChunkSynthesizer, "_synth",
                            lambda self, tok, lens, w0s, *a: real_synth(
                                self, tok, lens, torch.zeros_like(w0s), *a))
    elif fault == "vocoder_span":
        monkeypatch.setattr(ps._ChunkSynthesizer, "_synth",
                            lambda self, tok, lens, w0s, voc_lo, *a: real_synth(
                                self, tok, lens, w0s, voc_lo + 1, *a))
    return list(ps.stream_generate_batch(_port_tts(), TEXTS, stream=ps.StreamConfig(**STREAM),
                                         seed=SEED))


def _assert_streams_match(got, want):
    """Tick by tick: the same None pattern, and each chunk at
    ``test_torch_pipeline.py``'s tolerance (int16 PCM on both sides, the
    watermark on) and within ``STREAM_REL_RMS`` of its own rms. Returns each
    chunk's relative error rms."""
    assert len(got) == len(want) >= 3
    rel = []
    for k, (g_tick, w_tick) in enumerate(zip(got, want)):
        assert [c is None for c in g_tick] == [c is None for c in w_tick], k
        for g, w in zip(g_tick, w_tick):
            if w is None:
                continue
            assert g.dtype == np.float32 and g.shape == w.shape and len(g) % 960 == 0
            w64 = w.astype(np.float64)
            rel.append(float(np.sqrt(np.mean((g - w64) ** 2) / np.mean(w64 ** 2))))
            np.testing.assert_allclose(g, w, atol=5e-3)
            assert rel[-1] < STREAM_REL_RMS, (k, rel[-1])
    return rel


def test_stream_generate_batch_matches_jax(jax_streams, monkeypatch):
    """The port's streams against JAX's (``_assert_streams_match``) over
    every chunk, on waveforms that peak well above int16 rounding."""
    rel = _assert_streams_match(_port_streams(monkeypatch), jax_streams)
    assert len(rel) >= 4
    assert np.abs(np.concatenate([c for tick in jax_streams for c in tick
                                  if c is not None])).max() > 0.01


@pytest.mark.parametrize("fault", ["f0_phase", "noise_window", "vocoder_span"])
def test_stream_comparison_fails_a_planted_fault(jax_streams, monkeypatch, fault):
    """The comparison above fails a port with one streaming bug planted: a
    chunk that bug reaches is far outside the relative bound."""
    got = _port_streams(monkeypatch, fault)
    with pytest.raises(AssertionError):
        _assert_streams_match(got, jax_streams)
    rel = [float(np.sqrt(np.mean((g - w.astype(np.float64)) ** 2) /
                         np.mean(w.astype(np.float64) ** 2)))
           for g_tick, w_tick in zip(got, jax_streams) for g, w in zip(g_tick, w_tick)
           if w is not None and g is not None and g.shape == w.shape]
    assert max(rel) > 10 * STREAM_REL_RMS, rel


def test_lockstep_single_row_equals_stream_generate():
    from chatterbox_tpu_torch.pipeline.streaming import (StreamConfig, stream_generate,
                                                         stream_generate_batch)

    tts = _port_tts()
    st = StreamConfig(**{**STREAM, "max_new_tokens": 12})
    kw = dict(seed=4, min_new_tokens=11)
    a = list(stream_generate(tts, "Lockstep one.", stream=st, **kw))
    b = [c[0] for c in stream_generate_batch(tts, ["Lockstep one."], stream=st, **kw)
         if c[0] is not None and len(c[0])]
    assert len(a) == len(b) >= 2
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_stream_length_equals_generate_batch():
    """The stream's tokens are ``generate_batch``'s for the same seed (the
    carry holds the generator), so the samples add up to its wav's."""
    from chatterbox_tpu_torch.pipeline.streaming import StreamConfig, stream_generate

    tts = _port_tts()
    st = StreamConfig(chunk_tokens=5, flow_ctx_tokens=1000, hift_ctx_frames=64,
                      max_new_tokens=15)
    kw = dict(seed=7, min_new_tokens=14)
    streamed = np.concatenate(list(stream_generate(tts, "Compare lengths here.", stream=st,
                                                   **kw)))
    wav = tts.generate_batch(["Compare lengths here."], max_new_tokens=15, **kw)[0]
    assert len(streamed) == len(wav) > 0 and np.isfinite(streamed).all()
