"""The port's batch split under the card's memory and its pipelined calls
(TTS and VC), held against the JAX package's ``ChatterboxTTS``, or against
the port's own sequential calls where the JAX package's tests hold it
against its own (CPU).

The JAX side and the port get the same tiny weights and conditionals, T3
decodes greedily and the vocoder noise is zeroed on both sides, as in
``test_torch_pipeline.py``; where a test compares the port with itself it
samples, so that each chunk's seed shows in its tokens."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    J_S3GEN, J_T3, P_S3GEN, P_T3, loud_s3gen_params, ref_inputs, s3gen_with_conditioning,
    t3_params, zero_vocoder_noise,
)

from chatterbox_tpu_torch.pipeline.audio import synthetic_voice

MAX_NEW = 12
# five texts: the third alone fills the 64-token text bucket, so the chunks
# of a split (2 + 2 + 1 at a cap of 2) pad to 32, 64 and 32
TEXTS = ["Hello world.", "A short one.", "This sentence is long enough for the next bucket up.",
         "Four.", "Five is short."]
# the JAX package's budgets and caps (calibrated on a 16 GB TPU), set on
# both sides where a test compares the two formulas
JAX_LIMITS = dict(max_device_batch=64, max_pipelined_batch=32, cache_budget_bytes=7.0e9,
                  pipelined_cache_budget_bytes=3.2e9)


def _np_conds(seed, b=1):
    rng = np.random.default_rng(seed)
    return (
        (rng.standard_normal((b, 256)).astype(np.float32),
         rng.integers(0, 6561, (b, 150)).astype(np.int32),
         np.full((b,), 0.5, np.float32)),
        ref_inputs(seed, b),
    )


def _jax_conds(seed, b=1):
    from chatterbox_tpu.models.s3gen.s3gen import RefDict
    from chatterbox_tpu.pipeline.conditionals import Conditionals, T3CondData

    t3, gen = _np_conds(seed, b)
    return Conditionals(T3CondData(*map(jnp.asarray, t3)), RefDict(*map(jnp.asarray, gen)))


def _port_conds(seed, b=1):
    from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData

    t3, gen = _np_conds(seed, b)
    return Conditionals(T3CondData(*map(torch.from_numpy, t3)),
                        RefDict(*map(torch.from_numpy, gen)))


@pytest.fixture(scope="module")
def jax_tts():
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS

    return ChatterboxTTS(
        t3_params=jax.tree.map(jnp.asarray, t3_params()[0]),
        s3gen_params=jax.tree.map(jnp.asarray, loud_s3gen_params()[0]),
        ve_params={}, tokenizer=None, t3_cfg=J_T3, s3gen_cfg=J_S3GEN, conds=_jax_conds(9),
        kv_quant=False,
    )


@pytest.fixture(scope="module")
def jax_split_wavs(jax_tts):
    """The JAX pipeline's wavs at zero vocoder noise: the five texts at a
    one-shot cap of 2 (three chunks through its pipelined path), and the
    first two texts in one ``device_chain=True`` call."""
    from chatterbox_tpu.models.s3gen import s3gen as js

    real = js.hift_generate
    js.hift_generate = zero_vocoder_noise(real, jnp.zeros)
    jax_tts.max_device_batch = 2
    try:
        split = jax_tts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW, seed=7)
        chain = jax_tts.generate_batch(TEXTS[:2], greedy=True, max_new_tokens=MAX_NEW,
                                       device_chain=True)
    finally:
        js.hift_generate = real
        jax_tts.max_device_batch = 64
    return split, chain


@pytest.fixture
def zero_port_noise(monkeypatch):
    from chatterbox_tpu_torch.models.s3gen import s3gen as ps

    monkeypatch.setattr(ps, "hift_generate", zero_vocoder_noise(ps.hift_generate, torch.zeros))


def _port_tts(**limits):
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    tts = ChatterboxTTS(t3_params()[1], loud_s3gen_params()[1], "cpu", t3_cfg=P_T3,
                        s3gen_cfg=P_S3GEN, conds=_port_conds(9), kv_quant=False)
    for k, v in limits.items():
        setattr(tts, k, v)
    return tts


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape and len(g) % 960 == 0
        assert np.abs(w).max() > 0.01  # > 300 int16 steps, not a few
        # test_hifigan.py's full-inference tolerance; int16 PCM on both sides
        np.testing.assert_allclose(g, w, atol=5e-3)


def _equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------------------- caps

@pytest.mark.parametrize("kv_quant", [None, True, False])
def test_budget_batch_cap_matches_jax(kv_quant):
    """With the JAX package's budgets and hard caps set on the port, its cap
    equals the JAX one at every token budget, text bucket and int8 policy,
    one-shot and pipelined (alignment off)."""
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JaxTTS
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    jt = JaxTTS(t3_params={}, s3gen_params={}, ve_params={}, tokenizer=None, kv_quant=kv_quant)
    pt = ChatterboxTTS({}, {}, "cpu", kv_quant=kv_quant)
    for k, v in JAX_LIMITS.items():
        setattr(pt, k, v)
    assert (jt.max_device_batch, jt.max_pipelined_batch) == (64, 32)
    for max_new in (250, 500, 1000):
        for tb in (32, 64, 512):
            for pipelined in (False, True):
                assert (pt._budget_batch_cap(max_new, pipelined, tb)
                        == jt._budget_batch_cap(max_new, pipelined, text_bucket=tb)), \
                    (max_new, tb, pipelined)


@pytest.mark.parametrize("kv_quant", [None, True])
def test_budget_batch_cap_sizes_the_bf16_cache_under_alignment(kv_quant):
    """The watchdog forces the bf16 cache, so from 500 tokens (where the
    int8 cache is on) the port's cap under alignment is the bf16 one: the
    JAX cap with the int8 cache off, half its int8 cap within integer
    flooring. The JAX package sizes that cache as int8 (it has no alignment
    argument) and admits twice the rows."""
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JaxTTS
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    jt = JaxTTS(t3_params={}, s3gen_params={}, ve_params={}, tokenizer=None, kv_quant=kv_quant)
    jt_bf16 = JaxTTS(t3_params={}, s3gen_params={}, ve_params={}, tokenizer=None, kv_quant=False)
    pt = ChatterboxTTS({}, {}, "cpu", kv_quant=kv_quant)
    for k, v in dict(JAX_LIMITS, max_device_batch=10**6, max_pipelined_batch=10**6).items():
        setattr(pt, k, v)
    jt.max_device_batch = jt.max_pipelined_batch = 10**6
    jt_bf16.max_device_batch = jt_bf16.max_pipelined_batch = 10**6
    for max_new in (500, 1000):
        for tb in (32, 64, 512):
            for pipelined in (False, True):
                got = pt._budget_batch_cap(max_new, pipelined, tb, alignment=True)
                jax_int8 = jt._budget_batch_cap(max_new, pipelined, text_bucket=tb)
                assert got == jt_bf16._budget_batch_cap(max_new, pipelined, text_bucket=tb)
                assert abs(got - jax_int8 / 2) <= 1 and got < jax_int8
                # alignment off: the int8 cache, the JAX cap
                assert pt._budget_batch_cap(max_new, pipelined, tb) == jax_int8


def test_card_batch_limits():
    """Off the card nothing bounds a batch; on it the budgets are derived
    from the card's memory (``total_memory`` here a stand-in value): the
    pipelined path gets the same as the one-shot one, and the one-shot
    cache budget admits at 1000 tokens (int8) the rows whose measured peak
    fills the usable memory."""
    from unittest import mock

    from chatterbox_tpu_torch.pipeline import tts as ptts

    cfg = P_T3.llama
    hard, piped, budget, piped_budget = ptts.card_batch_limits(torch.device("cpu"), cfg, 0)
    assert budget == piped_budget == float("inf") and hard == piped and hard > 10**9
    total, resident = 80 * 2**30, 3 * 2**30

    class Props:
        total_memory = total

    with mock.patch.object(torch.cuda, "get_device_properties", return_value=Props):
        hard, piped, budget, piped_budget = ptts.card_batch_limits(torch.device("cuda"), cfg,
                                                                   resident)
    usable = (total * ptts._USABLE_SHARE - resident) / ptts._RESERVED_PER_ALLOCATED
    assert hard == int(usable // ptts._ROW_PEAK_BYTES[250]) and piped == hard
    assert piped_budget == budget
    rows = budget / ptts._cache_row_bytes(cfg, 1000, 64, 1)
    assert rows == pytest.approx(usable / ptts._ROW_PEAK_BYTES[1000])


# --------------------------------------------------------------- chunking

def test_oversized_batch_splits_as_jax(jax_split_wavs, zero_port_noise, monkeypatch):
    """Five texts at a one-shot cap of 2 split 2 + 2 + 1 (three T3
    dispatches), each chunk through the device chain at its own text
    bucket; the waveforms equal the JAX package's for the same batch."""
    from chatterbox_tpu_torch.pipeline import tts as ptts

    dispatched = []
    real = ptts.t3_generate

    def spy(p, cfg, text_tokens, *args, **kw):
        dispatched.append(tuple(text_tokens.shape))
        return real(p, cfg, text_tokens, *args, **kw)

    monkeypatch.setattr(ptts, "t3_generate", spy)
    tts = _port_tts(**dict(JAX_LIMITS, max_device_batch=2))
    got = tts.generate_batch(TEXTS, greedy=True, max_new_tokens=MAX_NEW, seed=7)
    assert dispatched == [(2, 32), (2, 64), (1, 32)]
    _close(got, jax_split_wavs[0])


def test_device_chain_matches_jax(jax_split_wavs, zero_port_noise):
    """``device_chain=True``: tokens compacted on the device, the flow at the
    full ``max_new_tokens`` width; the waveforms equal the JAX package's
    ``device_chain=True`` ones, and the tokens are not read back."""
    tts = _port_tts()
    got = tts.generate_batch(TEXTS[:2], greedy=True, max_new_tokens=MAX_NEW, device_chain=True)
    assert tts.last_timings["token_bucket"] == MAX_NEW and tts.last_speech_tokens is None
    _close(got, jax_split_wavs[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_compact_tokens_matches_jax(seed):
    """``_compact_tokens`` bit for bit against the JAX package's on seeded
    tokens (a third past the speech vocabulary) and lengths (0 to T)."""
    from chatterbox_tpu.pipeline.tts import _compact_tokens as j_compact
    from chatterbox_tpu_torch.pipeline.tts import _compact_tokens

    rng = np.random.default_rng(seed)
    b, t = 6, 40
    tokens = rng.integers(0, 6561 * 3 // 2, (b, t)).astype(np.int32)
    lengths = rng.integers(0, t + 1, b).astype(np.int32)
    lengths[:2] = (0, t)
    got = _compact_tokens(torch.from_numpy(tokens), torch.from_numpy(lengths))
    want = jax.jit(j_compact)(jnp.asarray(tokens), jnp.asarray(lengths))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------- pipelined vs sequential

def test_pipelined_batches_match_sequential():
    """``generate_batches_pipelined`` returns exactly what per-chunk
    ``generate_batch(seed=base + c, device_chain=True)`` calls return, with
    sampling on (each chunk's seed shows in its tokens)."""
    tts = _port_tts()
    texts = ["One sentence here.", "Two sentences now."]
    seq = [tts.generate_batch(texts, max_new_tokens=16, seed=5 + i, device_chain=True)
           for i in range(2)]
    assert not np.array_equal(seq[0][0], seq[1][0])
    piped = tts.generate_batches_pipelined([texts, texts], seed=5, max_new_tokens=16)
    assert len(piped) == 2
    for a, b in zip(seq, piped):
        _equal(b, a)


def test_oversized_batch_chunks_through_pipeline():
    """Above the one-shot cap the batch splits evenly and the chunks re-join
    in order: equal to per-chunk direct calls, chunk c seeded 7 + c."""
    tts = _port_tts(max_device_batch=2)
    got = tts.generate_batch(TEXTS, max_new_tokens=12, seed=7)
    ref = []
    for c, j in enumerate(range(0, 5, 2)):
        ref.extend(tts.generate_batch(TEXTS[j:j + 2], max_new_tokens=12, seed=7 + c,
                                      device_chain=True))
    _equal(got, ref)


def test_defer_collect_and_its_limit():
    """``defer_collect=True`` gives the device handle (int16 wav, lengths)
    whose ``collect`` equals the plain call; above the one-shot cap it
    raises."""
    tts = _port_tts(max_device_batch=2)
    handle = tts.generate_batch(TEXTS[:2], max_new_tokens=12, seed=3, device_chain=True,
                                defer_collect=True)
    wav, lens = handle
    assert wav.dtype == torch.int16 and tuple(lens.shape) == (2,)
    _equal(tts.collect(handle), tts.generate_batch(TEXTS[:2], max_new_tokens=12, seed=3,
                                                   device_chain=True))
    with pytest.raises(ValueError, match="defer_collect"):
        tts.generate_batch(TEXTS, max_new_tokens=12, defer_collect=True)


# ------------------------------------------------------------------ conds

def test_conditionals_rows_and_stack_match_jax():
    """``Conditionals.stack`` and ``rows`` give the JAX package's arrays;
    single-voice conds pass through ``rows``; mixed shapes raise."""
    from chatterbox_tpu.pipeline.conditionals import Conditionals as JConds
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    j = JConds.stack([_jax_conds(20 + i) for i in range(3)])
    p = Conditionals.stack([_port_conds(20 + i) for i in range(3)])
    for got, want in ((p, j), (p.rows(1, 3), j.rows(1, 3))):
        for g, w in zip((*got.t3, *got.gen), (*want.t3, *want.gen)):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert p.t3.speaker_emb.shape[0] == 3 and p.rows(1, 3).gen.embedding.shape[0] == 2
    one = _port_conds(20)
    assert one.rows(0, 2) is one and Conditionals.stack([one]) is one
    short = Conditionals(one.t3, one.gen._replace(prompt_feat=one.gen.prompt_feat[:, :4]))
    with pytest.raises(ValueError, match="mixed"):
        Conditionals.stack([one, short])


def test_chunked_batch_slices_stacked_conds():
    """Above the cap, per-row conds partition across the chunks as the
    texts do (``tests/test_batcher.py``'s case): the chunked call equals
    per-chunk direct calls on ``rows`` of the stack; a stack with another
    row count raises."""
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    stack = Conditionals.stack([_port_conds(20 + i) for i in range(4)])
    texts = [f"chunked row {i}" for i in range(4)]
    tts = _port_tts(max_device_batch=2, max_pipelined_batch=2)
    chunked = tts.generate_batch(texts, conds=stack, seed=5, max_new_tokens=12)
    direct = []
    for c in range(2):
        direct += tts.generate_batch(texts[2 * c:2 * c + 2], conds=stack.rows(2 * c, 2 * c + 2),
                                     seed=5 + c, max_new_tokens=12, device_chain=True)
    _equal(chunked, direct)
    with pytest.raises(ValueError, match="rows"):
        tts.generate_batches_pipelined([texts[:3]], conds=stack, max_new_tokens=12)


# --------------------------------------------------------------------- VC

@pytest.fixture(scope="module")
def port_vc():
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    vc = ChatterboxVC(s3gen_with_conditioning()[1], "cpu", P_S3GEN)
    vc.set_target_voice(synthetic_voice(23, 1.2, 24000))
    return vc


def test_vc_pipelined_equals_sequential(port_vc):
    """VC's ``generate_batches_pipelined`` (a packing thread one batch
    ahead) returns exactly what per-batch calls with seeds 7 + c return."""
    batches = [[synthetic_voice(30, 0.6, 16000), synthetic_voice(31, 0.4, 16000)],
               [synthetic_voice(32, 0.5, 16000)]]
    piped = port_vc.generate_batches_pipelined(batches, seed=7)
    assert [len(p) for p in piped] == [2, 1]
    for c, audios in enumerate(batches):
        _equal(piped[c], port_vc.generate_batch(audios, seed=7 + c))


def test_vc_defer_collect_equals_plain_call(port_vc):
    audios = [synthetic_voice(40, 0.5, 16000)]
    handle = port_vc.generate_batch(audios, seed=2, defer_collect=True)
    assert handle[0].dtype == torch.int16
    _equal(port_vc.collect(handle), port_vc.generate_batch(audios, seed=2))
