"""Streaming TTS: audio chunks come out while T3 is still decoding.

Port of ``chatterbox_tpu/pipeline/streaming.py``:

  - **T3** runs on the resumable carry (``models/t3/t3.py``
    ``t3_generate_start``/``t3_generate_resume``): a first chunk of
    ``first_chunk_tokens``, then ``chunk_tokens`` a tick. The carry holds
    the KV cache, the draws and the absolute step, so a stream's tokens are
    those of one ``t3_generate`` with the same generator, and those of
    ``generate_batch`` with the same seed.
  - **Flow**: each tick re-synthesizes the mels of a sliding window
    (``flow_ctx_tokens`` tokens of context and the new ones), always
    conditioned on the voice prompt. The CFM noise is read by absolute mel
    position from the pipeline's fixed buffer, so a frame sees the same
    noise whatever the chunking. A tick's flow sees no token after its
    chunk, and the encoder's lookahead and attention are not causal, so
    even a window over the whole history differs from one-shot synthesis
    in the chunks before the last; the default window of 75 tokens also
    cuts the left context.
  - **HiFT** vocodes ``hift_ctx_frames`` frames of context and the new
    frames; the sines continue across chunks through the cumulative-f0
    phase (``hifigan.sine_source``'s ``f0_cum_init``), and only the new
    frames are emitted.

``stream_generate_batch`` runs N streams in lockstep: one T3 chunk, one
flow window and one masked vocode over the rows a tick, with per-row
windows, f0 history and noise; rows may have different voices and finish at
different ticks. The vocoder spans of one tick share a 50-frame bucket, and
shorter rows are right-padded and vocoded masked (``n_valid``).

On the device a tick gathers the CFM noise, runs the flow, slices each
row's vocoder span, draws the additive noise and vocodes to int16 PCM; only
the PCM and the f0 come back to the host, where each row's new audio is
cut out and the first chunk's trim-fade applied. Each emitted chunk goes
back to the device for the watermark (the pipeline's engine, spread-
spectrum or neural). The loop is serial: the next T3 chunk starts after
this tick's synthesis.
"""

from dataclasses import dataclass
from typing import Iterator, List, Optional

import numpy as np
import torch

from ..core.sampling import SamplingConfig
from ..models.s3gen.flow import flow_inference
from ..models.s3gen.hifigan import hift_generate
from ..models.t3.t3 import t3_generate_resume, t3_generate_start
from .tts import CallInputs, clean_token_rows

MEL_PER_TOKEN = 2
SAMPLES_PER_FRAME = 480
# the vocoder spans of a tick are padded to a multiple of this many frames
VOC_BUCKET = 50


@dataclass(frozen=True)
class StreamConfig:
    chunk_tokens: int = 25  # 1 s of audio a tick at 25 tokens/s
    # a shorter first chunk: the first audio waits for one decode and one
    # synthesis tick, so a 10-token opening (0.4 s of audio) comes sooner
    first_chunk_tokens: int = 10
    # left-context tokens re-fed to the flow a tick (the JAX package's
    # default, chosen from its own measurements of the window's divergence)
    flow_ctx_tokens: int = 75
    hift_ctx_frames: int = 24  # mel frames of vocoder context (0.48 s)
    max_new_tokens: int = 1000
    # the tick's CFM Euler step count (None: the pipeline's)
    flow_steps: Optional[int] = None


def stream_generate(
    tts,
    text: str,
    conds=None,
    stream: StreamConfig = StreamConfig(),
    repetition_penalty: float = 1.2,
    min_p: float = 0.05,
    top_p: float = 1.0,
    exaggeration: float = 0.5,
    cfg_weight: float = 0.5,
    temperature: float = 0.8,
    seed: int = 0,
    min_new_tokens: int = 0,
) -> Iterator[np.ndarray]:
    """Yield watermarked float32 audio chunks (T,) of one utterance."""
    for chunks in stream_generate_batch(
        tts, [text], conds=conds, stream=stream, repetition_penalty=repetition_penalty,
        min_p=min_p, top_p=top_p, exaggeration=exaggeration, cfg_weight=cfg_weight,
        temperature=temperature, seed=seed, min_new_tokens=min_new_tokens,
    ):
        if chunks[0] is not None and len(chunks[0]):
            yield chunks[0]


@torch.inference_mode()
def stream_generate_batch(
    tts,
    texts: List[str],
    conds=None,
    stream: StreamConfig = StreamConfig(),
    repetition_penalty: float = 1.2,
    min_p: float = 0.05,
    top_p: float = 1.0,
    exaggeration: float = 0.5,
    cfg_weight: float = 0.5,
    temperature: float = 0.8,
    seed: int = 0,
    min_new_tokens: int = 0,
) -> Iterator[List[Optional[np.ndarray]]]:
    """Run ``len(texts)`` streams in lockstep; each tick yields one entry a
    stream: a float32 audio chunk, or None when that stream made no new
    audio this tick (it has finished, or has no new valid tokens).

    ``conds`` holds 1 row (a shared voice) or one a text
    (``Conditionals.stack``), else ValueError. T3's draws come from a
    generator seeded ``seed``, as ``generate_batch``'s; the vocoder's noise
    derives from ``seed`` and the row, so a group is not sample-identical to
    N single streams with the same seed."""
    b = len(texts)
    dev = tts.device
    tts._no_mesh("streaming")
    inp = tts.prepare_call(texts, conds, exaggeration, stream.max_new_tokens, stream.flow_steps)
    n_cond_rows = int(inp.conds.t3.speaker_emb.shape[0])
    if n_cond_rows not in (1, b):
        raise ValueError(f"conds have {n_cond_rows} rows for {b} texts (1 or one a text)")

    text_lens = torch.from_numpy(inp.text_lens).to(dev)
    sampling = SamplingConfig(
        temperature=temperature, top_p=top_p, min_p=min_p,
        repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
        min_new_tokens=min_new_tokens,
    )
    t3c = inp.t3_cond
    carry = t3_generate_start(
        tts.t3_params, tts.t3_cfg, torch.from_numpy(inp.text_tokens).to(dev), text_lens,
        t3c.speaker_emb, t3c.prompt_tokens, t3c.emotion_adv, sampling, stream.max_new_tokens,
        cache_quant=inp.cache_quant, generator=torch.Generator(device=dev).manual_seed(seed),
    )
    synth = _ChunkSynthesizer(tts, inp, stream, seed, b)
    n_emitted = [0] * b
    # the first chunk's tokens, then chunk_tokens a tick
    n = (stream.first_chunk_tokens
         if 0 < stream.first_chunk_tokens < stream.chunk_tokens else stream.chunk_tokens)
    while True:
        carry, res = t3_generate_resume(tts.t3_params, tts.t3_cfg, carry, text_lens, sampling, n)
        n = stream.chunk_tokens
        cleans = clean_token_rows(res.tokens.cpu().numpy(), res.lengths.cpu().numpy())
        finished = bool(carry.done.all()) or res.steps >= stream.max_new_tokens
        if any(len(c) > n_emitted[i] for i, c in enumerate(cleans)):
            wavs = synth.extend(cleans)
            n_emitted = [len(c) for c in cleans]
        else:
            wavs = [None] * b
        yield wavs
        if finished:
            break


def _tick_seed(seed: int, progress: int) -> int:
    """The additive-noise generator's seed of a tick: from the stream's seed
    and the tick's progress (the furthest absolute vocoder frame), so each
    tick's draw is deterministic."""
    return (((seed + 101) & 0x7FFFFFFF) << 32 | (progress & 0xFFFFFFFF)) & (2**63 - 1)


class _ChunkSynthesizer:
    """Sliding-window flow and phase-continuous chunked vocoding over N
    lockstep streams (per-row windows, f0 history and noise)."""

    def __init__(self, tts, inp: CallInputs, stream: StreamConfig, seed: int, b: int = 1):
        self.tts = tts
        self.inp = inp
        self.stream = stream
        self.seed = seed
        self.b = b
        self.dev = tts.device
        self.cfg = inp.s3gen_cfg
        h = self.cfg.hift.nb_harmonics + 1
        # row i's phases: numpy's default_rng(seed + 17 + i), as the JAX package
        self.phase_noise = torch.from_numpy(np.stack(
            [np.random.default_rng(seed + 17 + i).uniform(-np.pi, np.pi, h) for i in range(b)]
        ).astype(np.float32)).to(self.dev)
        self.f0_hist = [np.zeros((0,), np.float32) for _ in range(b)]
        self.n_done = [0] * b
        self.ref = inp.ref

    def _synth(self, tok, lens, w0s, voc_lo, n_valid, f0_cum, n_frames: int, rng_seed: int):
        """One tick on the device: the CFM noise window gathered by absolute
        mel position -> flow -> each row's vocoder span -> masked vocode ->
        int16 PCM. Returns (pcm (B, n_frames * 480) int16, f0 (B, n_frames))
        on the device."""
        tts, cfg, ref = self.tts, self.cfg, self.ref
        b, win_tok = tok.shape
        p_len = ref.prompt_token.shape[1]
        noise_full = self.inp.noise[0]  # (15000, 80)
        # row = [noise[:2P] | noise[2(P + w0) : +2 win]]; a window that would
        # run past the buffer starts earlier, as lax.dynamic_slice clamps
        gen_len = MEL_PER_TOKEN * win_tok
        lo = torch.clamp(MEL_PER_TOKEN * (p_len + w0s), max=noise_full.shape[0] - gen_len)
        gen = noise_full[lo[:, None] + torch.arange(gen_len, device=self.dev)[None]]
        head = noise_full[: MEL_PER_TOKEN * p_len].expand(b, -1, -1)
        noise = torch.cat([head, gen], dim=1)
        mel, _ = flow_inference(tts.s3gen_params["flow"], cfg.flow, tok, lens, ref.prompt_token,
                                ref.prompt_token_len, ref.prompt_feat, ref.embedding, noise)
        mel = mel[:, MEL_PER_TOKEN * p_len:]  # (B, 2 win, 80)
        # each row's span [voc_lo, voc_lo + n_frames), left-packed; the zero
        # pad keeps the slice in range (its frames are masked)
        mel = torch.nn.functional.pad(mel, (0, 0, 0, n_frames))
        idx = voc_lo[:, None] + torch.arange(n_frames, device=self.dev)[None]
        voc_mel = torch.gather(mel, 1, idx[..., None].expand(-1, -1, mel.shape[-1]))
        h = cfg.hift.nb_harmonics + 1
        add_noise = torch.randn((b, h, n_frames * SAMPLES_PER_FRAME), device=self.dev,
                                generator=torch.Generator(device=self.dev).manual_seed(rng_seed))
        wav, _, f0 = hift_generate(
            tts.s3gen_params["hift"], cfg.hift, voc_mel, phase_noise=self.phase_noise,
            additive_noise=add_noise, n_valid=n_valid, f0_cum_init=f0_cum, return_f0=True,
            compute_dtype=self.inp.hift_dtype,
        )
        pcm = torch.round(torch.clamp(wav, -1.0, 1.0) * 32767.0).to(torch.int16)
        return pcm, f0

    def extend(self, cleans: List[np.ndarray]) -> List[Optional[np.ndarray]]:
        """One lockstep tick: ``cleans[i]`` is stream i's whole clean-token
        history. Returns each stream's new audio (None where it has none)."""
        st, b = self.stream, self.b
        active = [i for i in range(b) if len(cleans[i]) > self.n_done[i]]
        if not active:
            return [None] * b

        # per-row sliding windows (host: indices only)
        w0s = [max(0, self.n_done[i] - st.flow_ctx_tokens) for i in range(b)]
        windows = [cleans[i][w0s[i]:] for i in range(b)]
        win_b = -(-max(len(windows[i]) for i in active) // st.chunk_tokens) * st.chunk_tokens
        tok = np.zeros((b, win_b), np.int32)
        lens = np.zeros((b,), np.int32)
        for i in active:
            tok[i, : len(windows[i])] = windows[i]
            lens[i] = len(windows[i])

        new_lo = [MEL_PER_TOKEN * (self.n_done[i] - w0s[i]) for i in range(b)]
        voc_hi = [MEL_PER_TOKEN * len(windows[i]) for i in range(b)]
        raw_span = [voc_hi[i] - max(0, new_lo[i] - st.hift_ctx_frames) for i in active]
        # one shared bucketed span: a longer leading context is always safe
        # (the emitted region is trimmed below); short rows vocode masked
        n_frames = -(-max(raw_span) // VOC_BUCKET) * VOC_BUCKET
        voc_lo = [max(0, voc_hi[i] - n_frames) for i in range(b)]
        n_valid = np.zeros((b,), np.int32)
        f0_cum = np.zeros((b,), np.float32)
        abs_voc_lo = [0] * b
        for i in active:
            n_valid[i] = voc_hi[i] - voc_lo[i]
            abs_voc_lo[i] = w0s[i] * MEL_PER_TOKEN + voc_lo[i]
            f0_cum[i] = (np.sum(self.f0_hist[i][: abs_voc_lo[i]]) * SAMPLES_PER_FRAME
                         / self.cfg.hift.sampling_rate)

        dev = self.dev
        pcm, f0 = self._synth(
            torch.from_numpy(tok).to(dev), torch.from_numpy(lens).to(dev),
            torch.tensor(w0s, dtype=torch.long, device=dev),
            torch.tensor(voc_lo, dtype=torch.long, device=dev),
            torch.from_numpy(n_valid).to(dev), torch.from_numpy(f0_cum).to(dev), n_frames,
            _tick_seed(self.seed, max(abs_voc_lo)),
        )
        wav = pcm.cpu().numpy().astype(np.float32) / 32767.0
        f0 = f0.cpu().numpy()

        outs: List[Optional[np.ndarray]] = [None] * b
        for i in active:
            # the f0 of frames not logged yet
            abs_frames = abs_voc_lo[i] + int(n_valid[i])
            if abs_frames > len(self.f0_hist[i]):
                self.f0_hist[i] = np.concatenate(
                    [self.f0_hist[i][: abs_voc_lo[i]], f0[i, : n_valid[i]]])[:abs_frames]
            emit_lo = (new_lo[i] - voc_lo[i]) * SAMPLES_PER_FRAME
            out = wav[i, emit_lo: int(n_valid[i]) * SAMPLES_PER_FRAME].astype(np.float32)
            if self.n_done[i] == 0:
                # the 20 ms trim-fade at the utterance's start (s3gen_wav's)
                n = self.cfg.trim_n
                fade = (np.cos(np.linspace(np.pi, 0.0, n)) + 1.0) / 2.0
                out[:n] = 0.0
                out[n: 2 * n] *= fade[: max(0, min(n, len(out) - n))]
            self.n_done[i] = len(cleans[i])
            # the watermark on the device, as in synthesize (a neural engine
            # would otherwise run on the host for every chunk)
            chunk = self.tts.watermarker.apply(torch.from_numpy(out[None]).to(self.dev))
            outs[i] = chunk[0].cpu().numpy()
        return outs
