"""ChatterboxTTS: zero-shot TTS from a reference wav or from precomputed
voice conditionals.

Port of ``chatterbox_tpu/pipeline/tts.py``: ``prepare_conditionals`` turns
a reference wav into Conditionals (S3Gen's RefDict from ``embed_ref``, T3's
prompt tokens from the S3 tokenizer, the voice-encoder embedding), and
``generate_batch`` runs text -> ids -> T3 (CFG decode) -> host token
compaction -> S3Gen (flow + HiFT + trim-fade) -> spread-spectrum watermark
-> int16 PCM. Shapes are bucketed as in the JAX package (TEXT_BUCKETS,
TOKEN_BUCKETS) so both packages see the same padded batches. Entry points
run on ``cuda`` unless the caller passes ``device``; without a GPU and
without a device they raise. The conditioning modules (voice encoder,
CAMPPlus, S3 tokenizer) stay fp32 and run with TF32 off.

T3's KV cache is int8 with an exact tail at token budgets of 500 and more,
as the JAX package's auto policy has it (``_kv_quant_for``; the
``kv_quant`` argument or ``CHATTERBOX_KV_QUANT=1/0`` overrides it), and in
the working dtype otherwise. ``generate_batch(alignment=True)`` runs the
alignment watchdog, which forces the working-dtype cache.

The CFM Euler step count is the config's (10), or ``CHATTERBOX_FLOW_STEPS``
at construction, or ``flow_steps`` per call (the serving quality tier; the
T3 tokens do not change with it). ``runtime/precision.apply_tts_precision``
puts T3 in its runtime layout (fused q/k/v, int8 weights with
``CHATTERBOX_W_QUANT=1``); ``_unfuse_qkv`` restores the canonical one.

Not in this slice: streaming, batch splitting under a memory budget
(``_budget_batch_cap``), and serving.
"""

import os
import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import weights
from ..checkpoint.config_io import load_configs
from ..constants import S3_SR, S3GEN_SR, SPEECH_VOCAB_SIZE
from ..core.dsp import ve_mel_spectrogram
from ..core.resample import resample
from ..core.sampling import SamplingConfig
from ..device import full_fp32, resolve_device
from ..models.s3gen.s3gen import (RefDict, S3GenConfig, embed_ref, flow_steps_from_env,
                                  s3gen_wav, with_flow_steps)
from ..models.s3tokenizer import pad_to_token_multiple, s3_tokenize
from ..models.t3.llama import canonicalize_llama_params
from ..models.t3.t3 import T3Config, t3_generate
from ..models.tokenizer import EnTokenizer
from ..models.voice_encoder import VoiceEncoderConfig, frame_step, num_wins, ve_embed_from_mels
from ..models.watermark import SpreadSpectrumWatermarker
from .audio import load_wav, trim_silence
from .conditionals import Conditionals, T3CondData

TEXT_BUCKETS = (32, 64, 128, 256, 512)
TOKEN_BUCKETS = (64, 125, 250, 500, 750, 1000)
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}


def punc_norm(text: str) -> str:
    """Text cleanup, mirrors reference tts.py:22-61."""
    if len(text) == 0:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for old, new in [
        ("...", ", "), ("…", ", "), (":", ","), (" - ", ", "), (";", ", "),
        ("—", "-"), ("–", "-"), (" ,", ","), ("“", '"'), ("”", '"'),
        ("‘", "'"), ("’", "'"),
    ]:
        text = text.replace(old, new)
    text = text.rstrip(" ")
    if not any(text.endswith(p) for p in {".", "!", "?", "-", ","}):
        text += "."
    return text


def _bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


def _default_dtype(device: torch.device) -> torch.dtype:
    """T3 and the flow run bf16 on the card and fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def random_s3gen(cfg: S3GenConfig, seed: int, device) -> dict:
    """Seeded random S3Gen parameters on ``device``: the flow in the
    working dtype, HiFT, CAMPPlus and the S3 tokenizer in fp32."""
    return {
        "flow": weights.init_flow(cfg.flow, seed + 1, device, _default_dtype(device)),
        "hift": weights.init_hift(cfg.hift, seed + 2, device),
        "campplus": weights.init_campplus(cfg.campplus, seed + 3, device),
        "tokenizer": weights.init_s3tokenizer(cfg.tokenizer, seed + 4, device),
    }


def native_s3gen(path, device) -> dict:
    """An ``s3gen.jax.safetensors`` file -> S3Gen parameters on ``device``,
    cast as in ``random_s3gen`` (CAMPPlus and the tokenizer when present)."""
    s3 = weights.load_native(path)
    params = {"flow": weights.tree_to(s3["flow"], device, _default_dtype(device))}
    for name in ("hift", "campplus", "tokenizer"):
        if s3.get(name) is not None:
            params[name] = weights.tree_to(s3[name], device, torch.float32)
    return params


def cfm_noise(device) -> torch.Tensor:
    """The fixed CFM noise buffer (reference flow_matching.py:191), drawn
    with numpy so both packages hold the same bits."""
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 15000, 80)).astype(np.float32)
    ).to(device)


def _tile(x, b):
    """Broadcast single-voice (1, ...) conditioning to the batch."""
    return x.expand((b,) + x.shape[1:]) if x.shape[0] == 1 else x


def synthesize(s3gen_params, s3gen_cfg, noise, watermarker, speech, speech_lens, ref: RefDict,
               seed: int):
    """Speech tokens -> S3Gen (flow + HiFT + trim-fade) -> watermark ->
    (int16 wav (B, T), wav_lens (B,)). The CFM noise is the first 2*(P + T)
    frames of ``noise``; the vocoder draws from a generator seeded seed + 1."""
    b = speech.shape[0]
    ref = RefDict(*(_tile(x, b) for x in ref))
    total = 2 * (ref.prompt_token.shape[1] + speech.shape[1])
    wav, wav_lens, _ = s3gen_wav(
        s3gen_params, s3gen_cfg, speech, speech_lens, ref, noise[:, :total].expand(b, total, 80),
        generator=torch.Generator(device=speech.device).manual_seed(seed + 1),
    )
    y = watermarker.apply(wav)
    return torch.round(torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16), wav_lens


class ChatterboxTTS:
    """The TTS pipeline over parameter trees of tensors on one device."""

    ENC_COND_LEN = 6 * S3_SR  # the T3 prompt's 6 s cap (tts.py:107)
    DEC_COND_LEN = 10 * S3GEN_SR  # S3Gen's reference: 10 s (tts.py:108)

    def __init__(self, t3_params, s3gen_params, device, tokenizer: Optional[EnTokenizer] = None,
                 t3_cfg: T3Config = T3Config(), s3gen_cfg: S3GenConfig = S3GenConfig(),
                 conds: Optional[Conditionals] = None, kv_quant: Optional[bool] = None,
                 ve_params=None, ve_cfg: VoiceEncoderConfig = VoiceEncoderConfig()):
        self.device = torch.device(device)
        # int8 KV cache: True/False, or None for the auto policy of
        # _kv_quant_for; without an argument CHATTERBOX_KV_QUANT=1/0 decides
        if kv_quant is None:
            kv_quant = {"1": True, "0": False}.get(os.environ.get("CHATTERBOX_KV_QUANT", "auto"))
        self.kv_quant = kv_quant
        self.t3_params = t3_params
        self.s3gen_params = s3gen_params
        self.ve_params = ve_params
        self.tokenizer = tokenizer
        self.t3_cfg = t3_cfg
        # the CFM Euler step count: CHATTERBOX_FLOW_STEPS when set (an
        # invalid value raises here)
        self.s3gen_cfg = flow_steps_from_env(s3gen_cfg)
        self.ve_cfg = ve_cfg
        self.conds = conds
        self.sr = S3GEN_SR
        # host seconds of the last generate_batch's stages (each ends in a
        # device-to-host copy, so no extra synchronisation is needed), and
        # its compacted speech tokens, one array a text
        self.last_timings = {}
        self.last_speech_tokens = []
        self.watermarker = SpreadSpectrumWatermarker()
        self._cfm_noise = cfm_noise(self.device)

    # --------------------------------------------------------- weight layout
    @staticmethod
    def _runtime_llama_layout(t3_params) -> bool:
        """True if T3's Llama carries a runtime layout (fused q/k/v and/or
        int8 weights) rather than the canonical dense q/k/v (tts.py:165-171)."""
        layers = t3_params.get("llama", {}).get("layers", {})
        return "qkv" in layers or any(isinstance(v, dict) and "w8" in v for v in layers.values())

    def _unfuse_qkv(self):
        """Restore T3's canonical dense separate-q/k/v layout, in T3's
        working dtype, if a runtime layout is in place (tts.py:153-163)."""
        if self._runtime_llama_layout(self.t3_params):
            dtype = self.t3_params["speech_emb"]["w"].dtype
            self.t3_params = {**self.t3_params, "llama": canonicalize_llama_params(
                self.t3_params["llama"], self.t3_cfg.llama, dtype)}

    # ------------------------------------------------------------------ load
    @classmethod
    def from_random(cls, seed: int = 0, t3_cfg: T3Config = None, s3gen_cfg: S3GenConfig = None,
                    device=None, ve_cfg: VoiceEncoderConfig = None) -> "ChatterboxTTS":
        """Seeded random weights built on the device by the port's own inits
        (T3 and flow in bf16 on the card and fp32 on the CPU; HiFT and the
        conditioning modules fp32)."""
        dev = resolve_device(device)
        t3_cfg = t3_cfg or T3Config()
        s3gen_cfg = s3gen_cfg or S3GenConfig()
        ve_cfg = ve_cfg or VoiceEncoderConfig()
        return cls(weights.init_t3(t3_cfg, seed, dev, _default_dtype(dev)),
                   random_s3gen(s3gen_cfg, seed, dev), dev, t3_cfg=t3_cfg, s3gen_cfg=s3gen_cfg,
                   ve_params=weights.init_voice_encoder(ve_cfg, seed + 5, dev), ve_cfg=ve_cfg)

    @classmethod
    def from_native(cls, ckpt_dir, device=None, tokenizer_json=None) -> "ChatterboxTTS":
        """Load a directory written by the JAX package's ``save_native``
        (cast as in ``from_random``; the voice encoder from
        ``ve.jax.safetensors`` when the directory has one)."""
        dev = resolve_device(device)
        ckpt = Path(ckpt_dir)
        t3_cfg, s3gen_cfg, ve_cfg = T3Config(), S3GenConfig(), VoiceEncoderConfig()
        if (ckpt / "config.json").exists():
            t3_cfg, s3gen_cfg, ve_cfg = load_configs(ckpt / "config.json")
        t3_params = weights.tree_to(weights.load_native(ckpt / "t3.jax.safetensors"), dev,
                                    _default_dtype(dev))
        ve_params = None
        if (ckpt / "ve.jax.safetensors").exists():
            ve_params = weights.tree_to(weights.load_native(ckpt / "ve.jax.safetensors"), dev,
                                        torch.float32)
        tok_path = Path(tokenizer_json or ckpt / "tokenizer.json")
        tok = EnTokenizer(str(tok_path)) if tok_path.exists() else None
        conds = None
        if (ckpt / "conds.safetensors").exists():
            conds = Conditionals.load(ckpt / "conds.safetensors")
        return cls(t3_params, native_s3gen(ckpt / "s3gen.jax.safetensors", dev), dev, tokenizer=tok,
                   t3_cfg=t3_cfg, s3gen_cfg=s3gen_cfg, conds=conds, ve_params=ve_params,
                   ve_cfg=ve_cfg)

    # ---------------------------------------------------------- conditioning
    @torch.inference_mode()
    def prepare_conditionals(self, wav_fpath_or_array, exaggeration: float = 0.5) -> Conditionals:
        """Reference wav (a path, or a 24 kHz float array) -> Conditionals,
        as the JAX package's ``prepare_conditionals`` (tts.py:329-394):
          - S3Gen's RefDict from the first 10 s at 24 kHz (``embed_ref``);
          - T3's prompt tokens from the first 6 s at 16 kHz, at most
            ``speech_cond_prompt_len`` of them;
          - the voice-encoder embedding of the silence-trimmed 16 kHz wav,
            zero-padded to a 0.5 s bucket, averaging only the windows of the
            unpadded length.
        Both caps pad to whole 40 ms tokens. Also kept as ``self.conds``."""
        if isinstance(wav_fpath_or_array, (str, Path)):
            ref24 = load_wav(wav_fpath_or_array, S3GEN_SR)
        else:
            ref24 = np.asarray(wav_fpath_or_array, np.float32)
        dev = self.device
        with full_fp32():
            ref16 = resample(torch.from_numpy(ref24).to(dev), S3GEN_SR, S3_SR).cpu().numpy()
            dec_ref = pad_to_token_multiple(ref24[: self.DEC_COND_LEN], S3GEN_SR)
            enc_ref = pad_to_token_multiple(ref16[: self.ENC_COND_LEN])
            ve_wav = trim_silence(ref16, top_db=20)
            bucket = S3_SR // 2
            ve_padded = np.zeros(max(-(-len(ve_wav) // bucket) * bucket, bucket), np.float32)
            ve_padded[: len(ve_wav)] = ve_wav
            step = frame_step(self.ve_cfg, self.ve_cfg.default_rate)
            n_valid = num_wins(max(1 + len(ve_wav) // 160, 1), step, self.ve_cfg)  # centred frames

            ref_dict = embed_ref(self.s3gen_params, self.s3gen_cfg,
                                 torch.from_numpy(dec_ref).to(dev)[None], S3GEN_SR)
            prompt_tokens, _ = s3_tokenize(
                self.s3gen_params["tokenizer"], self.s3gen_cfg.tokenizer,
                torch.from_numpy(enc_ref).to(dev)[None], max_len=self.t3_cfg.speech_cond_prompt_len)
            mels = ve_mel_spectrogram(torch.from_numpy(ve_padded).to(dev)[None]).transpose(1, 2)
            ve_embed = ve_embed_from_mels(self.ve_params, self.ve_cfg, mels,
                                          torch.tensor([n_valid], device=dev))
        self.conds = Conditionals(
            T3CondData(ve_embed, prompt_tokens, torch.full((1,), exaggeration, device=dev)),
            ref_dict)
        return self.conds

    # ------------------------------------------------------------- generate
    def generate(self, text: str, audio_prompt_path=None, exaggeration: float = 0.5,
                 num_return_sequences: int = 1, **kw) -> np.ndarray:
        """One text -> (k, T) float32, k = ``num_return_sequences`` sampled
        variants right-padded to the longest. With ``audio_prompt_path`` the
        voice comes from ``prepare_conditionals`` on that wav; other
        keywords as generate_batch."""
        if audio_prompt_path is not None:
            kw["conds"] = self.prepare_conditionals(audio_prompt_path, exaggeration)
        wavs = self.generate_batch([text] * num_return_sequences, exaggeration=exaggeration, **kw)
        out = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
        for i, w in enumerate(wavs):
            out[i, : len(w)] = w
        return out

    @torch.inference_mode()
    def generate_batch(
        self,
        texts: List[str],
        conds: Optional[Conditionals] = None,
        repetition_penalty: float = 1.2,
        min_p: float = 0.05,
        top_p: float = 1.0,
        exaggeration: float = 0.5,
        cfg_weight: float = 0.5,
        temperature: float = 0.8,
        seed: int = 0,
        max_new_tokens: int = 1000,
        min_new_tokens: int = 0,
        greedy: bool = False,
        alignment: bool = False,
        flow_steps: Optional[int] = None,
    ) -> List[np.ndarray]:
        """One T3 decode and one S3Gen pass over the batch -> one float32
        waveform per text (int16 PCM scaled back to [-1, 1]).
        ``alignment=True`` runs the hallucination watchdog in the decode loop
        (``models/t3/alignment.py``) on a working-dtype KV cache.
        ``flow_steps`` sets the CFM Euler step count of this call only (the
        quality tier; fewer steps are faster); a value below 1 raises."""
        n_steps = self._effective_flow_steps(flow_steps)
        t_start = time.perf_counter()
        conds = conds or self.conds
        if conds is None:
            raise ValueError("no voice conditionals: pass conds or set self.conds")
        conds = conds.to(self.device)
        if bool((conds.t3.emotion_adv != exaggeration).any()):
            conds = conds.with_exaggeration(exaggeration)

        b = len(texts)
        tok_rows = [self._cap_text_row(self._encode_text(t)) for t in texts]
        lens = np.array([len(r) for r in tok_rows], np.int32)
        tmax = _bucket(int(lens.max()), TEXT_BUCKETS)
        text_tokens = np.zeros((b, tmax), np.int32)
        for i, r in enumerate(tok_rows):
            text_tokens[i, : len(r)] = r
        sampling = SamplingConfig(
            temperature=temperature, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
            min_new_tokens=min_new_tokens, greedy=greedy,
        )
        t3c = T3CondData(*(_tile(x, b) for x in conds.t3))
        cache_quant = self._kv_quant_for(max_new_tokens) and not alignment
        res = t3_generate(
            self.t3_params, self.t3_cfg, torch.from_numpy(text_tokens).to(self.device),
            torch.from_numpy(lens).to(self.device), t3c.speaker_emb, t3c.prompt_tokens,
            t3c.emotion_adv, sampling, max_new_tokens,
            generator=torch.Generator(device=self.device).manual_seed(seed),
            alignment=alignment, cache_quant=cache_quant,
        )

        # host: drop invalid tokens per row (reference tts.py:256-262)
        tokens, tok_lens = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
        t_t3 = time.perf_counter()
        clean_rows = []
        for i in range(b):
            row = tokens[i, : tok_lens[i]]
            clean_rows.append(row[row < SPEECH_VOCAB_SIZE])
        clean_lens = np.array([len(r) for r in clean_rows], np.int32)
        tbucket = _bucket(max(int(clean_lens.max()), 2), TOKEN_BUCKETS)
        speech = np.zeros((b, tbucket), np.int32)
        for i, r in enumerate(clean_rows):
            speech[i, : len(r)] = r

        wav, wav_lens = synthesize(
            self.s3gen_params, with_flow_steps(self.s3gen_cfg, n_steps), self._cfm_noise,
            self.watermarker,
            torch.from_numpy(speech).to(self.device), torch.from_numpy(clean_lens).to(self.device),
            conds.gen, seed,
        )
        marked = wav.cpu().numpy().astype(np.float32) / 32767.0
        wav_lens = wav_lens.cpu().numpy()
        kv_cache = "int8" if cache_quant else _DTYPE_NAMES[self.t3_params["speech_emb"]["w"].dtype]
        self.last_timings = {"t3_s": t_t3 - t_start, "s3gen_s": time.perf_counter() - t_t3,
                             "t3_steps": res.steps, "token_bucket": tbucket,
                             "kv_cache": kv_cache, "alignment": alignment,
                             "flow_steps": n_steps}
        self.last_speech_tokens = clean_rows
        return [marked[i, : int(wav_lens[i])] for i in range(b)]

    def _effective_flow_steps(self, flow_steps: Optional[int]) -> int:
        """The call's CFM step count: ``flow_steps``, else the pipeline's
        (tts.py:914-921). A value below 1 raises ValueError."""
        if flow_steps is None:
            return self.s3gen_cfg.flow.n_timesteps
        if flow_steps < 1:
            raise ValueError(f"flow_steps must be >= 1, got {flow_steps}")
        return int(flow_steps)

    def _kv_quant_for(self, max_new_tokens: int) -> bool:
        """Whether T3 keeps its KV cache int8 at this token budget: the
        explicit setting when there is one, else from 500 tokens on (the
        JAX package's policy, tts.py:589-596). Alignment overrides it."""
        if self.kv_quant is not None:
            return self.kv_quant
        return max_new_tokens >= 500

    # ------------------------------------------------------------- internals
    def _encode_text(self, text: str) -> np.ndarray:
        text = punc_norm(text)
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(text)
        else:  # random-weights mode: hash chars into the text vocab
            ids = [(ord(c) % 700) + 1 for c in text]
        sot, eot = self.t3_cfg.start_text_token, self.t3_cfg.stop_text_token
        return np.array([sot] + list(ids) + [eot], np.int32)

    @staticmethod
    def _cap_text_row(row: np.ndarray) -> np.ndarray:
        """Truncate an encoded row to the largest text bucket, keeping EOT."""
        cap = TEXT_BUCKETS[-1]
        if len(row) <= cap:
            return row
        return np.concatenate([row[: cap - 1], row[-1:]]).astype(np.int32)

