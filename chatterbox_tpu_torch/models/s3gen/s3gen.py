"""S3Gen: speech tokens + reference voice -> 24 kHz waveform.

Port of ``chatterbox_tpu/models/s3gen/s3gen.py``: ``embed_ref`` builds the
reference voice's RefDict from a raw wav (S3 tokens, 24 kHz mels, the
CAMPPlus x-vector); ``s3gen_wav`` runs the flow (tokens -> mel), HiFT (mel
-> wav) with masked vocoding of padded rows, and the 20 ms trim-fade.
``flow_steps_from_env`` reads the CFM step count's ``CHATTERBOX_FLOW_STEPS``.
"""

import os
from dataclasses import dataclass, field, replace
from typing import NamedTuple

import numpy as np
import torch

from ...constants import S3_SR, S3GEN_SR
from ...core.dsp import s3gen_mel_spectrogram
from ...core.resample import resample
from ...runtime.profiling import annotate
from ..s3tokenizer import S3TokenizerConfig, convert_s3tokenizer, s3_tokenize, s3tok_config_from_sd
from .flow import FlowConfig, convert_flow, flow_inference
from .hifigan import HiFTConfig, convert_hift, hift_generate
from .xvector import CAMPPlusConfig, campplus_embed_wav, convert_campplus


@dataclass(frozen=True)
class S3GenConfig:
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=lambda: HiFTConfig(sampling_rate=S3GEN_SR))
    campplus: CAMPPlusConfig = field(default_factory=CAMPPlusConfig)
    tokenizer: S3TokenizerConfig = field(default_factory=S3TokenizerConfig)
    trim_n: int = S3GEN_SR // 50  # 20 ms fade


def flow_steps_from_env(cfg: S3GenConfig) -> S3GenConfig:
    """``cfg`` with the CFM Euler step count of ``CHATTERBOX_FLOW_STEPS`` when
    that is set (s3gen.py:37-60); unset, ``cfg`` as it is. Both pipelines
    call it at construction; a value that is not an integer >= 1 raises."""
    n = os.environ.get("CHATTERBOX_FLOW_STEPS")
    if not n:
        return cfg
    try:
        steps = int(n)
    except ValueError:
        raise ValueError(f"CHATTERBOX_FLOW_STEPS must be an integer >= 1, got {n!r}") from None
    if steps < 1:
        raise ValueError(f"CHATTERBOX_FLOW_STEPS must be >= 1 (a zero or negative Euler step "
                         f"count degenerates the CFM solve), got {steps}")
    return with_flow_steps(cfg, steps)


def with_flow_steps(cfg: S3GenConfig, steps: int) -> S3GenConfig:
    """``cfg`` with ``steps`` CFM Euler steps."""
    if steps == cfg.flow.n_timesteps:
        return cfg
    return replace(cfg, flow=replace(cfg.flow, n_timesteps=steps))


def infer_s3gen_config(sd, cfg: S3GenConfig = None) -> S3GenConfig:
    """``cfg`` (default: S3GenConfig()) with the tokenizer's architecture read
    from the checkpoint's ``tokenizer.*`` shapes when it has them
    (``s3tok_config_from_sd``), as the JAX package's ``infer_s3gen_config``."""
    cfg = cfg or S3GenConfig()
    if any(k.startswith("tokenizer.") for k in sd):
        cfg = replace(cfg, tokenizer=s3tok_config_from_sd(sd, "tokenizer."))
    return cfg


def convert_s3gen(sd, cfg: S3GenConfig = S3GenConfig()):
    """The reference ``s3gen.safetensors`` state dict -> the JAX package's
    S3Gen tree (numpy): the flow, HiFT (``mel2wav.``), CAMPPlus
    (``speaker_encoder.``) and the S3 tokenizer (``tokenizer.``), which is
    None for a checkpoint without it, as in the JAX package."""
    p = {
        "flow": convert_flow(sd, cfg.flow, prefix="flow."),
        "hift": convert_hift(sd, cfg.hift, prefix="mel2wav."),
        "campplus": convert_campplus(sd, cfg.campplus, prefix="speaker_encoder."),
    }
    try:
        p["tokenizer"] = convert_s3tokenizer(sd, cfg.tokenizer, prefix="tokenizer.")
    except KeyError:
        p["tokenizer"] = None
    return p


class RefDict(NamedTuple):
    """Precomputed reference-voice conditioning."""

    prompt_token: torch.Tensor  # (B, P) int32
    prompt_token_len: torch.Tensor  # (B,)
    prompt_feat: torch.Tensor  # (B, 2P, 80)
    embedding: torch.Tensor  # (B, 192)


def embed_ref(p, cfg: S3GenConfig, ref_wav, ref_sr: int) -> RefDict:
    """(B, T) reference wav at ``ref_sr`` -> RefDict (s3gen.py:107-157):
    24 kHz mels, the x-vector and S3 tokens of the 16 kHz wav, with the
    tokens cut to half the mel frames and the mels to twice the tokens."""
    wav24 = ref_wav if ref_sr == S3GEN_SR else resample(ref_wav, ref_sr, S3GEN_SR)
    wav16 = resample(ref_wav, ref_sr, S3_SR)
    mels = s3gen_mel_spectrogram(wav24).transpose(1, 2)  # (B, T_mel, 80)
    xvec = campplus_embed_wav(p["campplus"], cfg.campplus, wav16)
    tokens, token_lens = s3_tokenize(p["tokenizer"], cfg.tokenizer, wav16)
    n_tok = min(mels.shape[1] // 2, tokens.shape[1])
    return RefDict(tokens[:, :n_tok], torch.clamp(token_lens, max=n_tok), mels[:, : 2 * n_tok],
                   xvec)


def trim_fade(n: int, device) -> torch.Tensor:
    """(2n,) fade: n zeros, then a raised-cosine ramp from 0 to 1."""
    ramp = (torch.cos(torch.linspace(np.pi, 0.0, n, device=device)) + 1.0) / 2.0
    return torch.cat([torch.zeros((n,), device=device), ramp])


def s3gen_wav(p, cfg: S3GenConfig, speech_tokens, token_lens, ref: RefDict, noise_mel,
              phase_noise=None, additive_noise=None, hift_dtype=None, *, generator=None):
    """Tokens -> (wav (B, T_wav), wav_lens (B,), source).

    noise_mel (B, >= 2*(P+T), 80) is the CFM noise; the vocoder noise is
    ``phase_noise``/``additive_noise`` or drawn from ``generator``;
    ``hift_dtype`` is the vocoder trunk's (``hift_decode``'s compute_dtype)."""
    mel, _ = flow_inference(
        p["flow"], cfg.flow, speech_tokens, token_lens, ref.prompt_token,
        ref.prompt_token_len, ref.prompt_feat, ref.embedding, noise_mel,
    )
    gen_mel = mel[:, ref.prompt_feat.shape[1]:]
    with annotate("s3gen.hift"):
        wav, source = hift_generate(
            p["hift"], cfg.hift, gen_mel, phase_noise=phase_noise, additive_noise=additive_noise,
            generator=generator, n_valid=(2 * token_lens).to(torch.int32),
            compute_dtype=hift_dtype,
        )
        n = cfg.trim_n
        wav = torch.cat([wav[:, : 2 * n] * trim_fade(n, wav.device)[None], wav[:, 2 * n:]],
                        dim=1)
        wav_lens = (token_lens * 2 * 480).to(torch.int32)
    return wav, wav_lens, source
