"""S3Gen: speech tokens + precomputed reference voice -> 24 kHz waveform.

Port of the synthesis half of ``chatterbox_tpu/models/s3gen/s3gen.py``:
flow (tokens -> mel), HiFT (mel -> wav) with masked vocoding of padded
rows, and the 20 ms trim-fade. Building a RefDict from a raw wav
(``embed_ref``) belongs to a later slice.
"""

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ...constants import S3GEN_SR
from .flow import FlowConfig, flow_inference
from .hifigan import HiFTConfig, hift_generate


@dataclass(frozen=True)
class S3GenConfig:
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=lambda: HiFTConfig(sampling_rate=S3GEN_SR))
    trim_n: int = S3GEN_SR // 50  # 20 ms fade


class RefDict(NamedTuple):
    """Precomputed reference-voice conditioning."""

    prompt_token: torch.Tensor  # (B, P) int32
    prompt_token_len: torch.Tensor  # (B,)
    prompt_feat: torch.Tensor  # (B, 2P, 80)
    embedding: torch.Tensor  # (B, 192)


def trim_fade(n: int, device) -> torch.Tensor:
    """(2n,) fade: n zeros, then a raised-cosine ramp from 0 to 1."""
    ramp = (torch.cos(torch.linspace(np.pi, 0.0, n, device=device)) + 1.0) / 2.0
    return torch.cat([torch.zeros((n,), device=device), ramp])


def s3gen_wav(p, cfg: S3GenConfig, speech_tokens, token_lens, ref: RefDict, noise_mel,
              phase_noise=None, additive_noise=None, generator=None):
    """Tokens -> (wav (B, T_wav), wav_lens (B,), source).

    noise_mel (B, >= 2*(P+T), 80) is the CFM noise; the vocoder noise is
    ``phase_noise``/``additive_noise`` or drawn from ``generator``."""
    mel, _ = flow_inference(
        p["flow"], cfg.flow, speech_tokens, token_lens, ref.prompt_token,
        ref.prompt_token_len, ref.prompt_feat, ref.embedding, noise_mel,
    )
    gen_mel = mel[:, ref.prompt_feat.shape[1]:]
    wav, source = hift_generate(
        p["hift"], cfg.hift, gen_mel, phase_noise=phase_noise, additive_noise=additive_noise,
        generator=generator, n_valid=(2 * token_lens).to(torch.int32),
    )
    n = cfg.trim_n
    wav = torch.cat([wav[:, : 2 * n] * trim_fade(n, wav.device)[None], wav[:, 2 * n:]], dim=1)
    wav_lens = (token_lens * 2 * 480).to(torch.int32)
    return wav, wav_lens, source
