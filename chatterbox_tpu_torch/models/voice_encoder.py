"""GE2E-style voice encoder: T3's speaker embedding.

Port of ``chatterbox_tpu/models/voice_encoder.py`` (reference
voice_encoder.py: a 3-layer LSTM(256), Linear(256), ReLU and L2 norm over
partial windows of 160 mel frames at rate 1.3, averaged into one utterance
embedding) on the 40-mel frontend of ``core/dsp.ve_mel_spectrogram``. fp32.
"""

from dataclasses import dataclass

import numpy as np
import torch

from ..checkpoint import torch_convert as tc
from ..core.layers import linear, lstm


@dataclass(frozen=True)
class VoiceEncoderConfig:
    num_mels: int = 40
    sample_rate: int = 16000
    speaker_embed_size: int = 256
    hidden_size: int = 256
    num_layers: int = 3
    partial_frames: int = 160
    default_rate: float = 1.3
    min_coverage: float = 0.8


def ve_forward(p, mels):
    """(N, 160, 40) partial mels -> (N, 256) L2-normed embeddings."""
    _, hs = lstm(p["lstm"], mels)
    raw = torch.relu(linear(p["proj"], hs[-1]))
    return raw / torch.linalg.norm(raw, dim=1, keepdim=True)


def frame_step(cfg: VoiceEncoderConfig, rate=None) -> int:
    """Mel frames between partial windows (voice_encoder.py:70-82)."""
    if rate is None:
        return int(np.round(cfg.partial_frames * 0.5))
    return int(np.round((cfg.sample_rate / rate) / cfg.partial_frames))


def num_wins(n_frames: int, step: int, cfg: VoiceEncoderConfig) -> int:
    """Partial windows over n_frames mel frames (voice_encoder.py:54-67)."""
    win = cfg.partial_frames
    n_wins, remainder = divmod(max(n_frames - win + step, 0), step)
    if n_wins == 0 or (remainder + (win - step)) / win >= cfg.min_coverage:
        n_wins += 1
    return n_wins


def ve_embed_from_mels(p, cfg: VoiceEncoderConfig, mels, n_valid_windows=None):
    """(B, T_mel, 40) mels -> (B, 256) utterance embeddings: windowed
    partials at rate 1.3, averaged and L2-normed. ``n_valid_windows`` (B,)
    averages only each row's first windows, so zero-padded rows keep the
    unpadded row's embedding."""
    t_mel = mels.shape[1]
    step = frame_step(cfg, cfg.default_rate)
    n = num_wins(t_mel, step, cfg)
    target = cfg.partial_frames + step * (n - 1)
    if target > t_mel:
        mels = torch.nn.functional.pad(mels, (0, 0, 0, target - t_mel))
    idx = torch.from_numpy(np.arange(n)[:, None] * step
                           + np.arange(cfg.partial_frames)[None, :]).to(mels.device)
    b = mels.shape[0]
    partials = mels[:, idx].reshape(b * n, cfg.partial_frames, cfg.num_mels)
    embeds = ve_forward(p, partials).reshape(b, n, -1)
    if n_valid_windows is None:
        raw = embeds.mean(dim=1)
    else:
        nv = n_valid_windows.to(mels.device)
        wmask = (torch.arange(n, device=mels.device)[None] < nv[:, None])[..., None]
        raw = (embeds * wmask).sum(dim=1) / nv[:, None].clamp(min=1).to(embeds.dtype)
    return raw / torch.linalg.norm(raw, dim=1, keepdim=True)


def convert_voice_encoder(sd, cfg: VoiceEncoderConfig = VoiceEncoderConfig(), prefix=""):
    """Reference ``ve.safetensors`` state dict -> the JAX package's tree
    (numpy); the LSTM leaves stay in the JAX layout, as ``lstm`` takes them."""
    return {"lstm": tc.lstm(sd, prefix + "lstm", cfg.num_layers),
            "proj": tc.linear(sd, prefix + "proj")}
