"""Kaldi-compatible log-mel fbank, the CAMPPlus x-vector frontend.

Port of ``chatterbox_tpu/core/fbank.py``: ``torchaudio.compliance.kaldi
.fbank(wave, num_mel_bins=80)`` with torchaudio's defaults -- 16 kHz, 25 ms
frames every 10 ms with snip_edges, DC offset removed, preemphasis 0.97
(first sample replicated), the Povey window (hann^0.85), a 512-point power
spectrum as a DFT matmul on the zero-padded frame, HTK-mel triangles from
20 Hz to Nyquist, log(max(x, eps)). fp32 throughout.
"""

from functools import lru_cache

import numpy as np
import torch

_EPS = 1.1920928955078125e-07  # float32 epsilon, torchaudio's log floor


def _povey_window(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / (n - 1))) ** 0.85


def _hz_to_htk_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


@lru_cache(maxsize=None)
def _kaldi_mel_banks(num_bins: int, n_fft: int, sr: int, low_freq: float = 20.0,
                     high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, n_fft//2 + 1); Kaldi leaves out the Nyquist bin, which
    gets a column of zeros."""
    if high_freq <= 0.0:
        high_freq = sr / 2.0 + high_freq
    mel_low, mel_high = _hz_to_htk_mel(low_freq), _hz_to_htk_mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    mel_freqs = _hz_to_htk_mel(sr / n_fft * np.arange(n_fft // 2))
    bins = np.zeros((num_bins, n_fft // 2 + 1))
    for m in range(num_bins):
        left, center, right = (mel_low + (m + i) * mel_delta for i in range(3))
        up = (mel_freqs - left) / (center - left)
        down = (right - mel_freqs) / (right - center)
        bins[m, : n_fft // 2] = np.clip(np.minimum(up, down), 0.0, None)
    return bins.astype(np.float32)


@lru_cache(maxsize=None)
def _dft_basis(frame_len: int, n_fft: int) -> np.ndarray:
    """(frame_len, 2 F): cos and sin of the n_fft-point DFT over a frame of
    frame_len samples (zero-padding == a truncated basis)."""
    n = np.arange(frame_len)[:, None]
    k = np.arange(n_fft // 2 + 1)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    return np.concatenate([np.cos(ang), np.sin(ang)], axis=1).astype(np.float32)


def kaldi_fbank(wave, num_mel_bins: int = 80, sr: int = 16000):
    """(B, T) waveform -> (B, frames, num_mel_bins) log-mel, frames =
    1 + (T - 400) // 160 at 16 kHz."""
    frame_len, frame_shift = int(0.025 * sr), int(0.010 * sr)
    n_fft = 1 << (frame_len - 1).bit_length()  # 512 for 400
    frames = wave.float().unfold(1, frame_len, frame_shift)  # (B, M, frame_len)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = (frames - 0.97 * prev) * torch.from_numpy(
        _povey_window(frame_len).astype(np.float32)).to(wave.device)
    n_freq = n_fft // 2 + 1
    spec = torch.matmul(frames, torch.from_numpy(_dft_basis(frame_len, n_fft)).to(wave.device))
    power = spec[..., :n_freq] ** 2 + spec[..., n_freq:] ** 2
    banks = torch.from_numpy(_kaldi_mel_banks(num_mel_bins, n_fft, sr)).to(wave.device)
    return torch.log(torch.clamp(torch.matmul(power, banks.t()), min=_EPS))
