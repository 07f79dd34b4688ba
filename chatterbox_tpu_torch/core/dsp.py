"""STFT / iSTFT as the HiFT vocoder and the watermark call them.

Port of ``chatterbox_tpu/core/dsp.py:26-166``: the STFT is a strided conv
with a windowed-DFT kernel and the iSTFT its transpose (a synthesis matmul,
then overlap-add as a transposed conv with an identity kernel). The FFT
sizes here (16 and 512) are small, and the same matmul formulation keeps the
port's numbers next to the JAX package's. Everything runs in fp32.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """The periodic window: ``torch.hann_window`` /
    ``scipy.get_window('hann', n, fftbins=True)``."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


@lru_cache(maxsize=None)
def _dft_kernels(n_fft: int, win_key) -> np.ndarray:
    """Windowed-DFT conv kernel (2F, 1, n_fft), F = n_fft//2 + 1: channel
    c<F is Re(X_c), channel F+c is Im(X_c) (``torch.stft``'s sign)."""
    window = np.asarray(win_key, dtype=np.float64)
    n_freq = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    real = np.cos(ang) * window[:, None]
    imag = -np.sin(ang) * window[:, None]
    kern = np.concatenate([real, imag], axis=1)  # (n_fft, 2F)
    return np.ascontiguousarray(kern.T[:, None, :]).astype(np.float32)


@lru_cache(maxsize=None)
def _idft_kernels(n_fft: int, win_key) -> np.ndarray:
    """Inverse-DFT frame-synthesis matrix (2F, n_fft), windowed, with the
    one-sided hermitian weights (1 at DC and Nyquist, 2 elsewhere)."""
    window = np.asarray(win_key, dtype=np.float64)
    n_freq = n_fft // 2 + 1
    k = np.arange(n_freq)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    wk = np.full((n_freq, 1), 2.0)
    wk[0] = 1.0
    if n_fft % 2 == 0:
        wk[-1] = 1.0
    real_m = wk * np.cos(ang) / n_fft
    imag_m = -wk * np.sin(ang) / n_fft
    m = np.concatenate([real_m, imag_m], axis=0) * window[None, :]
    return m.astype(np.float32)


@lru_cache(maxsize=None)
def _ola_envelope(n_fft: int, hop_length: int, frames: int, win_key) -> np.ndarray:
    """Sum of squared windows (the iSTFT normalization denominator)."""
    window = np.asarray(win_key, dtype=np.float64)
    total = (frames - 1) * hop_length + n_fft
    env = np.zeros(total)
    w2 = window**2
    for t in range(frames):
        env[t * hop_length : t * hop_length + n_fft] += w2
    return np.maximum(env, 1e-11).astype(np.float32)


def _win_key(window):
    return tuple(np.asarray(window, np.float32).tolist())


def stft(x, n_fft: int, hop_length: int, window):
    """STFT of (B, T) -> (real, imag), each (B, frames, n_fft//2+1).

    Matches ``torch.stft(..., win_length=n_fft, center=True,
    normalized=False, onesided=True)``: reflect-pads by n_fft//2."""
    assert x.ndim == 2, f"expected (B, T), got {tuple(x.shape)}"
    xc = F.pad(x.float()[:, None], (n_fft // 2, n_fft // 2), mode="reflect")
    kern = torch.from_numpy(_dft_kernels(n_fft, _win_key(window))).to(x.device)
    out = F.conv1d(xc, kern, stride=hop_length).transpose(1, 2)  # (B, frames, 2F)
    n_freq = n_fft // 2 + 1
    return out[..., :n_freq], out[..., n_freq:]


def istft(real, imag, n_fft: int, hop_length: int, window):
    """Inverse STFT of (B, frames, F) -> (B, T). Matches ``torch.istft``
    with ``center=True``."""
    b, frames, n_freq = real.shape
    assert n_freq == n_fft // 2 + 1
    key = _win_key(window)
    m = torch.from_numpy(_idft_kernels(n_fft, key)).to(real.device)
    spec = torch.cat([real, imag], dim=-1).float()  # (B, frames, 2F)
    frames_td = torch.matmul(spec, m)  # (B, frames, n_fft) windowed frames
    # overlap-add: y[t*hop + w] += frames[t, w], a transposed conv whose
    # (n_fft, 1, n_fft) identity kernel scatters channel w to offset w
    eye = torch.eye(n_fft, dtype=torch.float32, device=real.device)[:, None, :]
    y = F.conv_transpose1d(frames_td.transpose(1, 2), eye, stride=hop_length)[:, 0]
    env = torch.from_numpy(_ola_envelope(n_fft, hop_length, frames, key)).to(real.device)
    y = y / env
    half = n_fft // 2
    return y[:, half : y.shape[1] - half]
