"""STFT / iSTFT and the three mel frontends of the conditioning path.

Port of ``chatterbox_tpu/core/dsp.py``: the STFT is a strided conv with a
windowed-DFT kernel and the iSTFT its transpose (a synthesis matmul, then
overlap-add as a transposed conv with an identity kernel). The FFT sizes
here (16 to 1920) are small, and the same matmul formulation keeps the
port's numbers next to the JAX package's. Everything runs in fp32; on the
card, run the frontends with TF32 off (``device.full_fp32``), since cuDNN
takes fp32 convolutions in TF32 by default.
"""

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    """``torch.hann_window`` / ``scipy.get_window('hann', n, fftbins=True)``;
    ``periodic=False`` is the symmetric window (denominator n - 1)."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / (n if periodic else n - 1))
            ).astype(np.float32)


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


def _reflect_pad(x, pad: int):
    """(B, T) -> (B, T + 2 pad), mirrored without repeating the edge."""
    return F.pad(x[:, None], (pad, pad), mode="reflect")[:, 0]


def stft(x, n_fft: int, hop_length: int, window, center: bool = True,
         pad_mode: str = "reflect", *, dtype=torch.float32):
    """STFT of (B, T) -> (real, imag), each (B, frames, n_fft//2+1), in
    ``dtype``.

    Matches ``torch.stft(..., win_length=n_fft, normalized=False,
    onesided=True)``; ``center=True`` reflect-pads by n_fft//2, the only
    ``pad_mode`` there is (another raises ValueError when centring)."""
    assert x.ndim == 2, f"expected (B, T), got {tuple(x.shape)}"
    if center and pad_mode != "reflect":
        raise ValueError(f"stft pads only with 'reflect', not {pad_mode!r}")
    x = x.to(dtype)
    xc = (_reflect_pad(x, n_fft // 2) if center else x)[:, None]
    kern = torch.from_numpy(_dft_kernels(n_fft, _win_key(window))).to(x.device, dtype)
    out = F.conv1d(xc, kern, stride=hop_length).transpose(1, 2)  # (B, frames, 2F)
    n_freq = n_fft // 2 + 1
    return out[..., :n_freq], out[..., n_freq:]


def istft(real, imag, n_fft: int, hop_length: int, window, center: bool = True):
    """Inverse STFT of (B, frames, F) -> (B, T). Matches ``torch.istft``;
    ``center=False`` keeps the n_fft//2 samples at each end."""
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
    if not center:
        return y
    half = n_fft // 2
    return y[:, half : y.shape[1] - half]


# ---------------------------------------------------------------------------
# librosa's (Slaney) mel filterbank and the three mel frontends
# ---------------------------------------------------------------------------

_MIN_LOG_HZ, _MIN_LOG_MEL, _LOGSTEP = 1000.0, 15.0, np.log(6.4) / 27.0


def _hz_to_mel_slaney(f):
    f = np.asarray(f, dtype=np.float64)
    with np.errstate(divide="ignore"):
        log_mel = _MIN_LOG_MEL + np.log(np.maximum(f, 1e-30) / _MIN_LOG_HZ) / _LOGSTEP
    return np.where(f >= _MIN_LOG_HZ, log_mel, 3.0 * f / 200.0)


def _mel_to_hz_slaney(m):
    m = np.asarray(m, dtype=np.float64)
    return np.where(m >= _MIN_LOG_MEL, _MIN_LOG_HZ * np.exp(_LOGSTEP * (m - _MIN_LOG_MEL)),
                    200.0 * m / 3.0)


@lru_cache(maxsize=None)
def mel_filterbank(sr: int, n_fft: int, n_mels: int, fmin: float = 0.0, fmax=None) -> np.ndarray:
    """librosa.filters.mel (htk=False, norm='slaney') -> (n_mels, 1 + n_fft//2)."""
    if fmax is None:
        fmax = sr / 2.0
    fftfreqs = np.linspace(0.0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = np.linspace(_hz_to_mel_slaney(fmin), _hz_to_mel_slaney(fmax), n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts[:, None] - fftfreqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def _mel(spec, sr, n_fft, n_mels, fmax=None):
    """(B, frames, F) spectrum -> (B, n_mels, frames) mel energies."""
    mel_w = torch.from_numpy(mel_filterbank(sr, n_fft, n_mels, 0.0, fmax)).to(spec.device,
                                                                               spec.dtype)
    return torch.matmul(mel_w, spec.transpose(1, 2))


def _stft64(y, n_fft, hop, center=True):
    return stft(y, n_fft, hop, hann_window(n_fft), center=center, dtype=torch.float64)


def s3gen_mel_spectrogram(y):
    """24 kHz target-mel frontend, (B, T) -> (B, 80, T // 480) fp32:
    n_fft 1920, hop 480, periodic hann, reflect pad (n_fft - hop)/2 on both
    sides and no centring, magnitude sqrt(re^2 + im^2 + 1e-9), Slaney mel
    0-8 kHz, log(clamp(x, 1e-5))."""
    n_fft, hop = 1920, 480
    re, im = _stft64(_reflect_pad(y.double(), (n_fft - hop) // 2), n_fft, hop, center=False)
    mag = torch.sqrt(re**2 + im**2 + 1e-9)
    return torch.log(torch.clamp(_mel(mag, 24000, n_fft, 80, 8000.0), min=1e-5)).float()


def ve_mel_spectrogram(y):
    """Voice-encoder 16 kHz frontend, (B, T) -> (B, 40, 1 + T // 160) fp32:
    n_fft 400, hop 160, centred, power |S|^2, Slaney mel 40 (0-8 kHz), no
    log."""
    re, im = _stft64(y, 400, 160)
    return _mel(re**2 + im**2, 16000, 400, 40, 8000.0).float()


def s3tok_log_mel_spectrogram(y):
    """S3-tokenizer 16 kHz frontend, (B, T) -> (B, 128, T // 160) fp32:
    n_fft 400, hop 160, centred, the last frame dropped, power, Slaney mel
    128 (0 Hz to Nyquist), log10 clamped at 1e-10, floored at each row's
    max - 8, then (x + 4) / 4."""
    re, im = _stft64(y, 400, 160)
    re, im = re[:, :-1], im[:, :-1]
    log_spec = torch.log10(torch.clamp(_mel(re**2 + im**2, 16000, 400, 128), min=1e-10))
    floor = log_spec.amax(dim=(1, 2), keepdim=True) - 8.0
    return ((torch.maximum(log_spec, floor) + 4.0) / 4.0).float()
