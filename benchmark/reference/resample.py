"""Windowed-sinc resampling as a strided convolution: torchaudio's
``Resample`` kernel (sinc_interp_hann, lowpass filter width 6, rolloff
0.99), the filter of every resample on the conditioning and VC paths
(24 kHz <-> 16 kHz). The kernel is built in float64 with numpy and applied
in fp32.
"""

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F


@lru_cache(maxsize=None)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: float = 6.0,
                 rolloff: float = 0.99):
    """(kernel (new_freq, 1, W), width): output phase j of each frame is the
    dot of kernel[j] with W input samples."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t = (np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    t = t * np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * win * (base_freq / orig_freq)
    return np.ascontiguousarray(kernels[:, None, :]).astype(np.float32), width


def resample(x, orig_sr: int, new_sr: int):
    """Resample a (B, T) or (T,) waveform tensor -> ceil(T * new / orig)
    samples, in fp32 on x's device."""
    if orig_sr == new_sr:
        return x
    squeeze = x.ndim == 1
    x = x.float().reshape(-1, x.shape[-1])
    frac = Fraction(orig_sr, new_sr)
    orig_freq, new_freq = frac.numerator, frac.denominator
    kern, width = _sinc_kernel(orig_freq, new_freq)
    target_len = int(math.ceil(new_freq * x.shape[1] / orig_freq))
    xp = F.pad(x[:, None], (width, width + orig_freq))
    y = F.conv1d(xp, torch.from_numpy(kern).to(x.device), stride=orig_freq)  # (B, new, frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)[:, :target_len]
    return y[0] if squeeze else y
