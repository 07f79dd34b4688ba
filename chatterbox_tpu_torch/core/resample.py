"""Windowed-sinc resampling as a strided convolution.

Port of ``chatterbox_tpu/core/resample.py``. ``quality="hann"`` is
torchaudio's ``Resample`` kernel (sinc_interp_hann, lowpass filter width 6,
rolloff 0.99), the filter of every resample on the conditioning and VC
paths (24 kHz <-> 16 kHz). ``"kaiser_fast"`` and ``"kaiser_best"`` are the
resampy filter designs of those names (librosa's ``res_type``), the filter
of ``VoiceEncoder.embeds_from_wavs`` for audio that is not at 16 kHz
(``models/voice_encoder.ve_embed_from_wavs``); their taps are evaluated
from the continuous Kaiser-windowed sinc, not from resampy's interpolated
table. The kernel is built in float64 with numpy, as the JAX package builds
it, and applied in fp32.
"""

import math
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

# resampy's designs (resampy/filters.py): (num_zeros, rolloff, beta). Its
# table ``rolloff * sinc(rolloff * x) * kaiser(x, beta)`` over |x| <=
# num_zeros is the kernel below with t = rolloff * x: a clip limit of
# num_zeros * rolloff and a window argument t / limit = x / num_zeros.
_KAISER_DESIGNS = {
    "kaiser_fast": (16, 0.85, 8.555504641634386),
    "kaiser_best": (64, 0.9475, 14.769656459379492),
}


@lru_cache(maxsize=None)
def _sinc_kernel(orig_freq: int, new_freq: int, lowpass_filter_width: float = 6.0,
                 rolloff: float = 0.99, window: str = "hann", beta: float = 0.0):
    """(kernel (new_freq, 1, W), width): output phase j of each frame is the
    dot of kernel[j] with W input samples. ``window`` is "hann" or the
    continuous "kaiser" I0(beta sqrt(1 - u^2)) / I0(beta), u = t / limit."""
    base_freq = min(orig_freq, new_freq) * rolloff
    width = math.ceil(lowpass_filter_width * orig_freq / base_freq)
    idx = np.arange(-width, width + orig_freq, dtype=np.float64)[None, :] / orig_freq
    t_raw = (np.arange(0, -new_freq, -1, dtype=np.float64)[:, None] / new_freq + idx) * base_freq
    t = np.clip(t_raw, -lowpass_filter_width, lowpass_filter_width)
    if window == "hann":
        win = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    elif window == "kaiser":
        # the Kaiser window is not zero at the edge of its support, so taps
        # past it are zeroed: clipping would hold the edge's value across the
        # corners of the rectangular grid
        u = t / lowpass_filter_width
        win = np.i0(beta * np.sqrt(np.maximum(1.0 - u * u, 0.0))) / np.i0(beta)
        win = np.where(np.abs(t_raw) < lowpass_filter_width, win, 0.0)
    else:
        raise ValueError(f"unknown window {window!r}")
    t = t * np.pi
    kernels = np.where(t == 0, 1.0, np.sin(t) / np.where(t == 0, 1.0, t))
    kernels = kernels * win * (base_freq / orig_freq)
    return np.ascontiguousarray(kernels[:, None, :]).astype(np.float32), width


def resample(x, orig_sr: int, new_sr: int, quality: str = "hann"):
    """Resample a (B, T) or (T,) waveform tensor -> ceil(T * new / orig)
    samples, in fp32 on x's device. ``quality`` is "hann" (torchaudio's
    ``Resample``), "kaiser_fast" or "kaiser_best" (the resampy designs);
    another name raises ValueError."""
    if quality in _KAISER_DESIGNS:
        num_zeros, rolloff, beta = _KAISER_DESIGNS[quality]
        design = (num_zeros * rolloff, rolloff, "kaiser", beta)
    elif quality == "hann":
        design = ()
    else:
        raise ValueError(f"unknown resample quality {quality!r}")
    if orig_sr == new_sr:
        return x
    squeeze = x.ndim == 1
    x = x.float().reshape(-1, x.shape[-1])
    frac = Fraction(orig_sr, new_sr)
    orig_freq, new_freq = frac.numerator, frac.denominator
    kern, width = _sinc_kernel(orig_freq, new_freq, *design)
    target_len = int(math.ceil(new_freq * x.shape[1] / orig_freq))
    xp = F.pad(x[:, None], (width, width + orig_freq))
    y = F.conv1d(xp, torch.from_numpy(kern).to(x.device), stride=orig_freq)  # (B, new, frames)
    y = y.transpose(1, 2).reshape(x.shape[0], -1)[:, :target_len]
    return y[0] if squeeze else y
