"""Spread-spectrum audio watermark (the JAX package's default engine).

Port of ``SpreadSpectrumWatermarker`` from
``chatterbox_tpu/models/watermark.py``: a deterministic, weightless
multiplicative pattern on the STFT magnitudes of the 2-9 kHz band, one
orthonormal pseudo-noise row per payload bit. The neural Perth engine is not
part of this port.
"""

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from ..core import dsp


@dataclass(frozen=True)
class WatermarkConfig:
    n_fft: int = 512
    hop: int = 128
    strength: float = 0.075
    band_lo: int = 40  # bins (~1.9 kHz at 24 kHz)
    band_hi: int = 200  # bins (~9.4 kHz)
    payload_bits: int = 16
    seed: int = 0x5EED


@lru_cache(maxsize=None)
def _pn_sequence(cfg_seed: int, bits: int, band: int) -> np.ndarray:
    """One unit-RMS pattern per payload bit; rows orthonormal and orthogonal
    to the all-ones vector."""
    rng = np.random.default_rng(cfg_seed)
    g = np.concatenate([np.ones((1, band)), rng.standard_normal((bits, band))])
    q, _ = np.linalg.qr(g.T)
    return (q[:, 1 : bits + 1].T * np.sqrt(band)).astype(np.float32)


class SpreadSpectrumWatermarker:
    def __init__(self, cfg: WatermarkConfig = WatermarkConfig()):
        self.cfg = cfg

    def band_pattern(self, watermark=None) -> np.ndarray:
        """The (band,) log-magnitude modulation pattern for a payload."""
        cfg = self.cfg
        pn = _pn_sequence(cfg.seed, cfg.payload_bits, cfg.band_hi - cfg.band_lo)
        if watermark is None:
            payload = np.ones(cfg.payload_bits, np.float32)
        else:
            payload = np.asarray(watermark, np.float32) * 2 - 1
        return (payload @ pn) / np.sqrt(cfg.payload_bits)

    def apply(self, wav, pattern=None):
        """Watermark (B, T) audio on its device; returns (B, T) float32."""
        cfg = self.cfg
        if pattern is None:
            pattern = self.band_pattern()
        pattern = torch.as_tensor(pattern, dtype=torch.float32, device=wav.device)
        t_len = wav.shape[-1]
        x = F.pad(wav.float(), (0, (-t_len) % cfg.hop))
        win = dsp.hann_window(cfg.n_fft)
        re, im = dsp.stft(x, cfg.n_fft, cfg.hop, win)
        scale = torch.ones(re.shape[-1], device=wav.device)
        scale[cfg.band_lo : cfg.band_hi] = 1.0 + cfg.strength * pattern
        y = dsp.istft(re * scale, im * scale, cfg.n_fft, cfg.hop, win)
        return F.pad(y, (0, max(0, t_len - y.shape[-1])))[:, :t_len]

    def apply_watermark(self, wav, watermark=None, sample_rate: int = 24000):
        """wav (T,) or (B, T) numpy float32 -> watermarked, same shape."""
        x = torch.from_numpy(np.atleast_2d(np.asarray(wav, np.float32)))
        y = self.apply(x, self.band_pattern(watermark)).numpy()
        return y[0] if np.ndim(wav) == 1 else y

    def get_payload(self, wav, sample_rate: int = 24000):
        """Payload bits (payload_bits,) by correlating the band's log
        magnitudes with the pseudo-noise rows."""
        cfg = self.cfg
        x = torch.from_numpy(np.atleast_2d(np.asarray(wav, np.float32)))
        pn = torch.from_numpy(_pn_sequence(cfg.seed, cfg.payload_bits, cfg.band_hi - cfg.band_lo))
        re, im = dsp.stft(x, cfg.n_fft, cfg.hop, dsp.hann_window(cfg.n_fft))
        mag = torch.sqrt(re**2 + im**2 + 1e-12)
        band = torch.log(mag[..., cfg.band_lo : cfg.band_hi] + 1e-9)
        resid = band - band.mean(dim=-1, keepdim=True)
        corr = torch.einsum("btf,kf->k", resid, pn)
        return (corr > 0).to(torch.int32).numpy()

    def get_watermark(self, wav, sample_rate: int = 24000) -> float:
        """1.0 when at least 75% of the all-ones payload's bits decode."""
        return 1.0 if float(np.mean(self.get_payload(wav, sample_rate))) >= 0.75 else 0.0
