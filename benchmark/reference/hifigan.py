"""HiFT-GAN vocoder, plain: NSF sine source + conv trunk + iSTFT head, in
fp32 (the trunk optionally in another dtype), on one row at its own length
(reference hifigan.py HiFTGenerator with upsample 8*5*3 and iSTFT n_fft 16
/ hop 4, and f0_predictor.py ConvRNNF0Predictor). The random inputs (the
sines' initial phases, the source noise) are given by the caller.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp
from .layers import cast_tree, conv1d, conv_transpose1d, leaky_relu, linear, snake_fast


@dataclass(frozen=True)
class HiFTConfig:
    in_channels: int = 80
    base_channels: int = 512
    nb_harmonics: int = 8
    sampling_rate: int = 24000
    nsf_alpha: float = 0.1
    nsf_sigma: float = 0.003
    nsf_voiced_threshold: float = 10.0
    upsample_rates: Tuple[int, ...] = (8, 5, 3)
    upsample_kernel_sizes: Tuple[int, ...] = (16, 11, 7)
    istft_n_fft: int = 16
    istft_hop_len: int = 4
    resblock_kernel_sizes: Tuple[int, ...] = (3, 7, 11)
    resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    source_resblock_kernel_sizes: Tuple[int, ...] = (7, 7, 11)
    source_resblock_dilation_sizes: Tuple[Tuple[int, ...], ...] = ((1, 3, 5),) * 3
    lrelu_slope: float = 0.1
    audio_limit: float = 0.99
    f0_cond_channels: int = 512

    @property
    def upsample_total(self) -> int:
        return int(np.prod(self.upsample_rates)) * self.istft_hop_len  # 480

    @property
    def source_down_specs(self):
        """(kernel, stride, padding) of each source_downs conv."""
        rates = [1] + list(self.upsample_rates[::-1][:-1])
        specs = []
        for u in np.cumprod(rates)[::-1]:
            u = int(u)
            specs.append((1, 1, 0) if u == 1 else (u * 2, u, u // 2))
        return specs


def f0_predict(p, mel):
    """(B, T, 80) mel -> (B, T) f0 in Hz."""
    x = mel
    for cp in p["convs"]:
        x = F.elu(conv1d(cp, x, padding=1))
    return torch.abs(linear(p["classifier"], x)[..., 0])


def sine_source(cfg: HiFTConfig, f0_up, phase_noise, additive_noise):
    """SineGen: f0_up (B, L) at the output rate; phase_noise (B, H+1) initial
    phases (index 0 forced to 0); additive_noise (B, H+1, L) standard normal.
    Returns the per-harmonic sine+noise source (B, L, H+1)."""
    h = cfg.nb_harmonics + 1
    k = torch.arange(1, h + 1, dtype=torch.float32, device=f0_up.device)[None, :, None]
    cum = torch.cumsum(f0_up[:, None, :] * (k / cfg.sampling_rate), dim=-1)
    theta = 2.0 * np.pi * torch.remainder(cum, 1.0)
    phase = phase_noise.clone()
    phase[:, 0] = 0.0
    sines = cfg.nsf_alpha * torch.sin(theta + phase[:, :, None])
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    return (sines * uv + noise_amp * additive_noise).transpose(1, 2)


def _resblock(p, x, kernel, dilations):
    # the polynomial snake, as the program's HiFT
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alphas1"], p["alphas2"], dilations):
        xt = conv1d(c1, snake_fast(a1, x), padding=(kernel * d - d) // 2, dilation=d)
        xt = conv1d(c2, snake_fast(a2, xt), padding=(kernel - 1) // 2)
        x = xt + x
    return x


def hift_decode(p, cfg: HiFTConfig, mel, source, compute_dtype=None):
    """(B, T, 80) mel + (B, T*480) merged source -> (B, T*480) waveform.
    ``compute_dtype`` runs the conv trunk (conv_pre, the upsamples, the
    source convs and every resblock) in that dtype; the source STFT before
    it and conv_post, exp/sin and the iSTFT after it stay fp32."""
    win = dsp.hann_window(cfg.istft_n_fft)
    s_re, s_im = dsp.stft(source, cfg.istft_n_fft, cfg.istft_hop_len, win)
    s_stft = torch.cat([s_re, s_im], dim=-1)  # (B, T*120+1, 18)
    if compute_dtype is not None:
        p = {**p, **{k: cast_tree(p[k], compute_dtype)
                     for k in ("conv_pre", "ups", "source_downs", "source_resblocks",
                               "resblocks")}}
        mel, s_stft = mel.to(compute_dtype), s_stft.to(compute_dtype)
    x = conv1d(p["conv_pre"], mel, padding=3)
    num_kernels = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        x = conv_transpose1d(p["ups"][i], leaky_relu(x, cfg.lrelu_slope), stride=u,
                             padding=(k - u) // 2)
        if i == len(cfg.upsample_rates) - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)  # reflection pad (1, 0) on time
        _, ds, dpad = cfg.source_down_specs[i]
        si = conv1d(p["source_downs"][i], s_stft, stride=ds, padding=dpad)
        si = _resblock(p["source_resblocks"][i], si, cfg.source_resblock_kernel_sizes[i],
                       cfg.source_resblock_dilation_sizes[i])
        x = x + si[:, : x.shape[1]]
        xs = None
        for j in range(num_kernels):
            r = _resblock(p["resblocks"][i * num_kernels + j], x, cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilation_sizes[j])
            xs = r if xs is None else xs + r
        x = xs / num_kernels
    x = conv1d(p["conv_post"], leaky_relu(x, 0.01).float(), padding=3)
    n_freq = cfg.istft_n_fft // 2 + 1
    magnitude = torch.clamp(torch.exp(x[..., :n_freq]), max=1e2)
    phase = torch.sin(x[..., n_freq:])
    wav = dsp.istft(magnitude * torch.cos(phase), magnitude * torch.sin(phase), cfg.istft_n_fft,
                    cfg.istft_hop_len, win)
    return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)


def hift_generate(p, cfg: HiFTConfig, mel, phase_noise, additive_noise, compute_dtype=None):
    """(B, T, 80) fp32 mel, phase_noise (B, H+1), additive_noise (B, H+1,
    T*480) -> ((B, T*480) wav, (B, T*480) source). ``compute_dtype`` runs
    the conv trunk in that dtype; the f0 predictor and the sine source stay
    fp32."""
    f0 = f0_predict(p["f0_predictor"], mel)
    f0_up = torch.repeat_interleave(f0, cfg.upsample_total, dim=1)
    src_h = sine_source(cfg, f0_up, phase_noise, additive_noise)
    source = torch.tanh(linear(p["m_source_linear"], src_h))[..., 0]
    return hift_decode(p, cfg, mel, source, compute_dtype=compute_dtype), source
