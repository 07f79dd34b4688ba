"""HiFT-GAN vocoder: NSF sine source + conv trunk + iSTFT head, in fp32
(the trunk optionally bf16).

Port of ``chatterbox_tpu/models/s3gen/hifigan.py`` (reference hifigan.py
HiFTGenerator with upsample 8*5*3 and iSTFT n_fft 16 / hop 4, and
f0_predictor.py ConvRNNF0Predictor). The random inputs (sine phases, source
noise) are injectable; by default they come from a ``torch.Generator``.
``n_valid`` masks each conv's pad-region output so right-padded rows vocode
as their exact-length runs would (see the JAX package's hift_decode).
``f0_cum_init`` carries the sines' phase from one vocoded chunk to the
next, for streaming.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...checkpoint import torch_convert as tc
from ...core import dsp
from ...core.layers import conv1d, conv_transpose1d, leaky_relu, linear, snake_fast


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


def _len_mask(lens, t, dtype=torch.float32):
    """(B,) valid lengths -> (B, t, 1) {0, 1} mask."""
    return (torch.arange(t, device=lens.device)[None] < lens[:, None]).to(dtype)[..., None]


def f0_predict(p, mel, n_valid=None):
    """(B, T, 80) mel -> (B, T) f0 in Hz."""
    x = mel
    m = None if n_valid is None else _len_mask(n_valid, mel.shape[1], mel.dtype)
    if m is not None:
        x = x * m
    for cp in p["convs"]:
        x = F.elu(conv1d(cp, x, padding=1))
        if m is not None:
            x = x * m
    return torch.abs(linear(p["classifier"], x)[..., 0])


def sine_source(cfg: HiFTConfig, f0_up, phase_noise, additive_noise, f0_cum_init=None):
    """SineGen: f0_up (B, L) at the output rate; phase_noise (B, H+1) initial
    phases (index 0 forced to 0); additive_noise (B, H+1, L) standard normal.
    ``f0_cum_init`` (B,) is the f0 integral before this segment, in cycles
    (sum f0 / sr): harmonic k then continues at phase 2 pi k f0_cum_init, so
    that a waveform vocoded in chunks keeps its sines continuous (streaming;
    hifigan.py:166-200). Returns the per-harmonic sine+noise source
    (B, L, H+1)."""
    h = cfg.nb_harmonics + 1
    dev = f0_up.device
    k = torch.arange(1, h + 1, dtype=torch.float32, device=dev)[None, :, None]
    cum = torch.cumsum(f0_up[:, None, :] * (k / cfg.sampling_rate), dim=-1)
    if f0_cum_init is not None:
        cum = cum + torch.remainder(f0_cum_init.float(), 1.0)[:, None, None] * k
    theta = 2.0 * np.pi * torch.remainder(cum, 1.0)
    phase = phase_noise.clone()
    phase[:, 0] = 0.0
    sines = cfg.nsf_alpha * torch.sin(theta + phase[:, :, None])
    uv = (f0_up > cfg.nsf_voiced_threshold).float()[:, None, :]
    noise_amp = uv * cfg.nsf_sigma + (1.0 - uv) * cfg.nsf_alpha / 3.0
    return (sines * uv + noise_amp * additive_noise).transpose(1, 2)


def _resblock(p, x, kernel, dilations, mask=None):
    # the polynomial snake: the JAX package's HiFT default (FAST_SNAKE)
    for c1, c2, a1, a2, d in zip(p["convs1"], p["convs2"], p["alphas1"], p["alphas2"], dilations):
        xt = conv1d(c1, snake_fast(a1, x), padding=(kernel * d - d) // 2, dilation=d)
        if mask is not None:
            xt = xt * mask
        xt = conv1d(c2, snake_fast(a2, xt), padding=(kernel - 1) // 2)
        if mask is not None:
            xt = xt * mask
        x = xt + x
    return x


def hift_decode(p, cfg: HiFTConfig, mel, source, n_valid=None, compute_dtype=None):
    """(B, T, 80) mel + (B, T*480) merged source -> (B, T*480) waveform.

    ``compute_dtype=torch.bfloat16`` runs the conv trunk (conv_pre, the
    upsamples, the source convs and every resblock) in bf16 and keeps the
    phase-sensitive stages fp32: the source STFT before it, and conv_post,
    exp/sin and the iSTFT after it (hifigan.py:231-300)."""
    win = dsp.hann_window(cfg.istft_n_fft)
    s_re, s_im = dsp.stft(source, cfg.istft_n_fft, cfg.istft_hop_len, win)
    s_stft = torch.cat([s_re, s_im], dim=-1)  # (B, T*120+1, 18)

    t_mel = mel.shape[1]
    masks = None
    if n_valid is not None:
        stage_mult = np.cumprod(cfg.upsample_rates)  # 8, 40, 120
        masks = {
            "mel": _len_mask(n_valid, t_mel, mel.dtype),
            "stft": _len_mask(n_valid * int(stage_mult[-1]) + 1, s_stft.shape[1], mel.dtype),
            "stages": [],
        }
        for i, m in enumerate(stage_mult):
            extra = 1 if i == len(cfg.upsample_rates) - 1 else 0
            masks["stages"].append(
                _len_mask(n_valid * int(m) + extra, t_mel * int(m) + extra, mel.dtype))
        mel = mel * masks["mel"]
        s_stft = s_stft * masks["stft"]
    # the trunk's masks in its dtype (a fp32 mask would promote a bf16 trunk)
    stage_masks = None
    if compute_dtype is not None:
        from ...runtime.precision import cast_floating

        p = {**p, **{k: cast_floating(p[k], compute_dtype)
                     for k in ("conv_pre", "ups", "source_downs", "source_resblocks",
                               "resblocks")}}
        mel, s_stft = mel.to(compute_dtype), s_stft.to(compute_dtype)
    if masks is not None:
        stage_masks = [m.to(mel.dtype) for m in masks["stages"]]

    x = conv1d(p["conv_pre"], mel, padding=3)
    if masks is not None:
        x = x * masks["mel"].to(x.dtype)
    num_kernels = len(cfg.resblock_kernel_sizes)
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        sm = None if masks is None else stage_masks[i]
        x = conv_transpose1d(p["ups"][i], leaky_relu(x, cfg.lrelu_slope), stride=u,
                             padding=(k - u) // 2)
        if i == len(cfg.upsample_rates) - 1:
            x = torch.cat([x[:, 1:2], x], dim=1)  # reflection pad (1, 0) on time
        if sm is not None:
            x = x * sm
        _, ds, dpad = cfg.source_down_specs[i]
        si = conv1d(p["source_downs"][i], s_stft, stride=ds, padding=dpad)
        sm_si = None if sm is None else sm[:, : si.shape[1]]
        if sm_si is not None:
            si = si * sm_si
        si = _resblock(p["source_resblocks"][i], si, cfg.source_resblock_kernel_sizes[i],
                       cfg.source_resblock_dilation_sizes[i], mask=sm_si)
        x = x + si[:, : x.shape[1]]
        xs = None
        for j in range(num_kernels):
            r = _resblock(p["resblocks"][i * num_kernels + j], x, cfg.resblock_kernel_sizes[j],
                          cfg.resblock_dilation_sizes[j], mask=sm)
            xs = r if xs is None else xs + r
        x = xs / num_kernels

    x = conv1d(p["conv_post"], leaky_relu(x, 0.01), padding=3)
    n_freq = cfg.istft_n_fft // 2 + 1
    magnitude = torch.clamp(torch.exp(x[..., :n_freq]), max=1e2)
    phase = torch.sin(x[..., n_freq:])
    re = magnitude * torch.cos(phase)
    im = magnitude * torch.sin(phase)
    if masks is not None:
        fm = masks["stages"][-1]
        re, im = re * fm, im * fm
    wav = dsp.istft(re, im, cfg.istft_n_fft, cfg.istft_hop_len, win)
    return torch.clamp(wav, -cfg.audio_limit, cfg.audio_limit)


def hift_generate(p, cfg: HiFTConfig, mel, phase_noise=None, additive_noise=None,
                  generator=None, n_valid=None, f0_cum_init=None, return_f0=False,
                  compute_dtype=None):
    """(B, T, 80) fp32 mel -> ((B, T*480) wav, (B, T*480) source), and the
    (B, T) f0 in Hz as a third value with ``return_f0``.

    ``phase_noise`` (B, H+1) and ``additive_noise`` (B, H+1, T*480) are
    drawn from ``generator`` when not given. ``f0_cum_init`` (B,) continues
    the sines of an earlier segment (``sine_source``); ``compute_dtype``
    runs the conv trunk in that dtype (``hift_decode``): the f0 predictor
    and the sine source stay fp32."""
    b, t, _ = mel.shape
    f0 = f0_predict(p["f0_predictor"], mel, n_valid=n_valid)
    ups = cfg.upsample_total
    f0_up = torch.repeat_interleave(f0, ups, dim=1)
    h = cfg.nb_harmonics + 1
    if phase_noise is None:
        u = torch.rand((b, h), generator=generator, device=mel.device)
        phase_noise = u * (2.0 * np.pi) - np.pi
        additive_noise = torch.randn((b, h, t * ups), generator=generator, device=mel.device)
    src_h = sine_source(cfg, f0_up, phase_noise, additive_noise, f0_cum_init)
    source = torch.tanh(linear(p["m_source_linear"], src_h))[..., 0]
    if n_valid is not None:
        source = source * _len_mask(n_valid * ups, source.shape[1], source.dtype)[..., 0]
    wav = hift_decode(p, cfg, mel, source, n_valid=n_valid, compute_dtype=compute_dtype)
    return (wav, source, f0) if return_f0 else (wav, source)


def convert_hift(sd, cfg: HiFTConfig = HiFTConfig(), prefix: str = ""):
    """Reference ``HiFTGenerator`` state dict -> the JAX package's tree
    (numpy), as ``chatterbox_tpu/models/s3gen/hifigan.py::convert_hift``:
    the weight-normed convs (``conv_pre``, ``ups``, the resblocks' convs,
    ``conv_post``, the f0 predictor's) folded; ``prefix`` is ``mel2wav.``
    inside the s3gen checkpoint."""
    def res(rp, n):
        return {
            "convs1": [tc.conv1d(sd, f"{rp}.convs1.{i}", weight_norm=True) for i in range(n)],
            "convs2": [tc.conv1d(sd, f"{rp}.convs2.{i}", weight_norm=True) for i in range(n)],
            "alphas1": [{"alpha": tc.as_numpy(sd[f"{rp}.activations1.{i}.alpha"])}
                        for i in range(n)],
            "alphas2": [{"alpha": tc.as_numpy(sd[f"{rp}.activations2.{i}.alpha"])}
                        for i in range(n)],
        }

    n_up = len(cfg.upsample_rates)
    p = {
        "conv_pre": tc.conv1d(sd, prefix + "conv_pre", weight_norm=True),
        "ups": [tc.conv_transpose1d(sd, f"{prefix}ups.{i}", weight_norm=True)
                for i in range(n_up)],
        "source_downs": [tc.conv1d(sd, f"{prefix}source_downs.{i}") for i in range(n_up)],
        "source_resblocks": [res(f"{prefix}source_resblocks.{i}",
                                 len(cfg.source_resblock_dilation_sizes[i])) for i in range(n_up)],
        "resblocks": [res(f"{prefix}resblocks.{i}", len(cfg.resblock_dilation_sizes[i % 3]))
                      for i in range(len(cfg.resblock_kernel_sizes) * n_up)],
        "conv_post": tc.conv1d(sd, prefix + "conv_post", weight_norm=True),
        "m_source_linear": tc.linear(sd, prefix + "m_source.l_linear"),
    }
    p["f0_predictor"] = {
        "convs": [tc.conv1d(sd, f"{prefix}f0_predictor.condnet.{2 * i}", weight_norm=True)
                  for i in range(5)],
        "classifier": tc.linear(sd, prefix + "f0_predictor.classifier"),
    }
    return p
