"""Audio watermarks: the spread-spectrum engine and the neural Perth one.

Port of ``chatterbox_tpu/models/watermark.py``. Both engines take a (B, T)
batch on its device (``apply``, which the pipelines call inside
``synthesize``) and numpy audio (``apply_watermark``, ``get_watermark``):
  - ``SpreadSpectrumWatermarker``: a deterministic, weightless
    multiplicative pattern on the STFT magnitudes of the 2-9 kHz band, one
    orthonormal pseudo-noise row per payload bit;
  - ``PerthNetImplicit``: a checkpointed network's tanh-bounded ripple on
    the STFT log-magnitudes, phase kept, and a decoder conv stack whose
    global-mean logit detects it. Its topology is rebuilt from the
    checkpoint (``convert_perth``).
``PerthImplicitWatermarker`` picks the engine as the JAX package's factory
does: a Perth checkpoint given, else ``$CHATTERBOX_PERTH_CKPT``, else
``perth.pth`` in this package's directory, else spread-spectrum.
"""

import os
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint.torch_convert import as_numpy
from ..core import dsp
from ..core.layers import conv1d
from ..device import full_fp32


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


def convert_perth(sd):
    """A torch Perth state dict -> (params, meta), as the JAX package's
    ``convert_perth``: the ``model``/``state_dict``/``network`` containers
    and a ``module.`` prefix unwrapped, then the ``encoder.*`` and
    ``decoder.*`` conv/linear stacks in the natural order of their indices,
    in the JAX package's layouts (numpy float32; ``kind`` "conv" or
    "linear"). Keys left unread raise ValueError; ``meta["unconsumed"]``
    is kept, empty, as the JAX package returns it."""
    import re

    for wrap in ("model", "state_dict", "network"):
        if wrap in sd and not hasattr(sd[wrap], "shape"):
            sd = sd[wrap]
    sd = {k[len("module."):] if k.startswith("module.") else k: v for k, v in sd.items()}
    consumed = set()

    def build_stack(group):
        weight_keys = [k for k in sd if k.startswith(group + ".") and k.endswith("weight")
                       and getattr(sd[k], "ndim", len(getattr(sd[k], "shape", ()))) >= 2]
        layers = []
        for wk in sorted(weight_keys, key=lambda k: [int(x) for x in re.findall(r"\d+", k)]):
            w = as_numpy(sd[wk])
            consumed.add(wk)
            if w.ndim == 3:  # Conv1d (Cout, Cin, W) -> (W, Cin, Cout)
                p, kind = {"w": np.transpose(w, (2, 1, 0)).astype(np.float32)}, "conv"
            elif w.ndim == 2:  # Linear (Cout, Cin) -> (Cin, Cout)
                p, kind = {"w": w.T.astype(np.float32)}, "linear"
            else:
                raise ValueError(f"unsupported weight rank for {wk}: {w.shape}")
            bk = wk[: -len("weight")] + "bias"
            if bk in sd:
                p["b"] = as_numpy(sd[bk]).astype(np.float32)
                consumed.add(bk)
            layers.append({"kind": kind, **p})
        if not layers:
            raise KeyError(f"no '{group}.*weight' conv/linear keys in checkpoint")
        return layers

    enc, dec = build_stack("encoder"), build_stack("decoder")
    unconsumed = sorted(k for k in sd if k not in consumed)
    if unconsumed:
        raise ValueError(f"convert_perth: {len(unconsumed)} checkpoint keys NOT consumed "
                         f"(layout drift?): {unconsumed[:20]}")
    n_bins = enc[0]["w"].shape[1]
    meta = {"n_fft": (n_bins - 1) * 2, "n_bins": n_bins, "unconsumed": []}
    return {"encoder": enc, "decoder": dec}, meta


def load_perth_checkpoint(path):
    """A torch Perth checkpoint file -> (params, meta). Read with
    ``weights_only=False``, as the JAX package reads it (a published
    checkpoint may pickle the module itself): load only a trusted file."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return convert_perth(sd)


class PerthNetImplicit:
    """The Perth-implicit neural watermarker (``chatterbox_tpu/models/
    watermark.py::PerthNetImplicit``): an encoder-predicted, tanh-bounded
    log-magnitude ripple on the STFT (n_fft from the checkpoint, hop
    n_fft / 4), phase kept, and presence as the sigmoid of the decoder's
    global-mean logit. Runs on the device of the audio it is given, in
    full fp32."""

    def __init__(self, params, meta=None, strength: float = 0.15):
        self.params = params  # the JAX-layout tree of convert_perth
        n_bins = params["encoder"][0]["w"].shape[1]
        self.n_fft = (meta or {}).get("n_fft", (n_bins - 1) * 2)
        self.hop = self.n_fft // 4
        self.strength = strength
        self._device_stacks = {}

    @classmethod
    def from_checkpoint(cls, path):
        params, meta = load_perth_checkpoint(path)
        return cls(params, meta)

    def _stacks(self, device):
        """(encoder, decoder) layers as tensors in PyTorch layouts on
        ``device``, made once a device."""
        if device not in self._device_stacks:
            def layer(lp):
                w = torch.from_numpy(np.asarray(lp["w"], np.float32))
                w = w.permute(2, 1, 0) if lp["kind"] == "conv" else w.T
                out = {"kind": lp["kind"], "w": w.contiguous().to(device)}
                if "b" in lp:
                    out["b"] = torch.from_numpy(np.asarray(lp["b"], np.float32)).to(device)
                return out

            self._device_stacks[device] = tuple([layer(lp) for lp in self.params[g]]
                                                for g in ("encoder", "decoder"))
        return self._device_stacks[device]

    @staticmethod
    def _stack(layers, x, final_tanh):
        """x (B, T, F) frames through a stack, leaky_relu 0.2 between
        layers (tests/torch_perth_ref.py)."""
        for i, lp in enumerate(layers):
            if lp["kind"] == "conv":
                x = conv1d(lp, x, padding=(lp["w"].shape[-1] - 1) // 2)
            else:
                x = F.linear(x, lp["w"], lp.get("b"))
            if i < len(layers) - 1:
                x = F.leaky_relu(x, 0.2)
        return torch.tanh(x) if final_tanh else x

    def _logmag(self, x):
        re_, im = dsp.stft(x, self.n_fft, self.hop, dsp.hann_window(self.n_fft))
        return re_, im, torch.log(torch.sqrt(re_**2 + im**2) + 1e-6)

    def apply(self, wav):
        """Watermark (B, T) audio on its device; returns (B, T) float32."""
        t_len = wav.shape[-1]
        encoder, _ = self._stacks(wav.device)
        with full_fp32():
            x = F.pad(wav.float(), (0, (-t_len) % self.hop))
            re_, im, logmag = self._logmag(x)
            scale = torch.exp(self.strength * self._stack(encoder, logmag, final_tanh=True))
            y = dsp.istft(re_ * scale, im * scale, self.n_fft, self.hop,
                          dsp.hann_window(self.n_fft))
        return F.pad(y, (0, max(0, t_len - y.shape[-1])))[:, :t_len]

    def apply_watermark(self, wav, watermark=None, sample_rate: int = 24000):
        """wav (T,) or (B, T) numpy float32 -> watermarked, same shape."""
        y = self.apply(torch.from_numpy(np.atleast_2d(np.asarray(wav, np.float32)))).numpy()
        return y[0] if np.ndim(wav) == 1 else y

    def presence_logit(self, wav):
        """(B,) presence logits of (T,) or (B, T) numpy audio."""
        x = torch.from_numpy(np.atleast_2d(np.asarray(wav, np.float32)))
        _, decoder = self._stacks(x.device)
        with full_fp32():
            _, _, logmag = self._logmag(x)
            out = self._stack(decoder, logmag, final_tanh=False)
        return out.mean(dim=(1, 2)).numpy()

    def get_watermark(self, wav, sample_rate: int = 24000) -> float:
        """1.0 when the first row's presence probability is over 0.5."""
        logit = torch.from_numpy(self.presence_logit(wav)[:1])
        return float(torch.sigmoid(logit)[0] > 0.5)


def PerthImplicitWatermarker(cfg: WatermarkConfig = WatermarkConfig(), checkpoint=None):
    """The reference's watermarker constructor (tts.py:126): the neural Perth
    engine from ``checkpoint``, else from ``$CHATTERBOX_PERTH_CKPT``, else
    from ``perth.pth`` beside this package's modules when it exists; else
    the weightless spread-spectrum engine."""
    cand = checkpoint or os.environ.get("CHATTERBOX_PERTH_CKPT")
    if cand is None:
        default = Path(__file__).resolve().parent.parent / "perth.pth"
        cand = str(default) if default.exists() else None
    if cand is not None:
        return PerthNetImplicit.from_checkpoint(cand)
    return SpreadSpectrumWatermarker(cfg)
