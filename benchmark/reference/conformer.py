"""Upsample conformer token encoder of the flow, plain (6 blocks at 25 Hz
-> x2 nearest upsample + causal conv -> 4 blocks at 50 Hz), with the dense
ESPnet rel-pos attention: the (T, 2T-1) positional term rel-shifted and an
exact fp32 softmax. Parameters in the port's layouts ((Cout, Cin) linears).
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .layers import conv1d, layer_norm, leaky_relu, linear, merge_heads, split_heads


@dataclass(frozen=True)
class ConformerConfig:
    input_size: int = 512
    output_size: int = 512
    attention_heads: int = 8
    linear_units: int = 2048
    num_blocks: int = 6
    num_up_blocks: int = 4
    pre_lookahead_len: int = 3
    up_stride: int = 2
    ln_eps: float = 1e-12


def espnet_rel_pe(d_model: int, t: int) -> np.ndarray:
    """EspnetRelPositionalEncoding for a sequence of t: (1, 2t-1, d) float32,
    positive relative positions t-1 .. 0 then negative -1 .. -(t-1)
    (conformer.py:35-61; the table is built for max(t, 16) and centred)."""
    max_len = max(t, 16)
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * -(np.log(10000.0) / d_model))
    pe_pos = np.zeros((max_len, d_model))
    pe_neg = np.zeros((max_len, d_model))
    pe_pos[:, 0::2] = np.sin(position * div)
    pe_pos[:, 1::2] = np.cos(position * div)
    pe_neg[:, 0::2] = np.sin(-position * div)
    pe_neg[:, 1::2] = np.cos(-position * div)
    pe = np.concatenate([pe_pos[::-1], pe_neg[1:]], axis=0)
    center = pe.shape[0] // 2
    return pe[None, center - t + 1 : center + t].astype(np.float32)


def _rel_shift_bd(bd):
    """(B, H, T, 2T-1) -> (B, H, T, T): out[t, s] = bd[t, T-1 - t + s], by
    the reference's pad/reshape trick (conformer.py:64-73)."""
    b, h, t, _ = bd.shape
    padded = F.pad(bd, (1, 0)).reshape(b, h, 2 * t, t)
    return padded[:, :, 1:].reshape(b, h, t, 2 * t - 1)[..., :t]


def rel_pos_attention_dense(p, x, n_heads, key_mask=None):
    """The dense ESPnet rel-pos attention (conformer.py:157-189): ac = q_u.k,
    bd = q_v.(W_pos pe) rel-shifted, softmax((ac + bd) / sqrt(D)) in fp32,
    pad keys' scores at -1e9 and their probabilities zeroed. Pad query rows
    keep an output here, where the K4 path zeroes them: the two agree on
    the valid rows."""
    b, t, c = x.shape
    d_k = c // n_heads
    q, k, v = (split_heads(linear(p[n], x), n_heads) for n in ("q", "k", "v"))
    pe = torch.from_numpy(espnet_rel_pe(c, t)).to(device=x.device, dtype=x.dtype)
    pp = split_heads(linear(p["pos"], pe), n_heads)  # (1, H, 2T-1, D)
    q_u = q + p["pos_bias_u"][None, :, None, :]
    q_v = q + p["pos_bias_v"][None, :, None, :]
    ac = torch.matmul(q_u.float(), k.float().transpose(-1, -2))
    bd = _rel_shift_bd(torch.matmul(q_v.float(), pp.float().transpose(-1, -2)))
    scores = (ac + bd) / float(np.sqrt(d_k))
    if key_mask is not None:
        keep = key_mask[:, None, None, :]
        probs = torch.where(keep, torch.softmax(torch.where(keep, scores, -1.0e9), dim=-1), 0.0)
    else:
        probs = torch.softmax(scores, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float()).to(v.dtype)
    return linear(p["out"], merge_heads(out))


def conformer_layer(p, x, cfg: ConformerConfig, key_mask=None):
    """Pre-norm MHA + swish FFN (macaron and conv modules are off)."""
    y = layer_norm(p["norm_mha"], x, cfg.ln_eps)
    x = x + rel_pos_attention_dense(p["attn"], y, cfg.attention_heads, key_mask)
    y = layer_norm(p["norm_ff"], x, cfg.ln_eps)
    return x + linear(p["ff_w2"], F.silu(linear(p["ff_w1"], y)))


def pre_lookahead(p, x, lookahead_len=3):
    """Right-padded lookahead conv + leaky_relu(0.01) + causal conv k3, residual."""
    y = conv1d(p["conv1"], x, padding=(0, lookahead_len))
    y = leaky_relu(y, 0.01)
    y = conv1d(p["conv2"], y, padding=(2, 0))
    return y + x


def upsample2_conv(p, x, stride=2):
    """Nearest x2 upsample, left pad 2*stride, conv k = 2*stride+1."""
    y = torch.repeat_interleave(x, stride, dim=1)
    return conv1d(p["conv"], y, padding=(stride * 2, 0))


def _embed(p, x, cfg: ConformerConfig):
    """LinearNoSubsampling, then the positional encoding's x * sqrt(d)."""
    y = layer_norm(p["ln"], linear(p["linear"], x), 1e-5)
    return y * float(np.sqrt(cfg.output_size))


def upsample_conformer_encoder(p, x, cfg: ConformerConfig = ConformerConfig(), key_mask=None):
    """(B, T, 512) token embeddings -> (B, 2T, 512); key_mask (B, T) bool
    marks valid tokens of right-padded rows."""
    y = _embed(p["embed"], x, cfg)
    if key_mask is not None:
        y = y * key_mask[..., None].to(y.dtype)
    y = pre_lookahead(p["pre_lookahead"], y, cfg.pre_lookahead_len)
    for lp in p["encoders"]:
        y = conformer_layer(lp, y, cfg, key_mask)
    y = upsample2_conv(p["up_layer"], y, cfg.up_stride)
    up_mask = None if key_mask is None else torch.repeat_interleave(key_mask, cfg.up_stride, dim=1)
    y = _embed(p["up_embed"], y, cfg)
    for lp in p["up_encoders"]:
        y = conformer_layer(lp, y, cfg, up_mask)
    return layer_norm(p["after_norm"], y, 1e-5)
