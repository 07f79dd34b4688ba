"""Upsample conformer token encoder (6 blocks at 25 Hz -> x2 nearest
upsample + causal conv -> 4 blocks at 50 Hz).

Port of ``chatterbox_tpu/models/s3gen/conformer.py``. The ESPnet rel-pos
attention runs as the exact decomposition of ``rel_pos_attention_flash``:
the rel-shifted term q_v . W_pos pe(t - s) equals qhat[t] . shat[s], where
qhat is q_v folded with W_pos and rope-rotated by the query position and
shat the absolute sinusoid table; W_pos's bias would add a per-row constant
and is dropped. No (T, 2T-1) tensor and no rel-shift exist. The attention
itself is kernel K4 (``ops/flash_attention.py``). With the module switch
``FLASH_ATTENTION`` off (the JAX package's, conformer.py:76,160) it is the
dense ESPnet attention instead: the (T, 2T-1) positional term rel-shifted,
exact fp32 softmax; the kernels have no backward, so a gradient needs it.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...checkpoint import torch_convert as tc
from ...core.layers import conv1d, layer_norm, leaky_relu, linear, merge_heads, split_heads
from ...ops.flash_attention import flash_relpos_attention


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


FLASH_ATTENTION = True  # module switch, as the JAX package's


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


def rel_pos_encoding(x, d_model: int):
    """x (B, T, C) -> (x * sqrt(d_model), pos_emb (1, 2T-1, d_model) fp32 on
    x's device): EspnetRelPositionalEncoding. The encoder applies the scale
    alone (``_embed``); the attention builds the table it needs itself."""
    pos = torch.from_numpy(espnet_rel_pe(d_model, x.shape[1])).to(x.device)
    return x * float(np.sqrt(d_model)), pos


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


def sinusoid_tables(t: int, c: int):
    """(sin(w_i s), cos(w_i s)) for s in [0, t), w_i the ESPnet frequencies;
    each (t, c/2) float32."""
    div = np.exp(np.arange(0, c, 2, dtype=np.float64) * -(np.log(10000.0) / c))
    ang = np.arange(t, dtype=np.float64)[:, None] * div[None]
    return np.sin(ang).astype(np.float32), np.cos(ang).astype(np.float32)


def relpos_operands(p, x, n_heads):
    """The rel-pos attention's kernel operands from x (B, T, C):
    q_u, k, v (B, T, C); qhat (B, T, H*C) fp32; shat (1, T, C) fp32."""
    b, t, c = x.shape
    d_k = c // n_heads
    q = linear(p["q"], x)
    k = linear(p["k"], x)
    v = linear(p["v"], x)
    q_u = q + p["pos_bias_u"].reshape(-1)
    q_v = q + p["pos_bias_v"].reshape(-1)
    # fold W_pos (port layout (H*D, C)) into the query: qw[b,t,h,c]
    w_pos = p["pos"]["w"].reshape(n_heads, d_k, c).float()
    qw = torch.einsum("bthd,hdc->bthc", q_v.reshape(b, t, n_heads, d_k).float(), w_pos)
    sin_np, cos_np = sinusoid_tables(t, c)
    sin_t = torch.from_numpy(sin_np).to(x.device)[None, :, None]  # (1, T, 1, C/2)
    cos_t = torch.from_numpy(cos_np).to(x.device)[None, :, None]
    qe, qo = qw[..., 0::2], qw[..., 1::2]
    qhat = torch.stack([-qe * cos_t + qo * sin_t, qe * sin_t + qo * cos_t], dim=-1)
    qhat = qhat.reshape(b, t, n_heads * c)
    shat = torch.stack([sin_t[0, :, 0], cos_t[0, :, 0]], dim=-1).reshape(1, t, c)
    return q_u, k, v, qhat, shat


def rel_pos_attention(p, x, n_heads, key_mask=None):
    """RelPositionMultiHeadedAttention (self-attention), through K4
    (``rel_pos_attention_flash``; the dense ``rel_pos_attention_dense`` with
    ``FLASH_ATTENTION`` off)."""
    if not FLASH_ATTENTION:
        return rel_pos_attention_dense(p, x, n_heads, key_mask)
    return rel_pos_attention_flash(p, x, n_heads, key_mask)


def rel_pos_attention_flash(p, x, n_heads, key_mask=None):
    """The rel-pos attention as the exact decomposition through K4. Pad keys
    are biased with -1e9 and pad-query rows are zeroed afterwards."""
    b, t, c = x.shape
    d_k = c // n_heads
    q_u, k, v, qhat, shat = relpos_operands(p, x, n_heads)
    tp = -(-t // 128) * 128
    if key_mask is not None:
        bias = torch.where(key_mask, 0.0, -1.0e9).float()
    else:
        bias = torch.zeros((b, t), dtype=torch.float32, device=x.device)
    if tp != t:
        q_u, k, v, qhat, shat = (F.pad(a, (0, 0, 0, tp - t)) for a in (q_u, k, v, qhat, shat))
        bias = F.pad(bias, (0, tp - t), value=-1.0e9)
    dt = x.dtype
    out = flash_relpos_attention(
        q_u.to(dt).contiguous(), qhat.to(dt).contiguous(), k.to(dt).contiguous(), shat,
        v.to(dt).contiguous(), bias.contiguous(), n_heads, 1.0 / float(np.sqrt(d_k)),
    )[:, :t]
    if key_mask is not None:
        out = out * key_mask[..., None].to(out.dtype)
    return linear(p["out"], out)


def conformer_layer(p, x, cfg: ConformerConfig, key_mask=None):
    """Pre-norm MHA + swish FFN (macaron and conv modules are off)."""
    y = layer_norm(p["norm_mha"], x, cfg.ln_eps)
    x = x + rel_pos_attention(p["attn"], y, cfg.attention_heads, key_mask)
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


def convert_upsample_conformer(sd, cfg: ConformerConfig = ConformerConfig(), prefix=""):
    """Reference ``UpsampleConformerEncoder`` state dict -> the JAX package's
    tree (numpy), as ``chatterbox_tpu/models/s3gen/conformer.py``'s."""
    def layer(lp):
        a = f"{lp}.self_attn."
        return {
            "norm_mha": tc.layer_norm(sd, f"{lp}.norm_mha"),
            "norm_ff": tc.layer_norm(sd, f"{lp}.norm_ff"),
            "attn": {
                "q": tc.linear(sd, a + "linear_q"),
                "k": tc.linear(sd, a + "linear_k"),
                "v": tc.linear(sd, a + "linear_v"),
                "out": tc.linear(sd, a + "linear_out"),
                "pos": tc.linear(sd, a + "linear_pos"),
                "pos_bias_u": tc.as_numpy(sd[a + "pos_bias_u"]),
                "pos_bias_v": tc.as_numpy(sd[a + "pos_bias_v"]),
            },
            "ff_w1": tc.linear(sd, f"{lp}.feed_forward.w_1"),
            "ff_w2": tc.linear(sd, f"{lp}.feed_forward.w_2"),
        }

    def embed(ep):
        return {"linear": tc.linear(sd, f"{ep}.out.0"), "ln": tc.layer_norm(sd, f"{ep}.out.1")}

    return {
        "embed": embed(prefix + "embed"),
        "pre_lookahead": {
            "conv1": tc.conv1d(sd, prefix + "pre_lookahead_layer.conv1"),
            "conv2": tc.conv1d(sd, prefix + "pre_lookahead_layer.conv2"),
        },
        "encoders": [layer(f"{prefix}encoders.{i}") for i in range(cfg.num_blocks)],
        "up_layer": {"conv": tc.conv1d(sd, prefix + "up_layer.conv")},
        "up_embed": embed(prefix + "up_embed"),
        "up_encoders": [layer(f"{prefix}up_encoders.{i}") for i in range(cfg.num_up_blocks)],
        "after_norm": tc.layer_norm(sd, prefix + "after_norm"),
    }
