"""Causal 1-D UNet, the CFM velocity estimator of the flow, plain
(reference s3gen/decoder.py ConditionalDecoder: in 320, out 80, channels
256, 4 transformer blocks per stage x (1 down + 12 mid + 1 up), 8 heads of
64), with dense attention on the unpadded q, k, v.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .layers import (causal_conv1d, conv1d, layer_norm, linear, merge_heads, mish, sdpa,
                            split_heads)


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 320  # packed [x; mu; spks; cond] = 4 * 80
    out_channels: int = 80
    channels: int = 256
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    attention_head_dim: int = 64

    @property
    def time_embed_dim(self) -> int:
        return self.channels * 4


def sinusoidal_pos_emb(t, dim: int, scale: float = 1000.0):
    """matcha/decoder.py:14-29; t (B,) fp32 -> (B, dim) fp32."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _causal_block(p, x, mask):
    """Causal conv k3 -> LayerNorm -> Mish."""
    y = causal_conv1d(p["conv"], x * mask)
    return mish(layer_norm(p["ln"], y, 1e-5)) * mask


def _causal_resnet(p, x, mask, t_emb):
    h = _causal_block(p["block1"], x, mask)
    h = h + linear(p["mlp"], mish(t_emb))[:, None]
    h = _causal_block(p["block2"], h, mask)
    return h + conv1d(p["res_conv"], x * mask)


def _attn(p, x, n_heads, key_bias=None):
    """diffusers Attention: q/k/v projections without bias (fused ``to_qkv``
    or separate ``to_q``/``to_k``/``to_v``), scale 1/sqrt(head_dim), out
    bias."""
    if "to_qkv" in p:
        qkv = linear(p["to_qkv"], x).chunk(3, dim=-1)
    else:
        qkv = [linear(p[name], x) for name in ("to_q", "to_k", "to_v")]
    q, k, v = (split_heads(y, n_heads) for y in qkv)
    out = sdpa(q, k, v, mask=None if key_bias is None else key_bias.float()[:, None, None, :])
    return linear(p["to_out"], merge_heads(out))


def _transformer_block(p, x, cfg: UNetConfig, key_bias=None):
    """BasicTransformerBlock, plain-LayerNorm path with an exact-GELU FFN."""
    x = x + _attn(p["attn"], layer_norm(p["norm1"], x, 1e-5), cfg.num_heads, key_bias)
    y = layer_norm(p["norm3"], x, 1e-5)
    return x + linear(p["ff_out"], F.gelu(linear(p["ff_in"], y)))


def unet_forward(p, cfg: UNetConfig, x, mu, spks, cond, t, mask=None):
    """Velocity estimate. x, mu, cond (B, T, 80); spks (B, 80); t (B,) in
    [0, 1]; mask (B, T) bool or None. Returns (B, T, 80)."""
    b, tt, _ = x.shape
    if mask is None:
        mask_c = torch.ones((b, tt, 1), dtype=x.dtype, device=x.device)
        key_bias = None
    else:
        mask_c = mask[..., None].to(x.dtype)
        key_bias = (1.0 - mask.float()) * -1.0e10
    # an fp32 t: bf16 would quantize the scale-1000 sinusoid's phase
    t_emb = sinusoidal_pos_emb(t.float(), cfg.in_channels).to(x.dtype)
    t_emb = linear(p["time_mlp2"], F.silu(linear(p["time_mlp1"], t_emb)))

    h = torch.cat([x, mu, spks[:, None].expand(b, tt, spks.shape[-1]), cond], dim=-1)
    h = _causal_resnet(p["down_resnet"], h, mask_c, t_emb)
    for bp in p["down_tf"]:
        h = _transformer_block(bp, h, cfg, key_bias)
    skip = h
    h = causal_conv1d(p["down_conv"], h * mask_c)
    for mp in p["mid"]:
        h = _causal_resnet(mp["resnet"], h, mask_c, t_emb)
        for bp in mp["tf"]:
            h = _transformer_block(bp, h, cfg, key_bias)
    h = torch.cat([h, skip], dim=-1)
    h = _causal_resnet(p["up_resnet"], h, mask_c, t_emb)
    for bp in p["up_tf"]:
        h = _transformer_block(bp, h, cfg, key_bias)
    h = causal_conv1d(p["up_conv"], h * mask_c)
    h = _causal_block(p["final_block"], h, mask_c)
    return conv1d(p["final_proj"], h * mask_c) * mask_c
