"""Llama backbone of the T3 speech-token decoder.

Port of ``chatterbox_tpu/models/t3/llama.py`` (HF ``LlamaModel`` numerics
with the Llama_520M config: hidden 1024, 30 layers, 16 heads of 64, FFN
4096, RMSNorm eps 1e-5, rope_theta 5e5 with llama3 scaling).

Parameters keep the stacked layout (L, ...) of the JAX package, with linear
weights as (L, Cout, Cin). The KV cache is (L, 2, B, H, S, D): the decode
step reads layer i in place through the K1 kernel and writes all layers'
new K/V at ``write_pos`` after the layer loop through the K2 kernel.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...core.layers import linear, merge_heads, rms_norm, sdpa, split_heads
from ...ops.flash_decode import flash_decode_layer_attention, kv_cache_append


@dataclass(frozen=True)
class LlamaConfig:
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_hidden_layers: int = 30
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    head_dim: int = 64
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    # llama3-style rope scaling (t3/llama_configs.py:23-30)
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192


LLAMA_520M = LlamaConfig()


def rope_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """HF llama3 rope-scaling formula (transformers modeling_rope_utils)."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2.0 * np.pi / inv_freq
    scaled = np.where(wavelen > low_wavelen, inv_freq / cfg.rope_scaling_factor, inv_freq)
    smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor
    )
    smoothed = (1.0 - smooth) * inv_freq / cfg.rope_scaling_factor + smooth * inv_freq
    is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return np.where(is_medium, smoothed, scaled).astype(np.float32)


def rope_cos_sin(cfg: LlamaConfig, positions):
    """positions (B, T) -> cos, sin (B, T, head_dim) in HF half-rotate layout."""
    inv = torch.from_numpy(rope_inv_freq(cfg)).to(positions.device)
    freqs = positions[..., None].float() * inv
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q,k: (B, H, T, D); cos,sin: (B, T, D). Keeps q/k dtype."""
    cos = cos[:, None].to(q.dtype)
    sin = sin[:, None].to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def layer_params(params, i):
    """Layer i's parameter dict, sliced from the stacked (L, ...) tensors."""
    return {name: {k: v[i] for k, v in sub.items()} for name, sub in params["layers"].items()}


def _qkv(lp, y, cfg: LlamaConfig):
    q = split_heads(linear(lp["q"], y), cfg.num_attention_heads)
    k = split_heads(linear(lp["k"], y), cfg.num_key_value_heads)
    v = split_heads(linear(lp["v"], y), cfg.num_key_value_heads)
    return q, k, v


def _mlp(lp, y):
    g, u = linear(lp["gate_up"], y).chunk(2, dim=-1)
    return F.silu(g) * u


def llama_prefill(params, cfg: LlamaConfig, inputs_embeds, positions, attn_mask, cache_len: int):
    """Full-sequence causal forward writing a fresh KV cache of length
    ``cache_len``. inputs_embeds (B, T, C); positions (B, T) int; attn_mask
    (B, T) bool (True = real token) or None. Returns (hidden (B, T, C),
    cache (L, 2, B, Hkv, cache_len, D) in the embeddings' dtype)."""
    b, t, _ = inputs_embeds.shape
    dev = inputs_embeds.device
    cos, sin = rope_cos_sin(cfg, positions)
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
    if attn_mask is not None:
        keep = keep & attn_mask[:, None, None, :]
    neg = torch.finfo(torch.float32).min
    bias = torch.where(keep, 0.0, neg).to(torch.float32)
    cache = torch.zeros(
        (cfg.num_hidden_layers, 2, b, cfg.num_key_value_heads, cache_len, cfg.head_dim),
        dtype=inputs_embeds.dtype, device=dev,
    )
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        lp = layer_params(params, i)
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, y, cfg)
        q, k = apply_rope(q, k, cos, sin)
        cache[i, 0, :, :, :t] = k
        cache[i, 1, :, :, :t] = v
        x = x + linear(lp["o"], merge_heads(sdpa(q, k, v, bias=bias)))
        y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        x = x + linear(lp["down"], _mlp(lp, y))
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps), cache


def llama_decode_step(params, cfg: LlamaConfig, x, cache, write_pos: int, positions,
                      row_prefix, gap_end: int, layers=None):
    """One-token incremental forward. x (B, 1, C); cache (L, 2, B, H, S, D)
    holding valid slots [0, write_pos); positions (B, 1) rope positions;
    row_prefix (B,) int32 and gap_end give slot validity (see K1). The
    current token attends to itself as an explicit self-logit, its stale
    slot ``write_pos`` is excluded (cur_len = write_pos), and after the
    layer loop every layer's new K/V is written at ``write_pos`` in place.
    ``layers`` may pass the per-layer parameter dicts prebuilt.
    Returns hidden (B, 1, C); ``cache`` is updated in place."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    b = x.shape[0]
    cos, sin = rope_cos_sin(cfg, positions)
    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.num_hidden_layers)]
    new_kv = torch.empty(
        (cfg.num_hidden_layers, 2, b, cfg.num_key_value_heads, d),
        dtype=cache.dtype, device=cache.device,
    )
    for i, lp in enumerate(layers):
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, y, cfg)
        q, k = apply_rope(q, k, cos, sin)
        q1, k1, v1 = (t[:, :, 0].contiguous() for t in (q, k, v))
        a = flash_decode_layer_attention(cache, i, write_pos, row_prefix, gap_end, q1, k1, v1)
        x = x + linear(lp["o"], a.reshape(b, 1, h * d))
        y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        x = x + linear(lp["down"], _mlp(lp, y))
        new_kv[i, 0] = k1
        new_kv[i, 1] = v1
    kv_cache_append(cache, new_kv, write_pos)
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
