"""Llama backbone of the T3 speech-token decoder.

Port of ``chatterbox_tpu/models/t3/llama.py`` (HF ``LlamaModel`` numerics
with the Llama_520M config: hidden 1024, 30 layers, 16 heads of 64, FFN
4096, RMSNorm eps 1e-5, rope_theta 5e5 with llama3 scaling).

Parameters keep the stacked layout (L, ...) of the JAX package, with linear
weights as (L, Cout, Cin). The KV cache takes one of two forms:

- a tensor (L, 2, B, H, S, D) in the working dtype: the decode step reads
  layer i in place through K1a (K1b at the alignment layer) and writes all
  layers' new K/V at ``write_pos`` after the layer loop through K2;
- a ``QuantCache`` (the JAX package's ``cache_quant=True``, llama.py:376-398,
  621-652): int8 values with one fp32 scale per (layer, k/v, row, head,
  slot), and a tail of ``TAIL_W`` slots in the working dtype. Slots below
  ``merge_base = write_pos // TAIL_W * TAIL_W`` are read int8, slots from
  ``merge_base`` to ``write_pos`` exact from the tail (K1c+d). The step
  appends its K/V to the tail (K2) and, when the tail's group of ``TAIL_W``
  closes, quantizes it into the int8 cache (K2b). The JAX package keeps the
  int8 cache as (D, S) for the TPU's lanes; the port keeps (S, D).
"""

from dataclasses import dataclass
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...core.layers import linear, merge_heads, rms_norm, sdpa, split_heads
from ...ops.flash_decode import (
    TAIL_W,
    flash_decode_layer_attention,
    flash_decode_layer_attention_int8,
    flash_decode_layer_attention_stats,
    kv_cache_append,
    kv_cache_quantize_write,
    quantize_kv,  # noqa: F401 -- kept here as in the JAX package (llama.py:319-329)
)


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


class QuantCache(NamedTuple):
    """The int8 KV cache of the decode loop (see the module docstring)."""

    values: torch.Tensor  # (L, 2, B, H, S, D) int8
    scales: torch.Tensor  # (L, 2, B, H, S) fp32; 1.0 where nothing was written
    tail: torch.Tensor  # (L, 2, B, H, TAIL_W, D) working dtype: slots [merge_base, +TAIL_W)


def llama_prefill(params, cfg: LlamaConfig, inputs_embeds, positions, attn_mask, cache_len: int,
                  cache_quant: bool = False):
    """Full-sequence causal forward writing a fresh KV cache of length
    ``cache_len``. inputs_embeds (B, T, C); positions (B, T) int; attn_mask
    (B, T) bool (True = real token) or None. Returns (hidden (B, T, C),
    cache): the cache is (L, 2, B, Hkv, cache_len, D) in the embeddings'
    dtype, or with ``cache_quant`` a ``QuantCache`` whose int8 values hold
    every prefill token (K2b, one launch), whose padding slots have scale
    1.0, and whose tail holds slots [T // TAIL_W * TAIL_W, T) in the
    embeddings' dtype."""
    b, t, _ = inputs_embeds.shape
    dev, dt = inputs_embeds.device, inputs_embeds.dtype
    cos, sin = rope_cos_sin(cfg, positions)
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
    if attn_mask is not None:
        keep = keep & attn_mask[:, None, None, :]
    neg = torch.finfo(torch.float32).min
    bias = torch.where(keep, 0.0, neg).to(torch.float32)
    kv_shape = (cfg.num_hidden_layers, 2, b, cfg.num_key_value_heads)
    # the bf16 path writes into the cache itself; the int8 path gathers the
    # K/V of every layer first and quantizes them in one launch
    kvs = torch.zeros(kv_shape + (t if cache_quant else cache_len, cfg.head_dim),
                      dtype=dt, device=dev)
    x = inputs_embeds
    for i in range(cfg.num_hidden_layers):
        lp = layer_params(params, i)
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, y, cfg)
        q, k = apply_rope(q, k, cos, sin)
        kvs[i, 0, :, :, :t] = k
        kvs[i, 1, :, :, :t] = v
        x = x + linear(lp["o"], merge_heads(sdpa(q, k, v, bias=bias)))
        y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        x = x + linear(lp["down"], _mlp(lp, y))
    hidden = rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
    if not cache_quant:
        return hidden, kvs
    values = torch.zeros(kv_shape + (cache_len, cfg.head_dim), dtype=torch.int8, device=dev)
    scales = torch.ones(kv_shape + (cache_len,), dtype=torch.float32, device=dev)
    kv_cache_quantize_write(values, scales, kvs, 0)
    mb0 = t // TAIL_W * TAIL_W
    tail = torch.zeros(kv_shape + (TAIL_W, cfg.head_dim), dtype=dt, device=dev)
    tail[:, :, :, :, :t - mb0] = kvs[:, :, :, :, mb0:]
    return hidden, QuantCache(values, scales, tail)


def _text_probs(cache, layer: int, q, m, l, text_slice: Tuple[int, int], row_prefix):
    """Layer ``layer``'s head-mean softmax probabilities over the cache
    slots ``text_slice`` = [lo, hi), rebuilt exactly from K1b's stats:
    ``exp(q.k * scale - m) / max(l, 1e-30)``, zero at slots at or past the
    row's ``row_prefix`` (llama.py:479-536). q (B, H, D); m, l (B, H).
    Returns (B, hi - lo) fp32."""
    lo, hi = text_slice
    kt = cache[layer, 0, :, :, lo:hi].float()  # (B, H, T, D)
    logits = torch.einsum("bhd,bhtd->bht", q.float(), kt) * q.shape[-1] ** -0.5
    p = torch.exp(logits - m[..., None]) / torch.clamp_min(l[..., None], 1e-30)
    pos = torch.arange(lo, hi, device=p.device)
    p = torch.where(pos[None, None, :] < row_prefix.long()[:, None, None], p, 0.0)
    return p.mean(dim=1)


def llama_decode_step(params, cfg: LlamaConfig, x, cache, write_pos: int, positions,
                      row_prefix, gap_end: int, layers=None, align_layer: Optional[int] = None,
                      text_slice: Optional[Tuple[int, int]] = None):
    """One-token incremental forward. x (B, 1, C); cache (the tensor or a
    ``QuantCache``) holding valid slots [0, write_pos); positions (B, 1) rope
    positions; row_prefix (B,) int32 and gap_end give slot validity (see
    K1). The current token attends to itself as an explicit self-logit, its
    stale slot ``write_pos`` is excluded (cur_len = write_pos), and after the
    layer loop every layer's new K/V is written at ``write_pos`` in place
    (into the tail on the int8 path, which is merged into the int8 cache
    when ``write_pos + 1`` closes a group of TAIL_W).

    ``align_layer`` (with ``text_slice``, the cache slots of the text) asks
    for that layer's head-mean attention over the text: K1b runs there and
    the probabilities are rebuilt from its stats. It needs the working-dtype
    cache and as many KV heads as query heads; a ValueError names what is
    missing. ``layers`` may pass the per-layer parameter dicts prebuilt.
    Returns (hidden (B, 1, C), the text attention (B, hi - lo) fp32 or
    None); the cache is updated in place."""
    h, d = cfg.num_attention_heads, cfg.head_dim
    b = x.shape[0]
    quant = isinstance(cache, QuantCache)
    if align_layer is not None:
        if cfg.num_key_value_heads != h:
            raise ValueError(
                "alignment needs num_key_value_heads == num_attention_heads (got "
                f"{cfg.num_key_value_heads} and {h}): the text attention is rebuilt per query "
                "head from the KV cache")
        if not 0 <= align_layer < cfg.num_hidden_layers:
            raise ValueError(f"alignment_layer {align_layer} is not a layer of the model "
                             f"({cfg.num_hidden_layers} layers)")
        if quant or text_slice is None:
            raise ValueError("alignment needs the working-dtype KV cache and a text_slice")
    cos, sin = rope_cos_sin(cfg, positions)
    if layers is None:
        layers = [layer_params(params, i) for i in range(cfg.num_hidden_layers)]
    kv_dtype = cache.tail.dtype if quant else cache.dtype
    new_kv = torch.empty((cfg.num_hidden_layers, 2, b, cfg.num_key_value_heads, d),
                         dtype=kv_dtype, device=x.device)
    merge_base = write_pos // TAIL_W * TAIL_W
    attn = None
    for i, lp in enumerate(layers):
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, y, cfg)
        q, k = apply_rope(q, k, cos, sin)
        q1, k1, v1 = (t[:, :, 0].contiguous() for t in (q, k, v))
        if quant:
            a = flash_decode_layer_attention_int8(
                cache.values, cache.scales, cache.tail, merge_base, i, write_pos, row_prefix,
                gap_end, q1, k1, v1)
        elif i == align_layer:
            a, m, l = flash_decode_layer_attention_stats(
                cache, i, write_pos, row_prefix, gap_end, q1, k1, v1)
            attn = _text_probs(cache, i, q1, m, l, text_slice, row_prefix)
        else:
            a = flash_decode_layer_attention(cache, i, write_pos, row_prefix, gap_end, q1, k1, v1)
        x = x + linear(lp["o"], a.reshape(b, 1, h * d))
        y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        x = x + linear(lp["down"], _mlp(lp, y))
        new_kv[i, 0] = k1
        new_kv[i, 1] = v1
    kv_cache_write(cache, new_kv, write_pos)
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps), attn


def kv_cache_write(cache, new_kv, write_pos: int):
    """Write one decode step's K/V of every layer (L, 2, B, H, D) at slot
    ``write_pos``, in place: into the cache tensor (K2), or into the tail of
    a ``QuantCache`` (K2), whose full group of TAIL_W is then quantized into
    the int8 cache when ``write_pos + 1`` closes it (K2b)."""
    if not isinstance(cache, QuantCache):
        kv_cache_append(cache, new_kv, write_pos)
        return
    merge_base = write_pos // TAIL_W * TAIL_W
    kv_cache_append(cache.tail, new_kv, write_pos - merge_base)
    if (write_pos + 1) % TAIL_W == 0:
        kv_cache_quantize_write(cache.values, cache.scales, cache.tail, merge_base)
