"""Llama backbone of the T3 speech-token decoder.

Port of ``chatterbox_tpu/models/t3/llama.py`` (HF ``LlamaModel`` numerics
with the Llama_520M config: hidden 1024, 30 layers, 16 heads of 64, FFN
4096, RMSNorm eps 1e-5, rope_theta 5e5 with llama3 scaling).

Under ``parallel.tensor_parallel.model_parallel(group)`` the layers run on
this rank's heads and FFN columns (``cfg`` then holds the local counts,
``parallel.sharding.local_t3_config``): the partial products of ``o`` and
``down`` are all-reduced, and the watchdog's head mean sums over the group.

Parameters keep the stacked layout (L, ...) of the JAX package, with linear
weights as (L, Cout, Cin). Besides the canonical separate q/k/v, a layer
may carry the runtime layouts of ``runtime/precision.py``: one fused
``qkv`` projection, and int8 projections ``{"w8": int8 (L, Cout, Cin),
"scale": fp32 (L, Cout)}`` with one scale per output channel. Every
projection goes through ``_wmat``, which takes either form. The KV cache
takes one of two forms:

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

from ...checkpoint.torch_convert import as_numpy
from ...core.layers import merge_heads, rms_norm, sdpa, split_heads
from ...ops.decode_glue import add_rms_norm, apply_rope, rope_split_kv, silu_mul, silu_mul_plain
from ...ops.flash_decode import (
    TAIL_W,
    device_position,
    flash_decode_layer_attention,
    flash_decode_layer_attention_int8,
    flash_decode_layer_attention_stats,
    kv_cache_append,
    kv_cache_quantize_write,
    quantize_kv,  # noqa: F401 -- kept here as in the JAX package (llama.py:319-329)
)
from ...parallel.tensor_parallel import copy_to_model, model_size, reduce_from_model
from ...runtime.profiling import count


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


# (config, device) -> rope_inv_freq(config) on the device: made once, so that
# no step uploads it (an upload from the host waits for the card)
_INV_FREQ = {}


def _inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    """``rope_inv_freq(cfg)`` as an fp32 tensor on ``device``, made at the
    first call for the pair and kept."""
    key = (cfg, torch.device(device))
    inv = _INV_FREQ.get(key)
    if inv is None:
        inv = _INV_FREQ[key] = torch.from_numpy(rope_inv_freq(cfg)).to(device)
    return inv


def rope_cos_sin(cfg: LlamaConfig, positions):
    """positions (B, T) -> cos, sin (B, T, head_dim) in HF half-rotate layout."""
    freqs = positions[..., None].float() * _inv_freq(cfg, positions.device)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def unstack_layers(params):
    """Every layer's parameter dict, as views of the stacked tensors. One
    ``unbind`` a tensor: under autograd its backward stacks the layers'
    gradients once, where slicing layer by layer would add a zero-padded
    (L, ...) gradient per layer."""
    n = next(iter(next(iter(params["layers"].values())).values())).shape[0]
    layers = [{} for _ in range(n)]
    for name, sub in params["layers"].items():
        for k, v in sub.items():
            for i, vi in enumerate(v.unbind(0)):
                layers[i].setdefault(name, {})[k] = vi
    return layers


def fuse_qkv_params(params):
    """The q/k/v projections concatenated into one ``qkv`` weight (L,
    3 * H * D, C): one matrix product a layer instead of three (llama.py:158-
    174). Returns a new tree; a tree already fused comes back as it is."""
    layers = dict(params["layers"])
    if "qkv" in layers:
        return params
    layers["qkv"] = {"w": torch.cat(
        [layers.pop("q")["w"], layers.pop("k")["w"], layers.pop("v")["w"]], dim=-2)}
    return {**params, "layers": layers}


def unfuse_qkv_params(params, cfg: LlamaConfig):
    """Inverse of ``fuse_qkv_params``: the canonical separate q/k/v
    (llama.py:184-196)."""
    layers = dict(params["layers"])
    if "qkv" not in layers:
        return params
    w = layers.pop("qkv")["w"]
    hd = cfg.num_attention_heads * cfg.head_dim
    kvd = cfg.num_key_value_heads * cfg.head_dim
    layers["q"] = {"w": w[..., :hd, :]}
    layers["k"] = {"w": w[..., hd:hd + kvd, :]}
    layers["v"] = {"w": w[..., hd + kvd:, :]}
    return {**params, "layers": layers}


QUANT_WEIGHT_NAMES = ("qkv", "q", "k", "v", "o", "gate_up", "gate", "up", "down")


def quantize_llama_weights(params):
    """Weight-only int8 of the projections (llama.py:202-225): each ``{"w"}``
    (L, Cout, Cin) becomes ``{"w8": int8 (L, Cout, Cin), "scale": fp32 (L,
    Cout)}``, symmetric per output channel, ``w ~= w8 * scale[..., None]``.
    The arithmetic is the JAX function's as ``jax.jit`` compiles it (the JAX
    package always runs it under jit): ``scale = max(absmax * f32(1/127),
    1e-12)`` (XLA folds the division by the constant 127 into a multiply by
    its fp32 reciprocal, as for ``quantize_kv``), ``w8 = clip(round(w /
    scale), -127, 127)`` with a true division, rounding half to even. Norm
    scales stay as they are. Apply after ``fuse_qkv_params``."""
    def quant(wp):
        w = wp["w"].float()
        scale = torch.clamp_min(w.abs().amax(dim=-1) * (1.0 / 127.0), 1e-12)
        w8 = torch.round(w / scale[..., None]).clamp(-127, 127).to(torch.int8)
        return {"w8": w8, "scale": scale}

    layers = dict(params["layers"])
    for name in QUANT_WEIGHT_NAMES:
        if name in layers and "w" in layers[name]:
            layers[name] = quant(layers[name])
    return {**params, "layers": layers}


def dequantize_llama_weights(params, dtype=torch.bfloat16):
    """Inverse of ``quantize_llama_weights`` up to the int8 rounding: the
    dense ``{"w"}`` layout, ``w8 * scale`` in fp32 cast to ``dtype``
    (llama.py:228-240)."""
    layers = dict(params["layers"])
    for name in QUANT_WEIGHT_NAMES:
        if name in layers and "w8" in layers[name]:
            wp = layers[name]
            layers[name] = {"w": (wp["w8"].float() * wp["scale"][..., None]).to(dtype)}
    return {**params, "layers": layers}


def canonicalize_llama_params(params, cfg: LlamaConfig, dtype=torch.bfloat16):
    """The canonical dense separate-q/k/v layout from any runtime layout
    (fused and/or int8), the one checkpoints address (llama.py:177-181)."""
    return unfuse_qkv_params(dequantize_llama_weights(params, dtype), cfg)


def _wmat(y, wp):
    """y @ W for a dense ``{"w"}`` or an int8 ``{"w8", "scale"}`` weight
    (llama.py:243-251). The int8 form multiplies by the weight converted to
    y's dtype and then scales the output, not the weight, in y's dtype. On
    the card that writes a converted copy of the weight every call, where
    XLA fuses the convert into the product's operand read; a fused int8
    product kernel is queued (ROADMAP)."""
    if "w8" in wp:
        return F.linear(y, wp["w8"].to(y.dtype)) * wp["scale"].to(y.dtype)
    return F.linear(y, wp["w"])


def _qkv_rows(lp, y, cfg: LlamaConfig):
    """y -> the q, k, v projections (B, T, H * D), views of the fused
    ``qkv`` product when the layer has one (llama.py:254-263)."""
    h, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    y = copy_to_model(y)
    if "qkv" in lp:
        return _wmat(y, lp["qkv"]).split([h * d, kvh * d, kvh * d], dim=-1)
    return tuple(_wmat(y, lp[n]) for n in ("q", "k", "v"))


def _qkv(lp, y, cfg: LlamaConfig):
    """y -> per-head q, k, v (B, H, T, D)."""
    q, k, v = _qkv_rows(lp, y, cfg)
    return (split_heads(q, cfg.num_attention_heads), split_heads(k, cfg.num_key_value_heads),
            split_heads(v, cfg.num_key_value_heads))


def _mlp(lp, y):
    return silu_mul_plain(_wmat(copy_to_model(y), lp["gate_up"]))


class QuantCache(NamedTuple):
    """The int8 KV cache of the decode loop (see the module docstring)."""

    values: torch.Tensor  # (L, 2, B, H, S, D) int8
    scales: torch.Tensor  # (L, 2, B, H, S) fp32; 1.0 where nothing was written
    tail: torch.Tensor  # (L, 2, B, H, TAIL_W, D) working dtype: slots [merge_base, +TAIL_W)


def llama_prefill(params, cfg: LlamaConfig, inputs_embeds, positions, attn_mask,
                  cache_len: Optional[int], cache_quant: bool = False):
    """Full-sequence causal forward writing a fresh KV cache of length
    ``cache_len``. inputs_embeds (B, T, C); positions (B, T) int; attn_mask
    (B, T) bool (True = real token) or None. Returns (hidden (B, T, C),
    cache): the cache is (L, 2, B, Hkv, cache_len, D) in the embeddings'
    dtype, or with ``cache_quant`` a ``QuantCache`` whose int8 values hold
    every prefill token (K2b, one launch), whose padding slots have scale
    1.0, and whose tail holds slots [T // TAIL_W * TAIL_W, T) in the
    embeddings' dtype. ``cache_len=None`` builds no cache and returns None
    for it: the teacher-forced training pass, where a cache would keep a
    second copy of every layer's K and V alive under autograd (the JAX
    package passes ``cache_len = T`` and XLA drops the unused cache)."""
    if cache_len is None and cache_quant:
        raise ValueError("cache_quant needs a cache_len")
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
    kvs = None if cache_len is None else torch.zeros(
        kv_shape + (t if cache_quant else cache_len, cfg.head_dim), dtype=dt, device=dev)
    x = inputs_embeds
    for i, lp in enumerate(unstack_layers(params)):
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        q, k, v = _qkv(lp, y, cfg)
        q, k = apply_rope(q, k, cos, sin)
        if kvs is not None:
            kvs[i, 0, :, :, :t] = k
            kvs[i, 1, :, :, :t] = v
        x = x + reduce_from_model(_wmat(merge_heads(sdpa(q, k, v, mask=bias)), lp["o"]))
        y = rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)
        x = x + reduce_from_model(_wmat(_mlp(lp, y), lp["down"]))
    hidden = rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
    if not cache_quant:
        return hidden, kvs
    values = torch.zeros(kv_shape + (cache_len, cfg.head_dim), dtype=torch.int8, device=dev)
    scales = torch.ones(kv_shape + (cache_len,), dtype=torch.float32, device=dev)
    kv_cache_quantize_write(values, scales, kvs, t - 1)  # slots [0, t)
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
    # the mean over every head: under tensor parallelism this rank holds
    # H / model_size of them
    return reduce_from_model(p.sum(dim=1)) / (p.shape[1] * model_size())


def llama_decode_step(params, cfg: LlamaConfig, x, cache, write_pos, positions,
                      row_prefix, gap_end: int, layers=None, align_layer: Optional[int] = None,
                      text_slice: Optional[Tuple[int, int]] = None):
    """One-token incremental forward. x (B, 1, C); cache (the tensor or a
    ``QuantCache``) holding valid slots [0, write_pos); write_pos a (1,)
    int32 tensor on the cache's device, which the kernels read there (no
    launch depends on its value on the host, so a CUDA graph can replay the
    step), or an int, uploaded once (``device_position``); positions (B, 1)
    rope positions; row_prefix (B,) int32 and gap_end give slot validity
    (see K1). The current token attends to itself as an explicit
    self-logit, its stale slot ``write_pos`` is excluded (cur_len =
    write_pos), and after the layer loop every layer's new K/V is written at
    ``write_pos`` in place (into the tail on the int8 path, which is merged
    into the int8 cache when ``write_pos + 1`` closes a group of TAIL_W).
    The caller checks that the cache holds slot ``write_pos``.

    ``align_layer`` (with ``text_slice``, the cache slots of the text) asks
    for that layer's head-mean attention over the text: K1b runs there and
    the probabilities are rebuilt from its stats. It needs the working-dtype
    cache and as many KV heads as query heads; a ValueError names what is
    missing. ``layers`` may pass the per-layer parameter dicts prebuilt.
    Returns (hidden (B, 1, C), the text attention (B, hi - lo) fp32 or
    None); the cache is updated in place.

    A layer's glue is three functions of ``ops/decode_glue.py``: the
    residual add with the norm after it (``add_rms_norm``; the last
    ``down`` add goes into the final norm), rope with the K/V written into
    the step's ``new_kv`` (``rope_split_kv``), and the MLP's activation
    (``silu_mul``). On the card they are the kernels, a layer then
    launching 9 times (with int8 weights, 3 more a projection), and each
    call counts the layers as ``t3.glue_fused_layers``; on the CPU their
    plain versions, the eager chain."""
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
    write_pos = device_position(write_pos, x.device)
    if layers is None:
        layers = unstack_layers(params)
    kv_dtype = cache.tail.dtype if quant else cache.dtype
    new_kv = torch.empty((cfg.num_hidden_layers, 2, b, cfg.num_key_value_heads, d),
                         dtype=kv_dtype, device=x.device)
    eps = cfg.rms_norm_eps
    attn = r = None  # r: the last projection's output, not yet added to x
    for i, lp in enumerate(layers):
        x, y = add_rms_norm(x, r, lp["input_ln"]["scale"], eps)
        q1 = rope_split_kv(*_qkv_rows(lp, y, cfg), cos, sin, new_kv, i)
        k1, v1 = new_kv[i, 0], new_kv[i, 1]
        if quant:
            a = flash_decode_layer_attention_int8(
                cache.values, cache.scales, cache.tail, None, i, write_pos, row_prefix,
                gap_end, q1, k1, v1)
        elif i == align_layer:
            a, m, l = flash_decode_layer_attention_stats(
                cache, i, write_pos, row_prefix, gap_end, q1, k1, v1)
            attn = _text_probs(cache, i, q1, m, l, text_slice, row_prefix)
        else:
            a = flash_decode_layer_attention(cache, i, write_pos, row_prefix, gap_end, q1, k1, v1)
        r = reduce_from_model(_wmat(a.reshape(b, 1, h * d), lp["o"]))
        x, y = add_rms_norm(x, r, lp["post_ln"]["scale"], eps)
        r = reduce_from_model(_wmat(silu_mul(_wmat(copy_to_model(y), lp["gate_up"])), lp["down"]))
    kv_cache_write(cache, new_kv, write_pos)
    if x.device.type == "cuda":
        count("t3.glue_fused_layers", len(layers))
    return add_rms_norm(x, r, params["final_ln"]["scale"], eps)[1], attn


def kv_cache_write(cache, new_kv, write_pos):
    """Write one decode step's K/V of every layer (L, 2, B, H, D) at slot
    ``write_pos`` (``device_position``), in place: into the cache tensor
    (K2), or into the tail of a ``QuantCache`` (K2, at slot ``write_pos %
    TAIL_W``), whose full group of TAIL_W K2b then quantizes into the int8
    cache: K2b is launched every step and writes only when ``write_pos + 1``
    closes the group."""
    write_pos = device_position(write_pos, new_kv.device)
    if not isinstance(cache, QuantCache):
        kv_cache_append(cache, new_kv, write_pos)
        return
    kv_cache_append(cache.tail, new_kv, write_pos)
    kv_cache_quantize_write(cache.values, cache.scales, cache.tail, write_pos)


def convert_llama(sd, cfg: LlamaConfig, prefix="tfmr."):
    """HF ``LlamaModel`` state dict -> the JAX package's stacked tree (numpy,
    (L, Cin, Cout) weights; ``gate_up`` the gate and up projections side by
    side), as ``chatterbox_tpu/models/t3/llama.py::convert_llama``."""
    def stack(fmt, transpose=True):
        ws = [as_numpy(sd[fmt.format(i=i)]) for i in range(cfg.num_hidden_layers)]
        return np.stack([w.T if transpose else w for w in ws])

    layer = prefix + "layers.{i}."
    return {
        "layers": {
            "input_ln": {"scale": stack(layer + "input_layernorm.weight", False)},
            "q": {"w": stack(layer + "self_attn.q_proj.weight")},
            "k": {"w": stack(layer + "self_attn.k_proj.weight")},
            "v": {"w": stack(layer + "self_attn.v_proj.weight")},
            "o": {"w": stack(layer + "self_attn.o_proj.weight")},
            "post_ln": {"scale": stack(layer + "post_attention_layernorm.weight", False)},
            "gate_up": {"w": np.concatenate([stack(layer + "mlp.gate_proj.weight"),
                                             stack(layer + "mlp.up_proj.weight")], axis=-1)},
            "down": {"w": stack(layer + "mlp.down_proj.weight")},
        },
        "final_ln": {"scale": as_numpy(sd[prefix + "norm.weight"])},
    }
