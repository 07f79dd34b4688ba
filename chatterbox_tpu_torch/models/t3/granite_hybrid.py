"""Granite 4.0-H backbone of T3: Mamba-2 layers and NoPE grouped-query
attention layers in one stack, in place of the Llama.

The layer equations are HF transformers' ``GraniteMoeHybrid``
(``modeling_granitemoehybrid.py``) without experts (``num_local_experts =
0``), at the published widths of ``ibm-granite/granite-4.0-h-micro``
(``GRANITE_4_0_H_MICRO``): 40 layers of hidden 2048, of which 0-based 5,
15, 25 and 35 attend (32 query heads and 8 KV heads of 64, no position
embedding, softmax scale ``attention_multiplier``) and the other 36 are
Mamba-2 mixers (64 heads of 64, state 128, one group, a causal depthwise
conv of width 4 with bias), each mixer followed by a SwiGLU MLP of 8192.
Every sub-layer adds ``residual_multiplier`` times its output to the
residual; the inputs are scaled by ``embedding_multiplier`` before layer 0.
T3's heads divide their logits by ``logits_scaling`` (``models/t3/t3.py``).

A Mamba-2 layer, per row and head h, on the normed input u:

    z, xBC, dt = split(in_proj(u), [d_inner, conv_dim, n_heads])
    xBC = silu(causal_conv1d(xBC) + conv_b);  x, B, C = split(xBC, [d_inner, N, N])
    dt = softplus(dt + dt_bias);  A = -exp(A_log)
    h_t = exp(dt A) h_{t-1} + dt x (x) B;  y = h_t C + D x
    out = out_proj(rmsnorm_w(y * silu(z)))      (normed over all d_inner channels)

The prefill runs the recurrence in Mamba-2's chunked (SSD) form
(``ssd_chunked``, ``ssd_minimal``'s algebra, chunks of ``mamba_chunk_size``)
in fp32; the decode step runs one launch of ``ssm_decode_update`` a Mamba
layer. T3's layout ``[cond; right-padded text; BOS BOS]`` has a gap of pads
in mid-sequence, which a recurrence and a causal conv cannot skip: the Mamba
layers gather each row's valid positions to its front, with ``dt = 0`` and
``x = 0`` past its length (the state stays as it is), and scatter their
outputs back. The attention layers keep T3's layout: without positions the
slot order does not matter to them, and K1 masks the gap at read time.

The decode carry holds, beside the attention layers' KV cache (La, 2, B,
Hkv, S, D), the ``SSMState``: the conv inputs of each row's last
``d_conv - 1`` tokens (Lm, B, conv_dim, d_conv - 1) in the working dtype and
the recurrent state (Lm, B, H, P, N) in fp32, both written in place.

Parameters, linear weights (Cout, Cin), stacked by kind: ``layers`` holds
what every layer has (the two norms, ``gate_up`` (L, 2F, C) and ``down``),
``mamba`` the Mamba layers' mixers in layer order, ``attention`` the
attention layers' q/k/v/o, and ``final_ln``.
"""

import math
from dataclasses import dataclass
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ...core.layers import merge_heads, rms_norm, sdpa, split_heads
from ...ops.flash_decode import device_position, flash_decode_layer_attention, kv_cache_append
from ...ops.ssm_decode import ssm_decode_update
from ...runtime.profiling import annotate

MAMBA, ATTENTION = "mamba", "attention"
_MICRO_ATTENTION = (5, 15, 25, 35)


@dataclass(frozen=True)
class GraniteHybridConfig:
    """The published keys of a Granite 4.0-H config that the backbone reads
    (``intermediate_size`` is the shared MLP's, ``shared_intermediate_size``)."""

    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 40
    layer_types: Tuple[str, ...] = tuple(ATTENTION if i in _MICRO_ATTENTION else MAMBA
                                         for i in range(40))
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    attention_multiplier: float = 0.015625
    mamba_n_heads: int = 64
    mamba_d_head: int = 64
    mamba_d_state: int = 128
    mamba_n_groups: int = 1
    mamba_d_conv: int = 4
    mamba_chunk_size: int = 256
    embedding_multiplier: float = 12.0
    residual_multiplier: float = 0.22
    logits_scaling: float = 8.0
    rms_norm_eps: float = 1e-5

    def __post_init__(self):
        if len(self.layer_types) != self.num_hidden_layers or \
                set(self.layer_types) - {MAMBA, ATTENTION}:
            raise ValueError(f"layer_types must name {self.num_hidden_layers} layers, each "
                             f"{MAMBA!r} or {ATTENTION!r}")
        if self.mamba_n_groups != 1:
            raise ValueError("the Granite backbone takes one Mamba group (mamba_n_groups = 1)")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def d_inner(self) -> int:
        return self.mamba_n_heads * self.mamba_d_head

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.mamba_n_groups * self.mamba_d_state

    @property
    def in_proj_dim(self) -> int:
        return self.d_inner + self.conv_dim + self.mamba_n_heads

    @property
    def mamba_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == MAMBA)

    @property
    def attention_layers(self) -> Tuple[int, ...]:
        return tuple(i for i, t in enumerate(self.layer_types) if t == ATTENTION)


GRANITE_4_0_H_MICRO = GraniteHybridConfig()


class SSMState(NamedTuple):
    """The Mamba layers' decode state (see the module docstring)."""

    conv: torch.Tensor  # (Lm, B, conv_dim, d_conv - 1) working dtype: raw conv inputs
    ssm: torch.Tensor  # (Lm, B, H, P, N) fp32


def state_bytes_per_row(cfg: GraniteHybridConfig, itemsize: int) -> int:
    """Bytes of one row's ``SSMState``: the conv inputs in the working dtype
    (``itemsize``) and the fp32 recurrent state, over every Mamba layer."""
    conv = cfg.conv_dim * (cfg.mamba_d_conv - 1) * itemsize
    ssm = cfg.mamba_n_heads * cfg.mamba_d_head * cfg.mamba_d_state * 4
    return len(cfg.mamba_layers) * (conv + ssm)


def init_granite_hybrid(r, cfg: GraniteHybridConfig):
    """Random parameters with ``weights._Init``'s draws: linears N(0, 0.02),
    norms 1, ``A_log`` log(1..16), ``dt_bias`` the inverse softplus of a dt
    in [1e-3, 0.1], ``D`` 1 (Mamba-2's own initialisation)."""
    n_l, c, f = cfg.num_hidden_layers, cfg.hidden_size, cfg.intermediate_size
    n_m, n_a = len(cfg.mamba_layers), len(cfg.attention_layers)
    h, hq = cfg.mamba_n_heads, cfg.num_attention_heads * cfg.head_dim
    hkv = cfg.num_key_value_heads * cfg.head_dim
    dt = torch.exp(r.uniform((n_m, h), math.log(1e-3), math.log(0.1)).float())
    return {
        "layers": {
            "input_ln": {"scale": r.ones((n_l, c))},
            "post_ln": {"scale": r.ones((n_l, c))},
            "gate_up": {"w": r.normal((n_l, 2 * f, c), 0.02)},
            "down": {"w": r.normal((n_l, c, f), 0.02)},
        },
        "mamba": {
            "in_proj": {"w": r.normal((n_m, cfg.in_proj_dim, c), 0.02)},
            "conv": {"w": r.normal((n_m, cfg.conv_dim, cfg.mamba_d_conv), 0.5),
                     "b": r.zeros((n_m, cfg.conv_dim))},
            "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(r.dtype),
            "A_log": torch.log(r.uniform((n_m, h), 1.0, 16.0).float()).to(r.dtype),
            "D": r.ones((n_m, h)),
            "norm": {"scale": r.ones((n_m, cfg.d_inner))},
            "out_proj": {"w": r.normal((n_m, c, cfg.d_inner), 0.02)},
        },
        "attention": {
            "q": {"w": r.normal((n_a, hq, c), 0.02)},
            "k": {"w": r.normal((n_a, hkv, c), 0.02)},
            "v": {"w": r.normal((n_a, hkv, c), 0.02)},
            "o": {"w": r.normal((n_a, c, hq), 0.02)},
        },
        "final_ln": {"scale": r.ones((c,))},
    }


def granite_layers(params, cfg: GraniteHybridConfig):
    """Each layer's parameters in layer order, as views of the stacks: the
    layer's ``kind``, its ``index`` within its kind's stack, the shared
    norms and MLP, and its mixer's weights; a Mamba layer's small vectors
    (conv weight and bias, ``dt_bias``, ``A = -exp(A_log)``, ``D``) in fp32,
    contiguous, as the update kernel reads them. Made once a carry."""
    common = params["layers"]
    m, a = params["mamba"], params["attention"]
    out = []
    counters = {MAMBA: 0, ATTENTION: 0}
    for i, kind in enumerate(cfg.layer_types):
        j = counters[kind]
        counters[kind] += 1
        lp = {"kind": kind, "index": j,
              "input_ln": {"scale": common["input_ln"]["scale"][i]},
              "post_ln": {"scale": common["post_ln"]["scale"][i]},
              "gate_up": common["gate_up"]["w"][i], "down": common["down"]["w"][i]}
        if kind == MAMBA:
            lp.update(in_proj=m["in_proj"]["w"][j], out_proj=m["out_proj"]["w"][j],
                      norm=m["norm"]["scale"][j],
                      conv_w=m["conv"]["w"][j].float().contiguous(),
                      conv_b=m["conv"]["b"][j].float().contiguous(),
                      dt_bias=m["dt_bias"][j].float().contiguous(),
                      A=(-torch.exp(m["A_log"][j].float())).contiguous(),
                      D=m["D"][j].float().contiguous())
        else:
            lp.update({n: a[n]["w"][j] for n in ("q", "k", "v", "o")})
        out.append(lp)
    return out


def _mlp(lp, y):
    g, u = F.linear(y, lp["gate_up"]).chunk(2, dim=-1)
    return F.linear(F.silu(g) * u, lp["down"])


def gated_rms_norm(scale, y, z, eps: float):
    """``MambaRMSNormGated`` with one group: (y * silu(z)) normed over its
    last axis in fp32, cast to the scale's dtype, times the scale."""
    g = y.float() * F.silu(z.float())
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + eps)
    return scale * g.to(scale.dtype)


def segsum(a):
    """(..., T) -> (..., T, T): [i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal (``ssd_minimal``'s stable segment sum)."""
    t = a.shape[-1]
    x = a[..., None].expand(*a.shape, t)
    below = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device), -1)
    x = x.masked_fill(~below, 0.0).cumsum(dim=-2)
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=a.device))
    return x.masked_fill(~keep, float("-inf"))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """The Mamba-2 recurrence over a whole sequence from a zero state, in
    the chunked (SSD) form of ``ssd_minimal``: x (b, t, h, p), dt (b, t, h),
    A (h,), B and C (b, t, n) (one group), all fp32. Chunks of ``chunk``
    positions (one chunk of t when t is shorter); the last is padded with
    dt = 0, which leaves the state as it is. Returns (y (b, t, h, p) without
    the D skip, the final state (b, h, p, n))."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    ln = min(chunk, t)
    pad = -t % ln
    if pad:
        x, B, C = (F.pad(v, (0, 0) * (v.ndim - 2) + (0, pad)) for v in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    c = (t + pad) // ln
    X = (x * dt[..., None]).view(b, c, ln, h, p)
    a = (dt * A).view(b, c, ln, h).permute(0, 3, 1, 2)  # (b, h, c, l)
    Bc, Cc = B.view(b, c, ln, n), C.view(b, c, ln, n)
    a_cum = a.cumsum(dim=-1)
    # 1. within each chunk
    decay = torch.exp(segsum(a)) * torch.einsum("bcln,bcsn->bcls", Cc, Bc)[:, None]
    y = torch.einsum("bhcls,bcshp->bclhp", decay, X)
    # 2. each chunk's state from its own inputs
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, torch.exp(a_cum[..., -1:] - a_cum), X)
    # 3. the states across chunks
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)
    # 4. the earlier chunks' state into each position's output
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states[:, :-1], torch.exp(a_cum))
    return y.reshape(b, c * ln, h, p)[:, :t], states[:, -1]


def _mamba_prefill(lp, cfg: GraniteHybridConfig, y, order, inv, live, n_valid, conv_out,
                   ssm_out):
    """A Mamba layer over each row's valid positions (gathered to the front
    by ``order``; ``live`` marks them there), writing the layer's decode
    state (the last d_conv - 1 raw conv inputs, the final recurrent state)
    into ``conv_out`` and ``ssm_out``; returns the output in T3's layout,
    zero at the pads."""
    b, t, _ = y.shape
    di, hh, pp, nn = cfg.d_inner, cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state
    k = cfg.mamba_d_conv
    zxbcdt = F.linear(torch.take_along_dim(y, order[..., None], dim=1), lp["in_proj"])
    z, xbc, dt = zxbcdt.split([di, cfg.conv_dim, hh], dim=-1)
    # the raw inputs of each row's last k - 1 valid positions (zero before its start)
    idx = n_valid[:, None] - (k - 1) + torch.arange(k - 1, device=y.device)[None]
    last = torch.take_along_dim(xbc, idx.clamp_min(0)[..., None], dim=1)
    conv_out.copy_((last * (idx >= 0)[..., None]).transpose(1, 2))
    xc = F.conv1d(xbc.float().transpose(1, 2), lp["conv_w"][:, None], lp["conv_b"],
                  padding=k - 1, groups=cfg.conv_dim)[..., :t].transpose(1, 2)
    x, B, C = F.silu(xc).split([di, nn, nn], dim=-1)
    dt = torch.where(live[..., None], F.softplus(dt.float() + lp["dt_bias"]), 0.0)
    x = torch.where(live[..., None], x, 0.0).reshape(b, t, hh, pp)
    with annotate("t3.ssm_prefill"):
        ys, final = ssd_chunked(x, dt, lp["A"], B, C, cfg.mamba_chunk_size)
    ssm_out.copy_(final)
    ys = (ys + lp["D"][:, None] * x).reshape(b, t, di)
    out = F.linear(gated_rms_norm(lp["norm"], ys, z, cfg.rms_norm_eps), lp["out_proj"])
    return torch.take_along_dim(out * live[..., None], inv[..., None], dim=1)


def granite_prefill(params, cfg: GraniteHybridConfig, inputs_embeds, valid, cache_len: int):
    """The causal forward over T3's prefill: inputs_embeds (B, T, C), valid
    (B, T) bool (True = real token). Returns (hidden (B, T, C), the
    attention layers' KV cache (La, 2, B, Hkv, cache_len, D) in the
    embeddings' dtype holding slots [0, T), the ``SSMState`` after each
    row's last valid token). Pads are masked out of the attention keys and
    skipped by the Mamba layers."""
    b, t, _ = inputs_embeds.shape
    dev, dt = inputs_embeds.device, inputs_embeds.dtype
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    keep = torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev))[None, None]
    keep = keep & valid[:, None, None, :]
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    inv = torch.argsort(order, dim=1)
    n_valid = valid.sum(dim=1)
    live = torch.arange(t, device=dev)[None] < n_valid[:, None]
    cache = torch.zeros((len(cfg.attention_layers), 2, b, hkv, cache_len, d), dtype=dt, device=dev)
    state = SSMState(
        torch.zeros((len(cfg.mamba_layers), b, cfg.conv_dim, cfg.mamba_d_conv - 1), dtype=dt,
                    device=dev),
        torch.zeros((len(cfg.mamba_layers), b, cfg.mamba_n_heads, cfg.mamba_d_head,
                     cfg.mamba_d_state), dtype=torch.float32, device=dev))
    rm = cfg.residual_multiplier
    x = inputs_embeds * cfg.embedding_multiplier
    for lp in granite_layers(params, cfg):
        j = lp["index"]
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)
        if lp["kind"] == MAMBA:
            out = _mamba_prefill(lp, cfg, y, order, inv, live, n_valid, state.conv[j],
                                 state.ssm[j])
        else:
            q = split_heads(F.linear(y, lp["q"]), hq)
            k, v = (split_heads(F.linear(y, lp[n]), hkv) for n in ("k", "v"))
            cache[j, 0, :, :, :t] = k
            cache[j, 1, :, :, :t] = v
            k, v = (u.repeat_interleave(hq // hkv, dim=1) for u in (k, v))
            a = sdpa(q, k, v, mask=keep, scale=cfg.attention_multiplier)
            out = F.linear(merge_heads(a), lp["o"])
        x = x + out * rm
        x = x + _mlp(lp, rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)) * rm
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps), cache, state


def granite_decode_step(params, cfg: GraniteHybridConfig, x, cache, state: SSMState, write_pos,
                        row_prefix, gap_end: int, layers=None):
    """One-token forward. x (B, 1, C); cache the attention layers' KV cache
    holding valid slots [0, write_pos) (K1a reads it with a query-head group
    of Hq / Hkv, slot validity from ``row_prefix`` and ``gap_end`` as in
    ``llama_decode_step``); state the ``SSMState``; write_pos a (1,) int32
    device tensor or an int. Each Mamba layer's update (``ssm_decode_update``,
    one launch) advances its conv inputs and recurrent state in place; after
    the layer loop the attention layers' new K/V go to slot ``write_pos``
    (K2). Nothing here reads a value on the host. Returns hidden (B, 1, C)."""
    b = x.shape[0]
    hq, hkv, d = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.head_dim
    write_pos = device_position(write_pos, x.device)
    layers = layers or granite_layers(params, cfg)
    new_kv = torch.empty((len(cfg.attention_layers), 2, b, hkv, d), dtype=cache.dtype,
                         device=x.device)
    rm = cfg.residual_multiplier
    x = x * cfg.embedding_multiplier
    for lp in layers:
        j = lp["index"]
        y = rms_norm(lp["input_ln"], x, cfg.rms_norm_eps)[:, 0]
        if lp["kind"] == MAMBA:
            zxbcdt = F.linear(y, lp["in_proj"])
            with annotate("t3.ssm_update"):
                ys = ssm_decode_update(state.conv, state.ssm, j, zxbcdt, lp["conv_w"],
                                       lp["conv_b"], lp["dt_bias"], lp["A"], lp["D"])
            out = F.linear(gated_rms_norm(lp["norm"], ys, zxbcdt[:, :cfg.d_inner],
                                          cfg.rms_norm_eps), lp["out_proj"])
        else:
            q = F.linear(y, lp["q"]).view(b, hq, d)
            k, v = (F.linear(y, lp[n]).view(b, hkv, d) for n in ("k", "v"))
            a = flash_decode_layer_attention(cache, j, write_pos, row_prefix, gap_end, q, k, v,
                                             scale=cfg.attention_multiplier)
            out = F.linear(a.reshape(b, hq * d), lp["o"])
            new_kv[j, 0] = k
            new_kv[j, 1] = v
        x = x + out[:, None] * rm
        x = x + _mlp(lp, rms_norm(lp["post_ln"], x, cfg.rms_norm_eps)) * rm
    kv_cache_append(cache, new_kv, write_pos)
    return rms_norm(params["final_ln"], x, cfg.rms_norm_eps)
