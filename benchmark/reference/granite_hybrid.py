"""T3 on the Granite 4.0-H backbone, plain: the conditioning prefix and the
backbone as one causal forward over [cond; text; BOS; BOS; speech], one
text at a time, with no KV cache, no padding, no chunked scan and no
kernel.

The backbone is HF transformers' ``GraniteMoeHybrid`` without experts
(``modeling_granitemoehybrid.py``; ``ibm-granite/granite-4.0-h-micro``'s
``config.json``): each layer adds ``residual_multiplier`` times its mixer
(a Mamba-2 layer, or NoPE grouped-query attention with the softmax scale
``attention_multiplier``) on the RMS-normed input, then the same multiple
of a SwiGLU MLP on the RMS-normed result. A Mamba-2 layer runs its
recurrence token by token:

    z, xBC, dt = split(in_proj(u));  xBC = silu(causal_conv1d(xBC) + b)
    x, B, C = split(xBC);  dt = softplus(dt + dt_bias);  A = -exp(A_log)
    h_t = exp(dt A) h_{t-1} + dt x (x) B;  y_t = h_t C + D x
    out = out_proj(rmsnorm_w(y * silu(z)))

Departures from the published model, each a choice of the configuration
(``benchmark/configs/chatterbox-tts-granite4h-micro.json``, ``assumed``):
T3's own text and speech vocabularies and heads replace the 100352-row
embedding and LM head; the ``embedding_multiplier`` scales T3's input
embeddings (the conditioning prefix, the text and the speech tokens); T3's
speech head divides by ``logits_scaling``; weights come from a seed.

Served as the program's weights are given (the port's layouts: linears
(Cout, Cin), stacked by kind under ``granite``: ``layers`` (the norms and
the MLP, every layer), ``mamba`` and ``attention``). Arithmetic runs in the
parameters' dtype, with the norms' statistics, the softmax, the recurrence,
the gated norm and the logits in fp32; the recurrent state is fp32, or with
``state_dtype`` rounded to that dtype after every token (the control's
bf16 state). Run it with TF32 off (``precision.tf32(False)``).
"""

from dataclasses import dataclass, field
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import merge_heads, split_heads
from .t3 import cond_prefix as _cond_prefix
from .t3 import punc_norm, text_ids  # noqa: F401 -- the same text framing as T3's


@dataclass(frozen=True)
class GraniteConfig:
    hidden_size: int = 2048
    intermediate_size: int = 8192
    num_hidden_layers: int = 40
    layer_types: Tuple[str, ...] = tuple("attention" if i in (5, 15, 25, 35) else "mamba"
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


@dataclass(frozen=True)
class T3Config:
    start_text_token: int = 255
    stop_text_token: int = 0
    text_tokens_dict_size: int = 704
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    speech_tokens_dict_size: int = 8194
    speech_cond_prompt_len: int = 150
    speaker_embed_size: int = 256
    perceiver_heads: int = 4
    granite: GraniteConfig = field(default_factory=GraniteConfig)


def _rms_norm(scale, x, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale


def _mamba(m, i: int, cfg: GraniteConfig, u, state_dtype):
    """Mamba layer ``i`` of the stack ``m`` on u (R, T, C), every row's T
    positions real; the recurrence one token at a time."""
    r, t, _ = u.shape
    h, p, n, k = cfg.mamba_n_heads, cfg.mamba_d_head, cfg.mamba_d_state, cfg.mamba_d_conv
    di = h * p
    zxbcdt = F.linear(u, m["in_proj"]["w"][i])
    z, xbc, dt = zxbcdt.split([di, di + 2 * n, h], dim=-1)
    w = m["conv"]["w"][i].float()
    xc = F.conv1d(F.pad(xbc.float().transpose(1, 2), (k - 1, 0)), w[:, None],
                  m["conv"]["b"][i].float(), groups=w.shape[0]).transpose(1, 2)
    x, B, C = F.silu(xc).split([di, n, n], dim=-1)
    x = x.reshape(r, t, h, p)
    dt = F.softplus(dt.float() + m["dt_bias"][i].float())
    A = -torch.exp(m["A_log"][i].float())
    s = torch.zeros((r, h, p, n), dtype=torch.float32, device=u.device)
    ys = []
    for j in range(t):
        s = (torch.exp(dt[:, j] * A)[..., None, None] * s
             + (dt[:, j, :, None] * x[:, j])[..., None] * B[:, j, None, None, :])
        if state_dtype is not None:
            s = s.to(state_dtype).float()
        ys.append(torch.einsum("rhpn,rn->rhp", s, C[:, j]))
    y = torch.stack(ys, dim=1) + m["D"][i].float()[:, None] * x
    g = y.reshape(r, t, di) * F.silu(z.float())
    g = g * torch.rsqrt(torch.mean(g * g, dim=-1, keepdim=True) + cfg.rms_norm_eps)
    g = m["norm"]["scale"][i] * g.to(u.dtype)
    return F.linear(g, m["out_proj"]["w"][i])


def _attention(a, i: int, cfg: GraniteConfig, u):
    """Attention layer ``i`` of the stack ``a``: causal, no positions, K/V
    heads repeated for their query groups."""
    t = u.shape[1]
    hq, hkv = cfg.num_attention_heads, cfg.num_key_value_heads
    q = split_heads(F.linear(u, a["q"]["w"][i]), hq)
    k, v = (split_heads(F.linear(u, a[nm]["w"][i]), hkv).repeat_interleave(hq // hkv, dim=1)
            for nm in ("k", "v"))
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * cfg.attention_multiplier
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=u.device))
    probs = torch.softmax(logits.masked_fill(~causal, float("-inf")), dim=-1)
    return F.linear(merge_heads(torch.matmul(probs, v.float()).to(u.dtype)), a["o"]["w"][i])


def granite_forward(p, cfg: GraniteConfig, x, state_dtype=None):
    """(R, T, C) input embeddings, every position real -> final-normed
    hidden (R, T, C)."""
    lay, rm, eps = p["layers"], cfg.residual_multiplier, cfg.rms_norm_eps
    x = x * cfg.embedding_multiplier
    counters = {"mamba": 0, "attention": 0}
    for li, kind in enumerate(cfg.layer_types):
        j = counters[kind]
        counters[kind] += 1
        u = _rms_norm(lay["input_ln"]["scale"][li], x, eps)
        out = (_mamba(p["mamba"], j, cfg, u, state_dtype) if kind == "mamba"
               else _attention(p["attention"], j, cfg, u))
        x = x + out * rm
        u = _rms_norm(lay["post_ln"]["scale"][li], x, eps)
        g, up = F.linear(u, lay["gate_up"]["w"][li]).chunk(2, dim=-1)
        x = x + F.linear(F.silu(g) * up, lay["down"]["w"][li]) * rm
    return _rms_norm(p["final_ln"]["scale"], x, eps)


def cond_prefix(p, cfg: T3Config, speaker_emb, prompt_tokens, emotion_adv):
    """T3's conditioning prefix (1, 34, C), as ``reference/t3.py`` makes it."""
    return _cond_prefix(p, cfg, speaker_emb, prompt_tokens, emotion_adv)


def t3_step_logits(p, cfg: T3Config, cond, text_ids_, speech_tokens, cfg_weight: float,
                   state_dtype=None):
    """One text's CFG-combined fp32 logits (N, V) at each decode step, given
    its conditioning prefix ``cond`` (1, 34, C), its framed text ids (L,)
    and its N served tokens (the last one is never fed back); both CFG
    streams (the unconditional one with the text's token embeddings zero)
    run as two rows of one forward."""
    n = speech_tokens.shape[0]
    w = p["speech_emb"]["w"]
    text_pos = p["text_pos_emb"]["w"][: text_ids_.shape[0]]
    text = F.embedding(text_ids_.long(), p["text_emb"]["w"]) + text_pos
    bos_id = torch.tensor([cfg.start_speech_token], device=w.device)
    bos = F.embedding(bos_id, w) + p["speech_pos_emb"]["w"][:1]
    fed = F.embedding(speech_tokens[: n - 1].long(), w) + p["speech_pos_emb"]["w"][1:n]
    tail = torch.cat([bos, bos, fed], dim=0)
    rows = [torch.cat([cond[0], text, tail], dim=0), torch.cat([cond[0], text_pos, tail], dim=0)]
    hidden = granite_forward(p["granite"], cfg.granite, torch.stack(rows), state_dtype)
    first = cond.shape[1] + text_ids_.shape[0] + 1  # the second BOS
    logits = F.linear(hidden[:, first:first + n], p["speech_head"]["w"],
                      p["speech_head"].get("b")).float() / cfg.granite.logits_scaling
    return logits[0] + cfg_weight * (logits[0] - logits[1])
