"""T3, plain: the conditioning prefix and the Llama backbone as one causal
forward over [cond; text; BOS; BOS; speech], with no KV cache, no padding
and no batching across texts.

The served tokens of a text are fed back as its speech positions (teacher
forcing), so one forward gives the logits the decode loop saw at every
step: position BOS2 predicts token 0, speech position j predicts token
j + 1. Both CFG streams run: the unconditional one keeps the text's
positional embeddings and zeroes its token embeddings (reference
t3/t3.py). Parameters are the canonical tree in the port's layouts:
stacked layers (L, Cout, Cin) with separate q/k/v and ``gate_up`` the gate
and up projections stacked on Cout. Arithmetic runs in the parameters'
dtype, with RMSNorm statistics, the attention softmax and the logits in
fp32.
"""

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from .layers import layer_norm, linear, merge_heads, sdpa, split_heads


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
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192


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
    llama: LlamaConfig = field(default_factory=LlamaConfig)


def rope_inv_freq(cfg: LlamaConfig) -> np.ndarray:
    """The llama3 rope scaling of HF transformers (modeling_rope_utils)."""
    d = cfg.head_dim
    inv_freq = 1.0 / (cfg.rope_theta ** (np.arange(0, d, 2, dtype=np.float64) / d))
    low_wavelen = cfg.rope_original_max_position / cfg.rope_low_freq_factor
    high_wavelen = cfg.rope_original_max_position / cfg.rope_high_freq_factor
    wavelen = 2.0 * np.pi / inv_freq
    scaled = np.where(wavelen > low_wavelen, inv_freq / cfg.rope_scaling_factor, inv_freq)
    smooth = (cfg.rope_original_max_position / wavelen - cfg.rope_low_freq_factor) / (
        cfg.rope_high_freq_factor - cfg.rope_low_freq_factor)
    smoothed = (1.0 - smooth) * inv_freq / cfg.rope_scaling_factor + smooth * inv_freq
    is_medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
    return np.where(is_medium, smoothed, scaled).astype(np.float32)


def _rope(x, cos, sin):
    d = x.shape[-1] // 2
    rot = torch.cat([-x[..., d:], x[..., :d]], dim=-1)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


def _rms_norm(scale, x, eps):
    x32 = x.float()
    y = x32 * torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return y.to(x.dtype) * scale


def llama_forward(p, cfg: LlamaConfig, x):
    """(B, S, C) embeddings at positions 0..S-1 -> final-normed hidden (B, S, C),
    causal attention over all S."""
    s = x.shape[1]
    pos = torch.arange(s, device=x.device, dtype=torch.float32)
    freqs = pos[:, None] * torch.from_numpy(rope_inv_freq(cfg)).to(x.device)[None]
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb)[None, None], torch.sin(emb)[None, None]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=x.device))[None, None]
    h, kvh = cfg.num_attention_heads, cfg.num_key_value_heads
    lay = p["layers"]
    for i in range(cfg.num_hidden_layers):
        y = _rms_norm(lay["input_ln"]["scale"][i], x, cfg.rms_norm_eps)
        q = _rope(split_heads(F.linear(y, lay["q"]["w"][i]), h), cos, sin)
        k = _rope(split_heads(F.linear(y, lay["k"]["w"][i]), kvh), cos, sin)
        v = split_heads(F.linear(y, lay["v"]["w"][i]), kvh)
        if kvh != h:
            k, v = (t.repeat_interleave(h // kvh, dim=1) for t in (k, v))
        x = x + F.linear(merge_heads(sdpa(q, k, v, mask=causal)), lay["o"]["w"][i])
        y = _rms_norm(lay["post_ln"]["scale"][i], x, cfg.rms_norm_eps)
        g, u = F.linear(y, lay["gate_up"]["w"][i]).chunk(2, dim=-1)
        x = x + F.linear(F.silu(g) * u, lay["down"]["w"][i])
    return _rms_norm(p["final_ln"]["scale"], x, cfg.rms_norm_eps)


def _attention_block(p, x1, x2, n_heads):
    q = linear(p["to_q"], layer_norm(p["norm"], x1))
    x2n = layer_norm(p["norm"], x2)
    k, v = linear(p["to_k"], x2n), linear(p["to_v"], x2n)
    a = sdpa(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads))
    return x1 + linear(p["proj_out"], merge_heads(a))


def cond_prefix(p, cfg: T3Config, speaker_emb, prompt_tokens, emotion_adv):
    """(1, 256), (1, P) int, (1,) -> (1, 34, C): the speaker projection, the
    perceiver over the embedded prompt (32 queries, cross then self
    attention with one shared block) and the emotion projection."""
    dt = p["speech_emb"]["w"].dtype
    prompt = (F.embedding(prompt_tokens.long(), p["speech_emb"]["w"])
              + p["speech_pos_emb"]["w"][None, : prompt_tokens.shape[1]])
    ce = p["cond_enc"]
    per = ce["perceiver"]
    pre = _attention_block(per["attn"], per["query"].to(dt), prompt, cfg.perceiver_heads)
    lat = _attention_block(per["attn"], pre, pre, cfg.perceiver_heads)
    spkr = linear(ce["spkr_enc"], speaker_emb.to(dt))[:, None]
    emo = linear(ce["emotion_adv_fc"], emotion_adv.to(dt)[:, None, None])
    return torch.cat([spkr, lat, emo], dim=1)


def t3_step_logits(p, cfg: T3Config, cond, text_ids, speech_tokens, cfg_weight: float):
    """One text's CFG-combined fp32 logits (N, V) at each decode step, given
    its conditioning prefix ``cond`` (1, 34, C), its framed text ids (L,)
    and its N served tokens (the last one is never fed back)."""
    n = speech_tokens.shape[0]
    w = p["speech_emb"]["w"]
    text_pos = p["text_pos_emb"]["w"][: text_ids.shape[0]]
    text = F.embedding(text_ids.long(), p["text_emb"]["w"]) + text_pos
    bos_id = torch.tensor([cfg.start_speech_token], device=w.device)
    bos = F.embedding(bos_id, w) + p["speech_pos_emb"]["w"][:1]
    fed = F.embedding(speech_tokens[: n - 1].long(), w) + p["speech_pos_emb"]["w"][1:n]
    tail = torch.cat([bos, bos, fed], dim=0)
    rows = [torch.cat([cond[0], text, tail], dim=0), torch.cat([cond[0], text_pos, tail], dim=0)]
    hidden = llama_forward(p["llama"], cfg.llama, torch.stack(rows))
    first = cond.shape[1] + text_ids.shape[0] + 1  # the second BOS
    logits = F.linear(hidden[:, first:first + n], p["speech_head"]["w"],
                      p["speech_head"].get("b")).float()
    return logits[0] + cfg_weight * (logits[0] - logits[1])


def repetition_penalized(logits, speech_tokens, start_token: int, penalty: float):
    """HF's repetition penalty at each step: the step's logits divided
    (above 0) or multiplied (at or below 0) by ``penalty`` at the start
    token and the tokens served before it."""
    n, v = logits.shape
    seen = torch.zeros((n, v), dtype=torch.bool, device=logits.device)
    seen[:, start_token] = True
    prev = torch.tril(torch.ones((n, n), dtype=torch.bool, device=logits.device), -1)
    cols = speech_tokens.long()[None].expand(n, n)
    seen.scatter_(1, torch.where(prev, cols, start_token), True)
    pen = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, pen, logits)


def sampling_distribution(logits, temperature: float, min_p: float, top_p: float):
    """HF's warpers after the repetition penalty, in float64: the logits
    over ``temperature``; min_p removes the tokens whose probability is
    under ``min_p`` times the best one's; top_p (ascending order) removes
    those whose cumulative probability is at most 1 - ``top_p``, the best
    always kept. Returns the distribution each step samples from (N, V)."""
    lg = logits.double() / temperature
    keep = torch.ones_like(lg, dtype=torch.bool)
    if min_p > 0:
        probs = torch.softmax(lg, dim=-1)
        keep &= probs >= min_p * probs.max(dim=-1, keepdim=True).values
    if top_p < 1:
        srt, idx = torch.sort(torch.where(keep, lg, -torch.inf), dim=-1)
        drop = torch.cumsum(torch.softmax(srt, dim=-1), dim=-1) <= 1 - top_p
        drop[..., -1] = False
        keep &= ~torch.zeros_like(keep).scatter(-1, idx, drop)
    return torch.softmax(torch.where(keep, lg, -torch.inf), dim=-1)


def inverse_cdf(probs, u):
    """The inverse-CDF draw: at each step the first token whose cumulative
    probability reaches the step's uniform ``u`` (N,)."""
    cum = torch.cumsum(probs, dim=-1)
    return torch.searchsorted(cum, u.double()[:, None]).clamp(max=probs.shape[-1] - 1)[:, 0]


def draw_distance(probs, tokens, u):
    """How far, in probability, each step's uniform ``u`` lies outside the
    served token's interval [C(t) - p(t), C(t)] of the cumulative
    distribution ``probs`` (N, V): 0 where the inverse-CDF draw picks the
    token served."""
    cum = torch.cumsum(probs, dim=-1)
    t = tokens.long()[:, None]
    hi = cum.gather(-1, t)[:, 0]
    lo = hi - probs.gather(-1, t)[:, 0]
    u = u.double()
    return torch.clamp(torch.maximum(lo - u, u - hi), min=0.0)


def punc_norm(text: str) -> str:
    """The reference's text cleanup (tts.py punc_norm)."""
    if len(text) == 0:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for old, new in [
        ("...", ", "), ("…", ", "), (":", ","), (" - ", ", "), (";", ", "),
        ("—", "-"), ("–", "-"), (" ,", ","), ("“", '"'), ("”", '"'),
        ("‘", "'"), ("’", "'"),
    ]:
        text = text.replace(old, new)
    text = text.rstrip(" ")
    if not any(text.endswith(p) for p in {".", "!", "?", "-", ","}):
        text += "."
    return text


def text_ids(text: str, cfg: T3Config, max_len: int = 512):
    """A text's framed ids without a tokenizer file (the random-weights
    mode): [SOT] + one id a character, (code point mod 700) + 1, + [EOT],
    cut to ``max_len`` with EOT kept."""
    ids = [cfg.start_text_token] + [(ord(c) % 700) + 1 for c in punc_norm(text)]
    ids = ids + [cfg.stop_text_token]
    return ids if len(ids) <= max_len else ids[: max_len - 1] + ids[-1:]
