"""T3: the Llama speech-token decoder with two-stream classifier-free
guidance and a fixed-size KV-cache decode loop.

Port of ``chatterbox_tpu/models/t3/t3.py`` (conditioning prefix, prefill
assembly, ``t3_generate``). The JAX package's ``lax.while_loop`` becomes a
Python loop over decode steps; the per-row done-masks, EOS padding, CFG rows
and the double BOS are kept, so the tokens are the same for the same random
draws. The loop's early exit (every row done) is checked on the host every
few steps: tokens after a row's EOS are forced to EOS, so the extra steps do
not change the result.
"""

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch

from ...core.layers import embedding, linear
from ...core.sampling import SamplingConfig, cfg_combine, process_logits, sample_from_logits
from .cond_enc import cond_embeds
from .llama import LLAMA_520M, LlamaConfig, layer_params, llama_decode_step, llama_prefill

# the decode loop reads "every row done" on the host once per this many steps
# (each read waits for the card)
DONE_CHECK_EVERY = 8


@dataclass(frozen=True)
class T3Config:
    """Mirrors reference t3/modules/t3_config.py."""

    start_text_token: int = 255
    stop_text_token: int = 0
    text_tokens_dict_size: int = 704
    max_text_tokens: int = 2048
    start_speech_token: int = 6561
    stop_speech_token: int = 6562
    speech_tokens_dict_size: int = 8194
    max_speech_tokens: int = 4096
    speech_cond_prompt_len: int = 150
    speaker_embed_size: int = 256
    alignment_layer: int = 9
    llama: LlamaConfig = field(default_factory=lambda: LLAMA_520M)

    @property
    def n_cond(self) -> int:
        return 34  # 1 speaker + 32 perceiver + 1 emotion

    @property
    def dim(self) -> int:
        return self.llama.hidden_size


def t3_cond_prefix(p, cfg: T3Config, speaker_emb, prompt_tokens, emotion_adv):
    """(B,256), (B,150) int, (B,) -> (B, 34, C): the prompt tokens are
    embedded with speech_emb + speech_pos_emb before the perceiver."""
    prompt_emb = embedding(p["speech_emb"], prompt_tokens.long())
    prompt_emb = prompt_emb + p["speech_pos_emb"]["w"][None, : prompt_tokens.shape[1]]
    return cond_embeds(p["cond_enc"], speaker_emb, prompt_emb, emotion_adv)


class PrefillBatch(NamedTuple):
    """Inputs to the prefill forward, one row per CFG stream (2B rows)."""

    embeds: torch.Tensor  # (2B, S0, C)
    positions: torch.Tensor  # (2B, S0) rope positions (pads compacted)
    valid: torch.Tensor  # (2B, S0) bool
    last_idx: torch.Tensor  # (2B,) index of the final BOS position


def t3_build_prefill(p, cfg: T3Config, cond, text_tokens, text_lens, cfg_weight: float):
    """[cond; text(+pos); BOS (; BOS)] embeddings for the doubled CFG batch.
    text_tokens (B, T) right-padded; the uncond stream has zeroed text
    content with the positions kept, and with CFG on the sequence ends with
    two BOS embeddings, both at speech position 0 (the reference's quirk)."""
    b, tmax = text_tokens.shape
    dev = text_tokens.device
    text_emb = embedding(p["text_emb"], text_tokens.long())
    text_pos = p["text_pos_emb"]["w"][None, :tmax]
    text_cond = text_emb + text_pos
    text_uncond = torch.zeros_like(text_emb) + text_pos
    bos_ids = torch.full((b, 1), cfg.start_speech_token, dtype=torch.long, device=dev)
    bos = embedding(p["speech_emb"], bos_ids) + p["speech_pos_emb"]["w"][None, :1]
    cfg_on = cfg_weight > 0
    n_bos = 2 if cfg_on else 1
    bos_seq = bos.repeat(1, n_bos, 1)

    embeds = torch.cat([cond, text_cond, bos_seq], dim=1)
    if cfg_on:
        embeds = torch.cat([embeds, torch.cat([cond, text_uncond, bos_seq], dim=1)], dim=0)

    s0 = cfg.n_cond + tmax + n_bos
    tvalid = torch.arange(tmax, device=dev)[None] < text_lens.to(dev)[:, None]
    valid = torch.cat(
        [torch.ones((b, cfg.n_cond), dtype=torch.bool, device=dev), tvalid,
         torch.ones((b, n_bos), dtype=torch.bool, device=dev)],
        dim=1,
    )
    positions = torch.cumsum(valid.long(), dim=1) - 1
    positions = torch.where(valid, positions, 0)
    last_idx = torch.full((b,), s0 - 1, dtype=torch.long, device=dev)
    if cfg_on:
        valid, positions, last_idx = (torch.cat([x, x], dim=0) for x in (valid, positions, last_idx))
    return PrefillBatch(embeds, positions, valid, last_idx)


class GenResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) int32, EOS-padded
    lengths: torch.Tensor  # (B,) number of valid tokens (excluding EOS)
    steps: int  # decode iterations the JAX loop would execute


def _lengths(tokens, stop_token: int):
    """Index of the first EOS per row (``max_new`` when there is none)."""
    is_eos = tokens == stop_token
    first = is_eos.int().argmax(dim=1)
    return torch.where(is_eos.any(dim=1), first, tokens.shape[1]).to(torch.int32)


def t3_generate(
    p,
    cfg: T3Config,
    text_tokens,
    text_lens,
    speaker_emb,
    prompt_tokens,
    emotion_adv,
    sampling: SamplingConfig = SamplingConfig(),
    max_new_tokens: int = 1000,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> GenResult:
    """Batched CFG speech-token generation.

    text_tokens (B, T) carry the SOT/EOT framing, right-padded; text_lens
    (B,). The random draw of step i is ``uniforms[i]`` ((max_new, B) in
    [0, 1)) when given, else ``torch.rand`` from ``generator``; greedy
    decoding draws nothing. Returns EOS-padded tokens, their lengths and the
    step count of the JAX loop (it stops once every row is done)."""
    b, tmax = text_tokens.shape
    dev = text_tokens.device
    cfg_on = sampling.cfg_weight > 0
    n_bos = 2 if cfg_on else 1
    stop = cfg.stop_speech_token
    pdt = p["speech_emb"]["w"].dtype
    text_lens = text_lens.to(dev)

    cond = t3_cond_prefix(p, cfg, speaker_emb.to(pdt), prompt_tokens, emotion_adv.to(pdt))
    pre = t3_build_prefill(p, cfg, cond, text_tokens, text_lens, sampling.cfg_weight)
    s0 = pre.embeds.shape[1]
    # the cache is padded to a multiple of 128 slots, as the JAX package does
    cache_len = -(-(s0 + max_new_tokens) // 128) * 128
    hidden, cache = llama_prefill(
        p["llama"], cfg.llama, pre.embeds, pre.positions, pre.valid, cache_len
    )
    rows = torch.arange(hidden.shape[0], device=dev)
    logits = linear(p["speech_head"], hidden[rows, pre.last_idx])  # (2B, vocab)

    # slot validity for the decode kernel: [cond; text] up to row_prefix,
    # then the text-padding gap, then [BOS; decoded] from gap_end on
    row_prefix = (cfg.n_cond + text_lens).to(torch.int32)
    base_pos = (cfg.n_cond + text_lens + n_bos).long()  # compacted rope position
    if cfg_on:
        row_prefix, base_pos = row_prefix.repeat(2), base_pos.repeat(2)
    row_prefix = row_prefix.contiguous()
    gap_end = cfg.n_cond + tmax

    vocab = cfg.speech_tokens_dict_size
    tokens = torch.full((b, max_new_tokens), stop, dtype=torch.int32, device=dev)
    seen = torch.zeros((b, vocab), dtype=torch.bool, device=dev)
    seen[:, cfg.start_speech_token] = True
    done = torch.zeros((b,), dtype=torch.bool, device=dev)
    rows_b = torch.arange(b, device=dev)
    layers = [layer_params(p["llama"], i) for i in range(cfg.llama.num_hidden_layers)]
    eos_col = torch.arange(vocab, device=dev)[None] == stop

    for i in range(max_new_tokens):
        lg = logits.float()  # sampling chain in fp32
        lg = cfg_combine(lg[:b], lg[b:], sampling.cfg_weight) if cfg_on else lg
        if i < sampling.min_new_tokens:
            lg = torch.where(eos_col, torch.finfo(torch.float32).min, lg)
        lg = process_logits(lg, seen, sampling)
        if sampling.greedy:
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        else:
            if uniforms is not None:
                u = uniforms[i].to(device=dev, dtype=torch.float32)
            else:
                u = torch.rand((b,), generator=generator, device=dev)
            tok = sample_from_logits(lg, u)
        tok = torch.where(done, stop, tok)
        tokens[:, i] = tok
        seen[rows_b, tok.long()] = True
        done = done | (tok == stop)
        if i == max_new_tokens - 1:
            break  # the last token's logits are never read
        if (i + 1) % DONE_CHECK_EVERY == 0 and bool(done.all()):
            break

        emb = embedding(p["speech_emb"], tok.long())[:, None] + p["speech_pos_emb"]["w"][i + 1]
        if cfg_on:
            emb = torch.cat([emb, emb], dim=0)  # the same token in both streams
        h = llama_decode_step(
            p["llama"], cfg.llama, emb, cache, s0 + i, (base_pos + i)[:, None],
            row_prefix, gap_end, layers=layers,
        )
        logits = linear(p["speech_head"], h[:, 0])

    lengths = _lengths(tokens, stop)
    steps = min(int(lengths.max()) + 1, max_new_tokens)
    return GenResult(tokens, lengths, steps)
