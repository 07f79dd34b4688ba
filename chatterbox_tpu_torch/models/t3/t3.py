"""T3: the Llama speech-token decoder with two-stream classifier-free
guidance and a fixed-size KV-cache decode loop.

Port of ``chatterbox_tpu/models/t3/t3.py`` (conditioning prefix, prefill
assembly, the resumable decode carry, ``t3_generate``). The JAX package's ``lax.while_loop`` becomes a
Python loop over decode steps; the per-row done-masks, EOS padding, CFG rows
and the double BOS are kept, so the tokens are the same for the same random
draws. The loop's early exit (every row done) is checked on the host every
few steps: tokens after a row's EOS are forced to EOS, so the extra steps do
not change the result. The loop exists once, in ``t3_generate_resume``:
``t3_generate_start`` runs the prefill into a ``GenCarry``, which later
calls advance in chunks (streaming, preemptible batches), and
``t3_generate`` is the two over the whole budget. ``cache_quant`` takes the int8 KV cache and
``alignment`` the hallucination watchdog (``alignment.py``), as in the JAX
package. ``t3_forward``/``t3_loss`` are the teacher-forced training pass.
"""

from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...checkpoint import torch_convert as tc
from ...core.layers import embedding, linear
from ...core.sampling import SamplingConfig, cfg_combine, process_logits, sample_from_logits
from ...parallel.tensor_parallel import copy_to_model, gather_vocab
from .alignment import alignment_step, init_align_state
from .cond_enc import cond_embeds, convert_cond_enc
from .llama import (LLAMA_520M, LlamaConfig, convert_llama, llama_decode_step, llama_prefill,
                    unstack_layers)

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


def convert_t3(sd, cfg: T3Config = T3Config()):
    """The reference ``t3_cfg.safetensors`` state dict -> the JAX package's
    T3 tree (numpy), as ``chatterbox_tpu/models/t3/t3.py::convert_t3``."""
    return {
        "llama": convert_llama(sd, cfg.llama, prefix="tfmr."),
        "cond_enc": convert_cond_enc(sd, "cond_enc."),
        "text_emb": tc.embedding(sd, "text_emb"),
        "speech_emb": tc.embedding(sd, "speech_emb"),
        "text_pos_emb": tc.embedding(sd, "text_pos_emb.emb"),
        "speech_pos_emb": tc.embedding(sd, "speech_pos_emb.emb"),
        "text_head": tc.linear(sd, "text_head"),
        "speech_head": tc.linear(sd, "speech_head"),
    }


def _head(p, name: str, x, vocab: int):
    """A vocabulary head's logits over the whole vocabulary; under tensor
    parallelism this rank's slice of the head, gathered
    (``parallel/tensor_parallel.py``)."""
    return gather_vocab(linear(p[name], copy_to_model(x)), vocab)


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


@dataclass
class GenCarry:
    """The decode loop's state between steps: the resumable handle of
    chunked and streaming generation (``t3_generate_resume``), as the JAX
    package's ``GenCarry`` (t3.py:208-222). Everything lives on the device
    except the step index and the shapes. K1's workspace belongs to the
    cache tensor (``ops/flash_decode._workspaces``) and lives as long as the
    carry holds it."""

    cache: Any  # (L, 2, 2B, H, S, D) working dtype, or a QuantCache with its tail
    tokens: torch.Tensor  # (B, max_new) int32, EOS-padded
    seen: torch.Tensor  # (B, vocab) bool
    done: torch.Tensor  # (B,) bool
    logits: torch.Tensor  # (2B, vocab): the last step's (the prefill's at i = 0)
    row_prefix: torch.Tensor  # (2B,) int32: [cond; text] slots a row
    base_pos: torch.Tensor  # (2B,) int64: compacted rope position of step 0
    i: int  # decode steps taken; the next token's index
    s0: int  # prefill length: step i writes cache slot s0 + i
    gap_end: int  # first slot after the text bucket
    generator: Optional[torch.Generator] = None  # the draws, when no uniforms
    uniforms: Optional[torch.Tensor] = None  # (max_new, B) in [0, 1): step i's draw
    # (lo, hi, total): these rows are rows [lo, hi) of a batch of ``total``
    # split over data-parallel ranks; each step draws for all ``total`` rows
    # (``uniforms``: (max_new, total)) and takes its own
    draw_rows: Optional[Tuple[int, int, int]] = None
    align: Any = None  # the watchdog's AlignState, when alignment is on
    attn: Optional[torch.Tensor] = None  # (B, T_text) the last step's text attention


def _carry_result(cy: GenCarry, stop: int) -> GenResult:
    """Tokens and lengths so far, with the JAX loop's step count: every
    step up to the first where all rows are done (that loop stops there; the
    port's checks it every ``DONE_CHECK_EVERY`` steps)."""
    lengths = _lengths(cy.tokens, stop)
    steps = cy.i
    if bool(cy.done.all()):
        steps = min(steps, int(lengths.max()) + 1)
    return GenResult(cy.tokens, lengths, steps)


def _start(p, cfg: T3Config, text_tokens, text_lens, speaker_emb, prompt_tokens, emotion_adv,
           sampling: SamplingConfig, max_new_tokens: int, uniforms, generator, alignment: bool,
           cache_quant: bool, draw_rows=None) -> GenCarry:
    """The prefill and the carry at step 0 (``t3_generate_start`` and
    ``t3_generate``; only the latter may ask for the watchdog)."""
    b, tmax = text_tokens.shape
    dev = text_tokens.device
    cfg_on = sampling.cfg_weight > 0
    n_bos = 2 if cfg_on else 1
    pdt = p["speech_emb"]["w"].dtype
    text_lens = text_lens.to(dev)

    cond = t3_cond_prefix(p, cfg, speaker_emb.to(pdt), prompt_tokens, emotion_adv.to(pdt))
    pre = t3_build_prefill(p, cfg, cond, text_tokens, text_lens, sampling.cfg_weight)
    s0 = pre.embeds.shape[1]
    # the cache is padded to a multiple of 128 slots, as the JAX package does
    cache_len = -(-(s0 + max_new_tokens) // 128) * 128
    hidden, cache = llama_prefill(
        p["llama"], cfg.llama, pre.embeds, pre.positions, pre.valid, cache_len,
        cache_quant=cache_quant,
    )
    rows = torch.arange(hidden.shape[0], device=dev)
    logits = _head(p, "speech_head", hidden[rows, pre.last_idx],
                   cfg.speech_tokens_dict_size)  # (2B, vocab)

    # slot validity for the decode kernel: [cond; text] up to row_prefix,
    # then the text-padding gap, then [BOS; decoded] from gap_end on
    row_prefix = (cfg.n_cond + text_lens).to(torch.int32)
    base_pos = (cfg.n_cond + text_lens + n_bos).long()  # compacted rope position
    if cfg_on:
        row_prefix, base_pos = row_prefix.repeat(2), base_pos.repeat(2)

    seen = torch.zeros((b, cfg.speech_tokens_dict_size), dtype=torch.bool, device=dev)
    seen[:, cfg.start_speech_token] = True
    carry = GenCarry(
        cache=cache,
        tokens=torch.full((b, max_new_tokens), cfg.stop_speech_token, dtype=torch.int32,
                          device=dev),
        seen=seen, done=torch.zeros((b,), dtype=torch.bool, device=dev), logits=logits,
        row_prefix=row_prefix.contiguous(), base_pos=base_pos, i=0, s0=s0,
        gap_end=cfg.n_cond + tmax, generator=generator, uniforms=uniforms, draw_rows=draw_rows,
    )
    if alignment:
        carry.align = init_align_state(b, tmax, device=dev)
        carry.attn = torch.zeros((b, tmax), dtype=torch.float32, device=dev)  # before step 0
    return carry


def t3_generate_start(
    p,
    cfg: T3Config,
    text_tokens,
    text_lens,
    speaker_emb,
    prompt_tokens,
    emotion_adv,
    sampling: SamplingConfig = SamplingConfig(),
    max_new_tokens: int = 1000,
    cache_quant: bool = False,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> GenCarry:
    """The prefill only: the resumable carry at step 0, for
    ``t3_generate_resume`` (t3.py:463-481). The draws come from ``uniforms``
    or ``generator`` as in ``t3_generate``; the watchdog is not available
    here, as in the JAX package."""
    return _start(p, cfg, text_tokens, text_lens, speaker_emb, prompt_tokens, emotion_adv,
                  sampling, max_new_tokens, uniforms, generator, False, cache_quant)


def t3_generate_resume(p, cfg: T3Config, carry: GenCarry, text_lens,
                       sampling: SamplingConfig = SamplingConfig(), n_steps: int = 50):
    """Run the carry to step ``min(i + n_steps, max_new)``, or until every
    row is done (t3.py:484-512). The carry holds the cache, the draws and the
    absolute step, so a run in chunks gives the tokens of one run: the int8
    cache's tail is merged at the same slots whatever the chunking. Updates
    ``carry`` in place and returns (carry, GenResult so far); the result's
    tokens are the carry's own tensor, which a later resume writes on."""
    cy = carry
    b, max_new = cy.tokens.shape
    dev = cy.tokens.device
    cfg_on = sampling.cfg_weight > 0
    stop = cfg.stop_speech_token
    text_lens = text_lens.to(dev)
    tmax = cy.gap_end - cfg.n_cond
    layers = unstack_layers(p["llama"])
    eos_col = torch.arange(cfg.speech_tokens_dict_size, device=dev)[None] == stop
    rows_b = torch.arange(b, device=dev)
    alignment = cy.align is not None
    align_layer = cfg.alignment_layer if alignment else None
    text_slice = (cfg.n_cond, cfg.n_cond + tmax)
    i_end = min(cy.i + n_steps, max_new)

    while cy.i < i_end:
        i = cy.i
        lg = cy.logits.float()  # sampling chain in fp32
        lg = cfg_combine(lg[:b], lg[b:], sampling.cfg_weight) if cfg_on else lg
        if i < sampling.min_new_tokens:
            lg = torch.where(eos_col, torch.finfo(torch.float32).min, lg)
        if alignment:
            cy.align, lg = alignment_step(cy.align, cy.attn, text_lens, i, lg, stop)
        lg = process_logits(lg, cy.seen, sampling)
        if sampling.greedy:
            tok = torch.argmax(lg, dim=-1).to(torch.int32)
        else:
            lo, hi, total = cy.draw_rows or (0, b, b)
            if cy.uniforms is not None:
                u = cy.uniforms[i].to(device=dev, dtype=torch.float32)
            else:
                u = torch.rand((total,), generator=cy.generator, device=dev)
            u = u[lo:hi]
            tok = sample_from_logits(lg, u)
        tok = torch.where(cy.done, stop, tok)
        cy.tokens[:, i] = tok
        cy.seen[rows_b, tok.long()] = True
        cy.done = cy.done | (tok == stop)
        cy.i = i + 1
        if cy.i == max_new:
            break  # the last token's logits are never read
        # every DONE_CHECK_EVERY absolute steps, and at the chunk's end
        if (cy.i % DONE_CHECK_EVERY == 0 or cy.i == i_end) and bool(cy.done.all()):
            break

        emb = embedding(p["speech_emb"], tok.long())[:, None] + p["speech_pos_emb"]["w"][i + 1]
        if cfg_on:
            emb = torch.cat([emb, emb], dim=0)  # the same token in both streams
        h, attn_2b = llama_decode_step(
            p["llama"], cfg.llama, emb, cy.cache, cy.s0 + i, (cy.base_pos + i)[:, None],
            cy.row_prefix, cy.gap_end, layers=layers, align_layer=align_layer,
            text_slice=text_slice,
        )
        cy.logits = _head(p, "speech_head", h[:, 0], cfg.speech_tokens_dict_size)
        if alignment:
            cy.attn = attn_2b[:b]  # the conditional rows
    return cy, _carry_result(cy, stop)


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
    alignment: bool = False,
    cache_quant: bool = False,
    *,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    draw_rows: Optional[Tuple[int, int, int]] = None,
) -> GenResult:
    """Batched CFG speech-token generation: the prefill
    (``t3_generate_start``) and one ``t3_generate_resume`` over the whole
    budget.

    text_tokens (B, T) carry the SOT/EOT framing, right-padded; text_lens
    (B,). The random draw of step i is ``uniforms[i]`` ((max_new, B) in
    [0, 1)) when given, else ``torch.rand`` from ``generator``; greedy
    decoding draws nothing. ``cache_quant`` keeps the KV cache int8 with an
    exact tail (see ``llama.py``); ``alignment`` runs the watchdog on layer
    ``cfg.alignment_layer``'s text attention of the previous step, after the
    ``min_new_tokens`` floor and before the logits processors, and forces
    ``cache_quant`` off (t3.py:244-279, 365-367). ``draw_rows`` = (lo, hi,
    total) makes these B rows rows [lo, hi) of a batch of ``total``: a
    data-parallel rank's rows take their slice of the whole batch's draws
    (``uniforms`` then (max_new, total)). Returns EOS-padded tokens,
    their lengths and the step count of the JAX loop (it stops once every
    row is done)."""
    carry = _start(p, cfg, text_tokens, text_lens, speaker_emb, prompt_tokens, emotion_adv,
                   sampling, max_new_tokens, uniforms, generator, alignment,
                   cache_quant and not alignment, draw_rows)
    _, res = t3_generate_resume(p, cfg, carry, text_lens, sampling, max_new_tokens)
    return res


# ---------------------------------------------------------------------------
# the teacher-forced forward and its loss (t3.py:500-557; used by train/)
# ---------------------------------------------------------------------------


def t3_forward(p, cfg: T3Config, speaker_emb, prompt_tokens, emotion_adv, text_tokens, text_lens,
               speech_tokens, speech_lens):
    """Teacher-forced forward -> (text_logits (B, Tt, V_text), speech_logits
    (B, Ts, V_speech)): [cond; text + pos; speech + pos] in one causal
    prefill that builds no KV cache, pads masked out of the keys and their
    rope positions compacted (``cumsum(valid) - 1``, 0 at pads)."""
    b, tt = text_tokens.shape
    ts = speech_tokens.shape[1]
    dev = text_tokens.device
    cond = t3_cond_prefix(p, cfg, speaker_emb, prompt_tokens, emotion_adv)
    text_emb = embedding(p["text_emb"], text_tokens.long()) + p["text_pos_emb"]["w"][None, :tt]
    speech_emb = (embedding(p["speech_emb"], speech_tokens.long())
                  + p["speech_pos_emb"]["w"][None, :ts])
    embeds = torch.cat([cond, text_emb, speech_emb], dim=1)
    valid = torch.cat([
        torch.ones((b, cfg.n_cond), dtype=torch.bool, device=dev),
        torch.arange(tt, device=dev)[None] < text_lens.to(dev)[:, None],
        torch.arange(ts, device=dev)[None] < speech_lens.to(dev)[:, None],
    ], dim=1)
    positions = torch.cumsum(valid.long(), dim=1) - 1
    positions = torch.where(valid, positions, 0)
    hidden, _ = llama_prefill(p["llama"], cfg.llama, embeds, positions, valid, None)
    text_latents = hidden[:, cfg.n_cond : cfg.n_cond + tt]
    speech_latents = hidden[:, cfg.n_cond + tt :]
    return (_head(p, "text_head", text_latents, cfg.text_tokens_dict_size),
            _head(p, "speech_head", speech_latents, cfg.speech_tokens_dict_size))


def masked_ce(logits, targets, lens, data_group=None):
    """Mean over the first ``lens`` positions of each row of the cross
    entropy, from an fp32 log-softmax, of each position's logits against
    the token at the same position (no shift: the JAX package's arithmetic,
    whose docstring cites the reference's t3.py:167-201), divided by
    max(positions, 1). The per-position NLL picks one entry a position
    (``cross_entropy`` without reduction), so its backward writes each
    logit's gradient once and adds nothing with atomics on the card.

    Under data parallelism (``data_group``) each rank holds some rows: the
    divisor is the whole batch's count of positions (all-reduced), so that
    the ranks' losses add up to the whole batch's loss."""
    dev = targets.device
    mask = torch.arange(targets.shape[1], device=dev)[None] < lens.to(dev)[:, None]
    nll = F.cross_entropy(logits.float().flatten(0, 1), targets.long().flatten(),
                          reduction="none").view(targets.shape)
    count = mask.sum()
    if data_group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=data_group)
    return torch.sum(nll * mask) / torch.clamp_min(count, 1)


def t3_loss(p, cfg: T3Config, batch, *, data_group=None):
    """Masked CE losses (loss_text, loss_speech) of ``t3_forward`` on a batch
    dict with the JAX package's keys (speaker_emb, prompt_tokens,
    emotion_adv, text_tokens, text_lens, speech_tokens, speech_lens); with
    ``data_group`` this rank's share of the whole batch's (``masked_ce``)."""
    text_logits, speech_logits = t3_forward(
        p, cfg, batch["speaker_emb"], batch["prompt_tokens"], batch["emotion_adv"],
        batch["text_tokens"], batch["text_lens"], batch["speech_tokens"], batch["speech_lens"])
    return (masked_ce(text_logits, batch["text_tokens"], batch["text_lens"], data_group),
            masked_ce(speech_logits, batch["speech_tokens"], batch["speech_lens"], data_group))
