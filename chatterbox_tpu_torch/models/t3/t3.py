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
``t3_generate`` is the two over the whole budget. A step is two functions,
``_sample_part`` and ``_forward_part``, which read the step from a counter
on the device; on the card they run eagerly once and are then captured as
CUDA graphs that replay every later step (``_StepGraphs``). ``cache_quant``
takes the int8 KV cache and ``alignment`` the hallucination watchdog
(``alignment.py``), as in the JAX package. ``t3_forward``/``t3_loss`` are
the teacher-forced training pass.

``GraniteT3Config`` puts the Granite 4.0-H hybrid backbone
(``granite_hybrid.py``: Mamba-2 and grouped-query attention layers) in the
Llama's place: its parameters are ``p["granite"]``, the carry holds its
``SSMState`` beside the attention layers' KV cache, and the heads divide
their logits by its ``logits_scaling``. It takes the working-dtype cache on
one device, without the watchdog and without training: each of those raises
a ValueError.
"""

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, ClassVar, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ...checkpoint import torch_convert as tc
from ...core.layers import embedding, linear
from ...core.sampling import SamplingConfig, cfg_combine, process_logits, sample_from_logits
from ...ops import kernels
from ...parallel.tensor_parallel import copy_to_model, gather_vocab, model_group
from ...runtime.profiling import annotate, count, spanned
from .alignment import alignment_step, init_align_state
from .cond_enc import cond_embeds, convert_cond_enc
from .granite_hybrid import (GRANITE_4_0_H_MICRO, GraniteHybridConfig, granite_decode_step,
                             granite_layers, granite_prefill)
from .llama import (LLAMA_520M, LlamaConfig, QuantCache, convert_llama, llama_decode_step,
                    llama_prefill, unstack_layers)

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
    # the Granite backbone in the Llama's place: ``GraniteT3Config``'s field
    granite: ClassVar[Optional[GraniteHybridConfig]] = None

    @property
    def n_cond(self) -> int:
        return 34  # 1 speaker + 32 perceiver + 1 emotion

    @property
    def dim(self) -> int:
        return (self.granite or self.llama).hidden_size


@dataclass(frozen=True)
class GraniteT3Config(T3Config):
    """T3 with the Granite 4.0-H backbone (``granite_hybrid.py``) in place
    of the Llama, whose ``llama`` config it then does not read."""

    granite: GraniteHybridConfig = field(default_factory=lambda: GRANITE_4_0_H_MICRO)


def _refuse_granite(cfg: T3Config, what: str, why: str):
    """Raise the ValueError of a path the Granite backbone does not take."""
    if cfg.granite is not None:
        raise ValueError(f"the Granite 4.0-H backbone does not run {what}: {why}")


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


def _head(p, name: str, x, vocab: int, cfg: T3Config):
    """A vocabulary head's logits over the whole vocabulary; under tensor
    parallelism this rank's slice of the head, gathered
    (``parallel/tensor_parallel.py``). The Granite backbone's heads divide
    by its ``logits_scaling``, as its published head does."""
    logits = gather_vocab(linear(p[name], copy_to_model(x)), vocab)
    return logits / cfg.granite.logits_scaling if cfg.granite is not None else logits


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
    except the shapes and the host's copy of the step index, ``i``, which
    the loop's control flow reads; every tensor is written in place, so that
    a captured step finds it where it was. K1's workspace belongs to the
    cache tensor (``ops/flash_decode._workspaces``) and lives as long as the
    carry holds it, as do the captured step's graphs (``graphs``)."""

    cache: Any  # (L, 2, 2B, H, S, D) working dtype, or a QuantCache with its tail
    # (the Granite backbone: its attention layers' (La, 2, 2B, Hkv, S, D))
    tokens: torch.Tensor  # (B, max_new) int32, EOS-padded
    seen: torch.Tensor  # (B, vocab) bool
    done: torch.Tensor  # (B,) bool
    logits: torch.Tensor  # (2B, vocab): the last step's (the prefill's at i = 0)
    row_prefix: torch.Tensor  # (2B,) int32: [cond; text] slots a row
    base_pos: torch.Tensor  # (2B,) int64: compacted rope position of step 0
    step: torch.Tensor  # (1,) int64: the step on the device, equal to i
    pos: torch.Tensor  # (1,) int32: s0 + step, the cache slot the step writes
    i: int  # decode steps taken; the next token's index
    s0: int  # prefill length: step i writes cache slot s0 + i
    gap_end: int  # first slot after the text bucket
    generator: Optional[torch.Generator] = None  # the draws, when no uniforms
    uniforms: Optional[torch.Tensor] = None  # (max_new, B) fp32 on the device: step i's draw
    # (lo, hi, total): these rows are rows [lo, hi) of a batch of ``total``
    # split over data-parallel ranks; each step draws for all ``total`` rows
    # (``uniforms``: (max_new, total)) and takes its own
    draw_rows: Optional[Tuple[int, int, int]] = None
    align: Any = None  # the watchdog's AlignState, when alignment is on
    attn: Optional[torch.Tensor] = None  # (B, T_text) the last step's text attention
    graphs: Optional["_StepGraphs"] = None  # the captured step, once it is
    state: Any = None  # the Granite backbone's SSMState, updated in place


def _carry_result(cy: GenCarry, stop: int) -> GenResult:
    """Tokens and lengths so far, with the JAX loop's step count: every
    step up to the first where all rows are done (that loop stops there; the
    port's checks it every ``DONE_CHECK_EVERY`` steps)."""
    lengths = _lengths(cy.tokens, stop)
    steps = cy.i
    if bool(cy.done.all()):
        steps = min(steps, int(lengths.max()) + 1)
    return GenResult(cy.tokens, lengths, steps)


@spanned("t3.prefill")
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
    if alignment:
        _refuse_granite(cfg, "the alignment watchdog", "it reads a Llama layer's per-head text "
                        "attention, which no Mamba layer has and K1b takes only without GQA")
    if cache_quant:
        _refuse_granite(cfg, "the int8 KV cache", "four GQA layers hold ~8 KiB a token-row; "
                        "the cost is the Mamba state, which int8 K/V does not cut")
    if model_group() is not None:
        _refuse_granite(cfg, "under tensor parallelism", "its Mamba heads are not sharded")

    cond = t3_cond_prefix(p, cfg, speaker_emb.to(pdt), prompt_tokens, emotion_adv.to(pdt))
    pre = t3_build_prefill(p, cfg, cond, text_tokens, text_lens, sampling.cfg_weight)
    s0 = pre.embeds.shape[1]
    # the cache is padded to a multiple of 128 slots, as the JAX package does
    cache_len = -(-(s0 + max_new_tokens) // 128) * 128
    state = None
    if cfg.granite is not None:
        hidden, cache, state = granite_prefill(p["granite"], cfg.granite, pre.embeds, pre.valid,
                                               cache_len)
        count("t3.ssm_state_bytes", sum(t.numel() * t.element_size() for t in state))
        count("t3.ssm_layers", len(cfg.granite.mamba_layers))
    else:
        hidden, cache = llama_prefill(
            p["llama"], cfg.llama, pre.embeds, pre.positions, pre.valid, cache_len,
            cache_quant=cache_quant,
        )
    rows = torch.arange(hidden.shape[0], device=dev)
    logits = _head(p, "speech_head", hidden[rows, pre.last_idx],
                   cfg.speech_tokens_dict_size, cfg)  # (2B, vocab)

    # slot validity for the decode kernel: [cond; text] up to row_prefix,
    # then the text-padding gap, then [BOS; decoded] from gap_end on
    row_prefix = (cfg.n_cond + text_lens).to(torch.int32)
    base_pos = (cfg.n_cond + text_lens + n_bos).long()  # compacted rope position
    if cfg_on:
        row_prefix, base_pos = row_prefix.repeat(2), base_pos.repeat(2)

    seen = torch.zeros((b, cfg.speech_tokens_dict_size), dtype=torch.bool, device=dev)
    seen[:, cfg.start_speech_token] = True
    if uniforms is not None:  # uploaded once; each step picks its row on the device
        uniforms = uniforms.to(device=dev, dtype=torch.float32)
    carry = GenCarry(
        cache=cache,
        tokens=torch.full((b, max_new_tokens), cfg.stop_speech_token, dtype=torch.int32,
                          device=dev),
        seen=seen, done=torch.zeros((b,), dtype=torch.bool, device=dev), logits=logits,
        row_prefix=row_prefix.contiguous(), base_pos=base_pos,
        step=torch.zeros((1,), dtype=torch.long, device=dev),
        pos=torch.full((1,), s0, dtype=torch.int32, device=dev), i=0, s0=s0,
        gap_end=cfg.n_cond + tmax, generator=generator, uniforms=uniforms, draw_rows=draw_rows,
        state=state,
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


class _StepInputs(NamedTuple):
    """What a decode step reads besides its carry: fixed for a carry's
    chunk, and held by its captured graphs while they live."""

    p: Any
    cfg: T3Config
    sampling: SamplingConfig
    layers: List[dict]  # ``unstack_layers`` of p's Llama, or ``granite_layers``
    eos_col: torch.Tensor  # (1, vocab) bool: the stop token's column
    text_lens: torch.Tensor  # (B,) on the device: the watchdog's
    text_slice: Tuple[int, int]  # the text's cache slots: the watchdog's


def _step_inputs(p, cfg: T3Config, cy: GenCarry, text_lens,
                 sampling: SamplingConfig) -> _StepInputs:
    dev = cy.tokens.device
    tmax = cy.gap_end - cfg.n_cond
    layers = (granite_layers(p["granite"], cfg.granite) if cfg.granite is not None
              else unstack_layers(p["llama"]))
    return _StepInputs(
        p, cfg, sampling, layers,
        torch.arange(cfg.speech_tokens_dict_size, device=dev)[None] == cfg.stop_speech_token,
        text_lens.to(dev), (cfg.n_cond, cfg.n_cond + tmax))


def _sample_part(cy: GenCarry, si: _StepInputs):
    """The first half of step ``cy.step``: the token from the last logits
    (CFG combine, the ``min_new_tokens`` floor, the watchdog, the
    processors, the draw), written into column ``step`` of the tokens, into
    ``seen`` and into ``done``, all in place. Returns the token (B,) int32.
    Nothing here reads a value on the host, except the watchdog, which reads
    ``cy.i`` and never runs captured."""
    sampling, stop = si.sampling, si.cfg.stop_speech_token
    b = cy.tokens.shape[0]
    lg = cy.logits.float()  # sampling chain in fp32
    lg = cfg_combine(lg[:b], lg[b:], sampling.cfg_weight) if sampling.cfg_weight > 0 else lg
    if sampling.min_new_tokens > 0:
        lg = torch.where(si.eos_col & (cy.step < sampling.min_new_tokens),
                         torch.finfo(torch.float32).min, lg)
    if cy.align is not None:
        cy.align, lg = alignment_step(cy.align, cy.attn, si.text_lens, cy.i, lg, stop)
    lg = process_logits(lg, cy.seen, sampling)
    if sampling.greedy:
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    else:
        lo, hi, total = cy.draw_rows or (0, b, b)
        if cy.uniforms is not None:
            u = cy.uniforms.index_select(0, cy.step)[0]
        else:
            u = torch.rand((total,), generator=cy.generator, device=lg.device)
        tok = sample_from_logits(lg, u[lo:hi])
    tok = torch.where(cy.done, stop, tok)
    cy.tokens.index_copy_(1, cy.step, tok[:, None])
    cy.seen.scatter_(1, tok[:, None].long(), True)
    cy.done |= tok == stop
    return tok


def _forward_part(cy: GenCarry, si: _StepInputs, tok):
    """The second half of step ``cy.step``: token ``tok``'s embedding at
    speech position step + 1, the layers at cache slot ``cy.pos`` (K1 reads
    it on the device; K2 and K2b write there), the head's logits copied into
    ``cy.logits``; then the step counter and the slot move on by one."""
    p, cfg = si.p, si.cfg
    b = cy.tokens.shape[0]
    emb = (embedding(p["speech_emb"], tok.long())[:, None]
           + p["speech_pos_emb"]["w"].index_select(0, cy.step + 1))
    if si.sampling.cfg_weight > 0:
        emb = torch.cat([emb, emb], dim=0)  # the same token in both streams
    alignment = cy.align is not None
    if cfg.granite is not None:
        h = granite_decode_step(p["granite"], cfg.granite, emb, cy.cache, cy.state, cy.pos,
                                cy.row_prefix, cy.gap_end, layers=si.layers)
    else:
        h, attn_2b = llama_decode_step(
            p["llama"], cfg.llama, emb, cy.cache, cy.pos, (cy.base_pos + cy.step)[:, None],
            cy.row_prefix, cy.gap_end, layers=si.layers,
            align_layer=cfg.alignment_layer if alignment else None, text_slice=si.text_slice,
        )
    cy.logits.copy_(_head(p, "speech_head", h[:, 0], cfg.speech_tokens_dict_size, cfg))
    if alignment:
        cy.attn = attn_2b[:b]  # the conditional rows
    _advance(cy)


def _advance(cy: GenCarry):
    cy.step += 1
    cy.pos += 1


class _StepGraphs:
    """A carry's decode step as two CUDA graphs, the sample part and the
    forward part, captured once on the decode stream (``_decode_stream``)
    into one memory pool and replayed every later step. The host's break
    after the sample keeps its place between the two replays. The graphs
    read the carry's tensors where they lie, the step from ``cy.step``, and
    the inputs ``si``, which they hold. The carry's generator is registered
    with the sample graph, so that each replay's ``torch.rand`` draws what
    the eager step would (the default generator registers itself).

    The kernels' ``.launches`` counters count launches on the card: a
    capture adds none, and each replay adds what its graph captured."""

    def __init__(self, cy: GenCarry, si: _StepInputs):
        self.si = si
        fns = list(kernels().values())
        before = [fn.launches for fn in fns]
        self.sample_graph = torch.cuda.CUDAGraph()
        if (cy.generator is not None and cy.uniforms is None
                and not si.sampling.greedy):
            self.sample_graph.register_generator_state(cy.generator)
        with annotate("t3.sample"):
            self.tok = self._capture(self.sample_graph, None, lambda: _sample_part(cy, si))
        mid = [fn.launches for fn in fns]
        self.forward_graph = torch.cuda.CUDAGraph()
        with annotate("t3.forward"):
            self._capture(self.forward_graph, self.sample_graph.pool(),
                          lambda: _forward_part(cy, si, self.tok))
        after = [fn.launches for fn in fns]
        self.sample_launches = [(f, m - a) for f, a, m in zip(fns, before, mid) if m != a]
        self.forward_launches = [(f, z - m) for f, m, z in zip(fns, mid, after) if z != m]
        for fn, n in zip(fns, before):
            fn.launches = n

    @staticmethod
    def _capture(graph, pool, body):
        # thread_local: another thread's CUDA calls neither break the
        # capture nor are broken by it
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            return body()
        finally:
            graph.capture_end()

    def serves(self, p, sampling: SamplingConfig) -> bool:
        return self.si.p is p and self.si.sampling == sampling

    def sample(self):
        self.sample_graph.replay()
        for fn, n in self.sample_launches:
            fn.launches += n

    def forward(self):
        self.forward_graph.replay()
        for fn, n in self.forward_launches:
            fn.launches += n


# each thread's decode stream, one a device
_STREAMS = threading.local()


@contextlib.contextmanager
def _decode_stream(dev: torch.device):
    """Run the block on the calling thread's decode stream for ``dev``,
    after the work already queued on the current stream, which then waits
    for the block's work. A CUDA graph is captured on a stream other than
    the default one; the eager steps before the capture run on the same
    stream, so that its library state (cuBLAS's workspace a stream) exists
    before the capture, which cannot make it."""
    streams = _STREAMS.__dict__.setdefault("by_device", {})
    index = torch.cuda.current_device() if dev.index is None else dev.index
    stream = streams.get(index)
    if stream is None:
        stream = streams[index] = torch.cuda.Stream(index)
    caller = torch.cuda.current_stream(dev)
    stream.wait_stream(caller)
    try:
        with torch.cuda.stream(stream):
            yield
    finally:
        caller.wait_stream(stream)


def t3_generate_resume(p, cfg: T3Config, carry: GenCarry, text_lens,
                       sampling: SamplingConfig = SamplingConfig(), n_steps: int = 50):
    """Run the carry to step ``min(i + n_steps, max_new)``, or until every
    row is done (t3.py:484-512). The carry holds the cache, the draws and the
    absolute step, so a run in chunks gives the tokens of one run: the int8
    cache's tail is merged at the same slots whatever the chunking. Updates
    ``carry`` in place and returns (carry, GenResult so far); the result's
    tokens are the carry's own tensor, which a later resume writes on.

    On a CUDA device, without the watchdog and outside a model group (whose
    collectives stay eager), the loop runs on a decode stream of its own:
    the carry's first step runs eagerly (it makes K1's workspace, which a
    capture cannot), the next captures the step as CUDA graphs
    (``_StepGraphs``), and every later step, in this call or a later one,
    replays them. Eager and replayed steps leave the same tokens, cache and
    step count. Each step counts ``t3.graph_steps`` or ``t3.eager_steps`` in
    its ``t3.step`` span; ``t3.sample`` and ``t3.forward`` open around an
    eager step's parts and, inside ``t3.capture``, around their capture: a
    replayed step has no span below ``t3.step``."""
    cy = carry
    b, max_new = cy.tokens.shape
    dev = cy.tokens.device
    stop = cfg.stop_speech_token
    i_end = min(cy.i + n_steps, max_new)
    slots = (cy.cache.values if isinstance(cy.cache, QuantCache) else cy.cache).shape[4]
    if cy.s0 + i_end > slots:
        raise ValueError(f"the KV cache holds {slots} slots; step {i_end - 1} writes slot "
                         f"{cy.s0 + i_end - 1}")
    si = _step_inputs(p, cfg, cy, text_lens, sampling)
    graphable = dev.type == "cuda" and cy.align is None and model_group() is None
    if cy.graphs is not None and not cy.graphs.serves(p, sampling):
        cy.graphs = None  # captured for other parameters: capture again

    with _decode_stream(dev) if graphable else contextlib.nullcontext():
        while cy.i < i_end:
            with annotate("t3.step"):
                # past step 0 a forward has run eagerly on this stream
                if graphable and cy.i > 0 and cy.graphs is None:
                    with annotate("t3.capture"):
                        cy.graphs = _StepGraphs(cy, si)
                graphs = cy.graphs if graphable else None
                count("t3.graph_steps" if graphs is not None else "t3.eager_steps")
                if graphs is not None:
                    graphs.sample()
                else:
                    with annotate("t3.sample"):
                        tok = _sample_part(cy, si)
                cy.i += 1
                if cy.i == max_new:
                    break  # the last token's logits are never read
                # every DONE_CHECK_EVERY absolute steps, and at the chunk's end
                if cy.i % DONE_CHECK_EVERY == 0 or cy.i == i_end:
                    with annotate("t3.done_check"):
                        finished = bool(cy.done.all())
                    if finished:
                        _advance(cy)  # the device's step stays equal to i
                        break
                if graphs is not None:
                    graphs.forward()
                else:
                    with annotate("t3.forward"):
                        _forward_part(cy, si, tok)
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
    _refuse_granite(cfg, "the teacher-forced training pass", "the training path is the Llama's")
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
    return (_head(p, "text_head", text_latents, cfg.text_tokens_dict_size, cfg),
            _head(p, "speech_head", speech_latents, cfg.speech_tokens_dict_size, cfg))


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
