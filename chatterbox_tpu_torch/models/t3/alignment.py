"""Alignment-informed inference: the hallucination watchdog that forces or
suppresses EOS from the text-speech alignment of one attention layer.

Port of ``chatterbox_tpu/models/t3/alignment.py:33-138`` (itself the
reference's AlignmentStreamAnalyzer, reduced to running statistics and
vectorised over the batch). Per decode step it reads the alignment layer's
head-mean attention over the text (B, S_text) and keeps O(B * S_text) state:

  - false start: no strong early-text activation yet;
  - completion: the alignment position reached the last 3 text tokens;
  - long tail: final-token activations persist for >= 10 frames;
  - repetition: pre-final-token activations after completion;
  - discontinuity-gated position tracking (-4 < delta < 7);
  - force EOS on long tail or repetition (logits -2^15 everywhere but EOS,
    +2^15 at EOS); suppress EOS (-2^15) until the alignment nears the end.
"""

from typing import NamedTuple

import torch

BIG = 2.0 ** 15
_NOT_DONE = torch.iinfo(torch.int32).max  # completed_at before completion


class AlignState(NamedTuple):
    """Running statistics of the alignment (all on the decode's device)."""

    head_max: torch.Tensor  # (B,) f32: max over steps of max(chunk[:, :4])
    tail_prev: torch.Tensor  # (B,) f32: last step's max over the last-2 text cols
    tail_mass: torch.Tensor  # (B, S_text) f32: per-column sum of post-completion rows
    rep_sum: torch.Tensor  # (B,) f32: sum of post-completion pre-final-col maxima
    text_position: torch.Tensor  # (B,) int32
    started: torch.Tensor  # (B,) bool
    complete: torch.Tensor  # (B,) bool
    completed_at: torch.Tensor  # (B,) int32 (int32 max before completion)


def init_align_state(b: int, s_text: int, *, device=None) -> AlignState:
    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return AlignState(
        head_max=zeros(b), tail_prev=zeros(b), tail_mass=zeros(b, s_text), rep_sum=zeros(b),
        text_position=zeros(b, dtype=torch.int32), started=zeros(b, dtype=torch.bool),
        complete=zeros(b, dtype=torch.bool),
        completed_at=torch.full((b,), _NOT_DONE, dtype=torch.int32, device=device),
    )


def alignment_step(state: AlignState, attn_row, text_lens, step_i: int, logits, eos_idx: int):
    """One analyzer step. attn_row (B, S_text) is the alignment layer's
    head-mean text attention of the previous token; text_lens (B,) the true
    text lengths (SOT/EOT included); logits (B, vocab) the CFG-combined
    logits. Returns (new state, possibly modified logits)."""
    s = attn_row.shape[1]
    cols = torch.arange(s, device=attn_row.device)[None]  # (1, S)
    lens = text_lens.to(attn_row.device).long()[:, None]  # (B, 1)
    valid_text = cols < lens

    # columns up to step_i + 1 only (the reference keeps cols <= its frame
    # index, which runs one ahead of this loop's step; see the JAX module)
    chunk = torch.where(valid_text & (cols <= step_i + 1), attn_row, 0.0)

    cur_pos = torch.argmax(chunk, dim=1).to(torch.int32)
    delta = cur_pos - state.text_position
    discontinuity = ~((delta > -4) & (delta < 7))
    text_position = torch.where(discontinuity, state.text_position, cur_pos)

    tail_cur = torch.where(cols >= lens - 2, chunk, 0.0).amax(dim=1)
    tail_act = torch.maximum(state.tail_prev, tail_cur)
    head_max = torch.maximum(state.head_max, torch.where(cols < 4, chunk, 0.0).amax(dim=1))
    false_start = ~state.started & ((tail_act > 0.1) | (head_max < 0.5))
    started = state.started | ~false_start

    complete = state.complete | (text_position >= lens[:, 0] - 3)
    completed_at = torch.where(complete & (state.completed_at == _NOT_DONE),
                               torch.full_like(state.completed_at, step_i), state.completed_at)

    # post-completion accumulators: rows strictly after the completion row
    post = complete & (step_i > completed_at)
    tail_mass = state.tail_mass + torch.where(post[:, None] & (cols >= lens - 3), chunk, 0.0)
    long_tail = complete & (tail_mass.amax(dim=1) >= 10.0)
    pre_final = valid_text & (cols < lens - 5)
    rep_sum = state.rep_sum + torch.where(
        post, torch.where(pre_final, chunk, 0.0).amax(dim=1), 0.0)
    repetition = complete & (rep_sum > 5.0)

    force_eos = long_tail | repetition
    is_eos = torch.arange(logits.shape[-1], device=logits.device)[None] == eos_idx  # (1, V)
    forced = torch.where(is_eos, BIG, -BIG).to(logits.dtype)
    logits = torch.where(force_eos[:, None], forced, logits)
    suppress = cur_pos < (lens[:, 0] - 3)
    logits = torch.where((suppress & ~force_eos)[:, None] & is_eos, -BIG, logits)

    new_state = AlignState(head_max, tail_cur, tail_mass, rep_sum, text_position, started,
                           complete, completed_at)
    return new_state, logits
