"""Logits transforms and categorical sampling for the T3 decode loop.

Port of ``chatterbox_tpu/core/sampling.py``: the HF logits processors the
reference chains per decode step (t3/t3.py:301-341) -- temperature,
repetition penalty, min_p, top_p -- then an inverse-CDF draw from given
uniforms, so a test can feed both packages the same random numbers.
"""

from dataclasses import dataclass

import torch

_NEG = torch.finfo(torch.float32).min


@dataclass(frozen=True)
class SamplingConfig:
    temperature: float = 0.8
    top_p: float = 1.0
    min_p: float = 0.05
    repetition_penalty: float = 1.2
    cfg_weight: float = 0.5
    greedy: bool = False  # do_sample=False equivalent (argmax after processing)
    min_new_tokens: int = 0  # suppress EOS before this many tokens (HF min_new_tokens)


def apply_repetition_penalty(logits, seen_mask, penalty):
    """HF semantics: seen & logit>0 -> logit/penalty; seen & logit<=0 -> logit*penalty."""
    if penalty == 1.0:
        return logits
    penalized = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen_mask, penalized, logits)


def apply_min_p(logits, min_p):
    """Keep tokens with prob >= min_p * max_prob  <=>  logit >= max + ln(min_p)."""
    if min_p <= 0.0:
        return logits
    # ln(min_p) rounded to fp32 first, as the JAX chain computes it
    log_min_p = torch.log(torch.tensor(min_p, dtype=torch.float32)).item()
    thresh = torch.amax(logits, dim=-1, keepdim=True) + log_min_p
    return torch.where(logits >= thresh, logits, _NEG)


def apply_top_p(logits, top_p):
    """Nucleus filtering, exact HF TopPLogitsWarper semantics (ascending sort,
    remove while cumulative prob <= 1 - top_p, always keep the best token)."""
    if top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1).values  # ascending
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    n_remove = torch.sum(cum <= (1.0 - top_p), dim=-1, keepdim=True)
    kth = torch.gather(sorted_logits, -1, n_remove)  # smallest KEPT logit
    return torch.where(logits >= kth, logits, _NEG)


def sample_from_logits(logits, u):
    """Inverse-CDF categorical sample given uniform draws u (B,): the first
    index whose cumulative probability reaches u * total (the draw is scaled
    by the cumsum total, since fp32 rounding can leave it below 1)."""
    probs = torch.softmax(logits.float(), dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    u = u[:, None] * cum[:, -1:]
    # cum is nondecreasing: the count of entries below u is the first index
    # with cum >= u (argmin of ``cum < u``)
    return torch.sum(cum < u, dim=-1).to(torch.int32)


def cfg_combine(logits_cond, logits_uncond, cfg_weight):
    """Classifier-free guidance combine (t3.py:322-326)."""
    return logits_cond + cfg_weight * (logits_cond - logits_uncond)


def process_logits(logits, seen_mask, cfg: SamplingConfig):
    """Full per-step chain on CFG-combined logits, reference order
    (t3.py:330-337): temperature -> repetition penalty -> min_p -> top_p."""
    if cfg.temperature != 1.0:
        logits = logits / cfg.temperature
    logits = apply_repetition_penalty(logits, seen_mask, cfg.repetition_penalty)
    logits = apply_min_p(logits, cfg.min_p)
    logits = apply_top_p(logits, cfg.top_p)
    return logits
