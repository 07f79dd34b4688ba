"""The pieces of the output check that both drivers share: the weights as
the reference takes them, the sample of requests to compare, and the
readings of the conditionals and of a waveform.

The reference runs on the device after the window, in fp32 with TF32 off;
a control (``--control 1``) runs it again in the precision one step below
the configuration's, and its readings stand beside the program's.
"""

import numpy as np
import torch

from .reference import pipeline as rp
from .reference.layers import cast_tree
from .reference.precision import lowered, tf32


def reference_trees(weights: dict, names, control: bool = False, formats=None):
    """The benchmark's weight trees as the reference takes them: fp32, or
    for the control each tree in its lower precision (``formats`` {name:
    "int8" | "fp8" | "bf16" | "fp32"}: rounded weights served in bf16 (in
    T3 the Llama layers' projections alone, as the program's own int8
    weights), bf16, or fp32 for the parts the control runs with TF32 or a
    bf16 trunk)."""
    out = {}
    for n in names:
        fmt = (formats or {}).get(n, "fp32") if control else "fp32"
        if fmt == "fp32":
            out[n] = cast_tree(weights[n], torch.float32)
        else:
            out[n] = lowered(weights[n], None if fmt == "bf16" else fmt,
                             scope="layers" if n == "t3" else None)
    return out


def sample_rows(seed: int, tag: int, pool, count: int, length):
    """``count`` entries of ``pool`` drawn from the seed, the longest (by
    ``length``; among equals, the first drawn) always among them."""
    order = list(np.random.default_rng([seed, 1 << 21, tag]).permutation(len(pool)))
    if not order:
        return []
    longest = max(order, key=lambda i: length(pool[i]))  # max keeps the first of equals
    return [pool[i] for i in [longest] + [i for i in order if i != longest][: count - 1]]


def conditional_readings(got: dict, want: dict) -> dict:
    """``cond_err``: the largest relative L2 error of the float
    conditionals (the speaker embeddings and the prompt mels, over the
    frames both have); ``cond_tok_err``: the share of prompt tokens that
    differ, over the tokens both have."""
    errs, diff, total = [], 0, 0
    for k in ("speaker_emb", "embedding", "prompt_feat"):
        if k in got:
            g, w = got[k].float(), want[k].float()
            n = min(g.shape[1], w.shape[1])
            errs.append(rp.relative_error(g[:, :n], w[:, :n]))
    for k in ("t3_prompt_tokens", "prompt_token"):
        if k in got:
            g, w = got[k].reshape(-1).cpu(), want[k].reshape(-1).cpu()
            n = min(len(g), len(w))
            diff += int((g[:n] != w[:n]).sum()) + abs(len(g) - len(w))
            total += max(len(g), len(w))
    return {"cond_err": float(np.max(errs)), "cond_tok_err": diff / max(total, 1)}


def wav_readings(served, want) -> dict:
    """A served waveform against the reference's: ``wav_spec_err`` over the
    whole spectrum, ``wav_band_err`` over the watermark's band (STFT 512,
    hop 128, bins 40-200: 1.9-9.4 kHz), where a watermark left out shows."""
    return {"wav_spec_err": rp.spectral_error(served, want),
            "wav_band_err": rp.spectral_error(served, want, 512, 128, (40, 200))}


def merge_max(acc: dict, new: dict) -> dict:
    """``acc`` with each reading the larger of its own and ``new``'s; a NaN
    on either side stays NaN."""
    for k, v in new.items():
        old = acc.get(k, v)
        acc[k] = float("nan") if np.isnan(old) or np.isnan(v) else max(old, v)
    return acc

