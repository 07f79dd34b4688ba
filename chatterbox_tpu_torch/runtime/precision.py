"""Precision policy of a TTS pipeline's weights.

Port of ``chatterbox_tpu/runtime/precision.py``: T3 and the flow (and the S3
tokenizer, where present) in the working dtype, HiFT and CAMPPlus in fp32;
T3's q/k/v fused into one projection a layer; optionally T3's projections
int8 with per-output-channel scales (``CHATTERBOX_W_QUANT``).
"""

import os

import torch

from ..models.t3.llama import fuse_qkv_params, quantize_llama_weights
from ..weights import tree_to


def cast_floating(tree, dtype):
    """A copy of ``tree`` with its floating leaves cast to ``dtype``; integer
    and boolean leaves are kept as they are."""
    return tree_to(tree, dtype=dtype)


def apply_tts_precision(tts, dtype=torch.bfloat16, weight_quant=None):
    """Set a ``ChatterboxTTS``'s weights to the runtime precision, in place
    on the object (returned): T3 cast to ``dtype`` and its q/k/v fused, the
    flow (and the S3 tokenizer, where present) cast to ``dtype``, HiFT and
    CAMPPlus left fp32.

    ``weight_quant`` (default: ``CHATTERBOX_W_QUANT=1``, else off) also
    stores T3's projections int8 with per-output-channel scales
    (``quantize_llama_weights``). The JAX package fuses and quantizes only
    without a device mesh, whose sharding specs address the canonical
    layout; the port runs on one card and has no mesh, so it always does.
    T3 on the Granite backbone (``p["granite"]``) is cast and nothing more:
    its attention layers keep separate q/k/v, and int8 weights raise."""
    tts.t3_params = cast_floating(tts.t3_params, dtype)
    if weight_quant is None:
        weight_quant = os.environ.get("CHATTERBOX_W_QUANT", "0") == "1"
    t3p = dict(tts.t3_params)
    if "granite" in t3p:  # the Granite backbone: cast only
        if weight_quant:
            raise ValueError("the Granite 4.0-H backbone has no int8 weights")
    else:
        t3p["llama"] = fuse_qkv_params(t3p["llama"])
        if weight_quant:
            t3p["llama"] = quantize_llama_weights(t3p["llama"])
    tts.t3_params = t3p
    sp = dict(tts.s3gen_params)
    sp["flow"] = cast_floating(sp["flow"], dtype)
    if sp.get("tokenizer") is not None:
        sp["tokenizer"] = cast_floating(sp["tokenizer"], dtype)
    tts.s3gen_params = sp
    return tts
