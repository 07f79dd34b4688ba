"""T3 conditioning encoder: speaker projection + perceiver resampler +
emotion-intensity projection -> 34 conditioning positions.

Port of ``chatterbox_tpu/models/t3/cond_enc.py`` (reference
t3/modules/cond_enc.py:64-97 and t3/modules/perceiver.py:55-212).
"""

import torch

from ...checkpoint import torch_convert as tc
from ...core.layers import layer_norm, linear, merge_heads, sdpa, split_heads


def _attention_block(p, x1, x2, n_heads):
    """AttentionBlock2: shared-norm cross attention, residual on x1."""
    q = linear(p["to_q"], layer_norm(p["norm"], x1))
    x2n = layer_norm(p["norm"], x2)
    k = linear(p["to_k"], x2n)
    v = linear(p["to_v"], x2n)
    h = sdpa(split_heads(q, n_heads), split_heads(k, n_heads), split_heads(v, n_heads))
    return x1 + linear(p["proj_out"], merge_heads(h))


def perceiver(p, h, n_heads=4):
    """32 learned queries cross-attend to the 150-token speech-prompt
    embedding, then one self-attention pass."""
    query = p["query"].expand(h.shape[0], -1, -1)
    pre = _attention_block(p["attn"], query, h, n_heads)
    return _attention_block(p["attn"], pre, pre, n_heads)


def cond_embeds(p, speaker_emb, prompt_speech_emb, emotion_adv):
    """(B,256) speaker, (B,150,C) prompt embedding, (B,) emotion ->
    (B, 34, C) conditioning prefix."""
    spkr = linear(p["spkr_enc"], speaker_emb)[:, None]
    prompt = perceiver(p["perceiver"], prompt_speech_emb)
    emo = linear(p["emotion_adv_fc"], emotion_adv[:, None, None])
    return torch.cat([spkr, prompt, emo], dim=1)


def convert_cond_enc(sd, prefix="cond_enc."):
    """Reference ``T3CondEnc`` state dict -> the JAX package's tree (numpy),
    as ``chatterbox_tpu/models/t3/cond_enc.py::convert_cond_enc``."""
    attn = prefix + "perceiver.attn."
    return {
        "spkr_enc": tc.linear(sd, prefix + "spkr_enc"),
        "emotion_adv_fc": tc.linear(sd, prefix + "emotion_adv_fc"),
        "perceiver": {
            "query": tc.as_numpy(sd[prefix + "perceiver.pre_attention_query"]),
            "attn": {
                "norm": tc.layer_norm(sd, attn + "norm"),
                "to_q": tc.linear(sd, attn + "to_q"),
                "to_k": tc.linear(sd, attn + "to_k"),
                "to_v": tc.linear(sd, attn + "to_v"),
                "proj_out": tc.linear(sd, attn + "proj_out"),
            },
        },
    }
