"""A writer of the reference checkpoint set (the published ResembleAI/chatterbox
layout), from parameter trees in the JAX package's layouts.

It inverts the converters' rules (``convert_t3``, ``convert_s3gen``,
``convert_voice_encoder`` and the helpers of ``checkpoint/torch_convert.py``):
linear weights back to (Cout, Cin), conv weights to (Cout, Cin, W), the
HiFT ``ups`` to (Cin, Cout, W), CAMPPlus's conv2d to (Cout, Cin, KH, KW),
the stacked T3 layers split per layer with ``gate_up`` split into the gate
and up projections, the UNet's fused ``to_qkv`` into ``to_q``/``to_k``/
``to_v``, the LSTM biases as ``bias_ih`` with a zero ``bias_hh``, and the
weight-normed HiFT convs as a (g, v) pair in either spelling. It writes the
files ``from_local`` reads: ``ve``, ``t3_cfg`` and ``s3gen.safetensors``,
a chatterbox-shaped ``tokenizer.json`` and a ``conds.pt``.

The weight-norm pair is exact: v is the weight and g its norm in float64,
so the converters' fold gives the weight back bit for bit
(``weight_norm_pair`` checks it), and the whole set converts back to the
tree it was written from. (A reference checkpoint holds g in float32, whose
fold rounds some elements to a neighbour: cast g to float32 to test that.)

Imports torch and numpy only: the card's smoke run (``chip_smoke.py``)
uses it too.
"""

import json
import random
import string
import struct
from pathlib import Path

import numpy as np
import torch

_ST_DTYPES = {np.dtype(np.float32): "F32", np.dtype(np.float64): "F64",
              np.dtype(np.int64): "I64", np.dtype(np.int32): "I32"}


def save_state_dict(sd, path):
    """{name: numpy array} -> a .safetensors file (the format's own rules: an
    8-byte little-endian header length, the JSON header, the bytes)."""
    header, offset, arrays = {}, 0, []
    for name, a in sd.items():
        a = np.ascontiguousarray(a)
        header[name] = {"dtype": _ST_DTYPES[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
        arrays.append(a)
    blob = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)) + blob)
        for a in arrays:
            f.write(a.data)


# ---------------------------------------------------------------------------
# leaf rules, the inverses of checkpoint/torch_convert.py's
# ---------------------------------------------------------------------------


def _fold(g, v):
    """The converters' fold: w = g * v / ||v|| over the dims after 0, in
    float64, cast to float32."""
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=tuple(range(1, v.ndim)),
                          keepdims=True))
    return (g.astype(np.float64) / norm * v.astype(np.float64)).astype(np.float32)


def weight_norm_pair(w):
    """(g, v) for weight ``w`` (torch layout, dim 0 kept) with ``_fold(g, v)``
    equal to ``w`` bit for bit: v = w, and g its norm over the other dims in
    float64, computed as the fold computes it, so g / ||v|| is exactly 1. A
    float32 g is within half an ulp of the norm, and the fold then rounds
    some elements of some rows to a neighbour; no float32 v corrects that
    for every row, since the fold depends on v's direction only."""
    v = np.ascontiguousarray(w, np.float32)
    g = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=tuple(range(1, v.ndim)), keepdims=True))
    if not np.array_equal(_fold(g, v), v):
        raise ValueError(f"the weight-norm fold does not return a weight of shape {v.shape}")
    return g, v


def _lin(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.asarray(p["w"]).T)
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _emb(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.asarray(p["w"])


def _weight(sd, prefix, w, weight_norm):
    """A torch-layout weight, plain or as the (g, v) pair of a spelling."""
    if weight_norm is None:
        sd[f"{prefix}.weight"] = w
        return
    g, v = weight_norm_pair(w)
    names = {"weight_g": ("weight_g", "weight_v"),
             "parametrizations": ("parametrizations.weight.original0",
                                  "parametrizations.weight.original1")}[weight_norm]
    sd[f"{prefix}.{names[0]}"], sd[f"{prefix}.{names[1]}"] = g, v


def _conv(sd, prefix, p, weight_norm=None):
    _weight(sd, prefix, np.ascontiguousarray(np.transpose(np.asarray(p["w"]), (2, 1, 0))),
            weight_norm)
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _conv_t(sd, prefix, p, weight_norm=None):
    # (W, Cin, Cout) -> (Cin, Cout, W), torch's ConvTranspose1d layout
    _weight(sd, prefix, np.ascontiguousarray(np.transpose(np.asarray(p["w"]), (1, 2, 0))),
            weight_norm)
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _conv2d(sd, prefix, p):
    sd[f"{prefix}.weight"] = np.ascontiguousarray(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)))
    if "b" in p:
        sd[f"{prefix}.bias"] = np.asarray(p["b"])


def _ln(sd, prefix, p):
    sd[f"{prefix}.weight"], sd[f"{prefix}.bias"] = np.asarray(p["scale"]), np.asarray(p["bias"])


def _bn(sd, prefix, p):
    sd[f"{prefix}.running_mean"] = np.asarray(p["mean"])
    sd[f"{prefix}.running_var"] = np.asarray(p["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)  # torch's; no converter reads it
    if "scale" in p:
        _ln(sd, prefix, p)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def llama_state_dict(sd, tree, prefix="tfmr."):
    """The inverse of ``convert_llama``: the stacked (L, Cin, Cout) weights
    per layer, ``gate_up`` split in its two halves."""
    layers = {k: np.asarray(v.get("w", v.get("scale"))) for k, v in tree["layers"].items()}
    f = layers["gate_up"].shape[-1] // 2
    for i in range(layers["q"].shape[0]):
        lp = f"{prefix}layers.{i}."
        sd[lp + "input_layernorm.weight"] = layers["input_ln"][i]
        sd[lp + "post_attention_layernorm.weight"] = layers["post_ln"][i]
        for name, key in (("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                          ("v", "self_attn.v_proj"), ("o", "self_attn.o_proj"),
                          ("down", "mlp.down_proj")):
            sd[f"{lp}{key}.weight"] = np.ascontiguousarray(layers[name][i].T)
        sd[lp + "mlp.gate_proj.weight"] = np.ascontiguousarray(layers["gate_up"][i][:, :f].T)
        sd[lp + "mlp.up_proj.weight"] = np.ascontiguousarray(layers["gate_up"][i][:, f:].T)
    sd[prefix + "norm.weight"] = np.asarray(tree["final_ln"]["scale"])


def t3_state_dict(tree):
    """The T3 tree -> the reference ``t3_cfg`` state dict."""
    sd = {}
    llama_state_dict(sd, tree["llama"])
    ce = tree["cond_enc"]
    _lin(sd, "cond_enc.spkr_enc", ce["spkr_enc"])
    _lin(sd, "cond_enc.emotion_adv_fc", ce["emotion_adv_fc"])
    sd["cond_enc.perceiver.pre_attention_query"] = np.asarray(ce["perceiver"]["query"])
    attn = ce["perceiver"]["attn"]
    _ln(sd, "cond_enc.perceiver.attn.norm", attn["norm"])
    for name in ("to_q", "to_k", "to_v", "proj_out"):
        _lin(sd, f"cond_enc.perceiver.attn.{name}", attn[name])
    _emb(sd, "text_emb", tree["text_emb"])
    _emb(sd, "speech_emb", tree["speech_emb"])
    _emb(sd, "text_pos_emb.emb", tree["text_pos_emb"])
    _emb(sd, "speech_pos_emb.emb", tree["speech_pos_emb"])
    _lin(sd, "text_head", tree["text_head"])
    _lin(sd, "speech_head", tree["speech_head"])
    return sd


def ve_state_dict(tree):
    """The voice-encoder tree -> the reference ``ve`` state dict."""
    sd = {}
    for i, lp in enumerate(tree["lstm"]):
        sd[f"lstm.weight_ih_l{i}"] = np.ascontiguousarray(np.asarray(lp["w_ih"]).T)
        sd[f"lstm.weight_hh_l{i}"] = np.ascontiguousarray(np.asarray(lp["w_hh"]).T)
        sd[f"lstm.bias_ih_l{i}"] = np.asarray(lp["b"])
        sd[f"lstm.bias_hh_l{i}"] = np.zeros_like(np.asarray(lp["b"]))  # b + 0 == b exactly
    _lin(sd, "proj", tree["proj"])
    return sd


def conformer_state_dict(sd, tree, prefix):
    def layer(lp, p):
        _ln(sd, f"{lp}.norm_mha", p["norm_mha"])
        _ln(sd, f"{lp}.norm_ff", p["norm_ff"])
        a = p["attn"]
        for name, key in (("q", "linear_q"), ("k", "linear_k"), ("v", "linear_v"),
                          ("out", "linear_out"), ("pos", "linear_pos")):
            _lin(sd, f"{lp}.self_attn.{key}", a[name])
        sd[f"{lp}.self_attn.pos_bias_u"] = np.asarray(a["pos_bias_u"])
        sd[f"{lp}.self_attn.pos_bias_v"] = np.asarray(a["pos_bias_v"])
        _lin(sd, f"{lp}.feed_forward.w_1", p["ff_w1"])
        _lin(sd, f"{lp}.feed_forward.w_2", p["ff_w2"])

    for name in ("embed", "up_embed"):
        _lin(sd, f"{prefix}{name}.out.0", tree[name]["linear"])
        _ln(sd, f"{prefix}{name}.out.1", tree[name]["ln"])
    _conv(sd, prefix + "pre_lookahead_layer.conv1", tree["pre_lookahead"]["conv1"])
    _conv(sd, prefix + "pre_lookahead_layer.conv2", tree["pre_lookahead"]["conv2"])
    for i, p in enumerate(tree["encoders"]):
        layer(f"{prefix}encoders.{i}", p)
    _conv(sd, prefix + "up_layer.conv", tree["up_layer"]["conv"])
    for i, p in enumerate(tree["up_encoders"]):
        layer(f"{prefix}up_encoders.{i}", p)
    _ln(sd, prefix + "after_norm", tree["after_norm"])


def unet_state_dict(sd, tree, prefix):
    def resnet(rp, p):
        for blk in ("block1", "block2"):
            _conv(sd, f"{rp}.{blk}.block.0", p[blk]["conv"])
            _ln(sd, f"{rp}.{blk}.block.2", p[blk]["ln"])
        _lin(sd, f"{rp}.mlp.1", p["mlp"])
        _conv(sd, f"{rp}.res_conv", p["res_conv"])

    def tf(bp, p):
        _ln(sd, f"{bp}.norm1", p["norm1"])
        _ln(sd, f"{bp}.norm3", p["norm3"])
        qkv = np.asarray(p["attn"]["to_qkv"]["w"])
        for name, w in zip("qkv", np.split(qkv, 3, axis=1)):
            _lin(sd, f"{bp}.attn1.to_{name}", {"w": w})
        _lin(sd, f"{bp}.attn1.to_out.0", p["attn"]["to_out"])
        _lin(sd, f"{bp}.ff.net.0.proj", p["ff_in"])
        _lin(sd, f"{bp}.ff.net.2", p["ff_out"])

    _lin(sd, prefix + "time_mlp.linear_1", tree["time_mlp1"])
    _lin(sd, prefix + "time_mlp.linear_2", tree["time_mlp2"])
    resnet(prefix + "down_blocks.0.0", tree["down_resnet"])
    for i, p in enumerate(tree["down_tf"]):
        tf(f"{prefix}down_blocks.0.1.{i}", p)
    _conv(sd, prefix + "down_blocks.0.2", tree["down_conv"])
    for m, mid in enumerate(tree["mid"]):
        resnet(f"{prefix}mid_blocks.{m}.0", mid["resnet"])
        for i, p in enumerate(mid["tf"]):
            tf(f"{prefix}mid_blocks.{m}.1.{i}", p)
    resnet(prefix + "up_blocks.0.0", tree["up_resnet"])
    for i, p in enumerate(tree["up_tf"]):
        tf(f"{prefix}up_blocks.0.1.{i}", p)
    _conv(sd, prefix + "up_blocks.0.2", tree["up_conv"])
    _conv(sd, prefix + "final_block.block.0", tree["final_block"]["conv"])
    _ln(sd, prefix + "final_block.block.2", tree["final_block"]["ln"])
    _conv(sd, prefix + "final_proj", tree["final_proj"])


def flow_state_dict(sd, tree, prefix="flow."):
    _emb(sd, prefix + "input_embedding", tree["input_embedding"])
    _lin(sd, prefix + "spk_embed_affine_layer", tree["spk_embed_affine"])
    conformer_state_dict(sd, tree["encoder"], prefix + "encoder.")
    _lin(sd, prefix + "encoder_proj", tree["encoder_proj"])
    unet_state_dict(sd, tree["estimator"], prefix + "decoder.estimator.")


def hift_state_dict(sd, tree, prefix="mel2wav.", weight_norm="parametrizations"):
    """HiFT, its weight-normed convs as (g, v) pairs in ``weight_norm``'s
    spelling (the source convs are plain, as in the reference)."""
    def res(rp, p):
        for j in range(len(p["convs1"])):
            _conv(sd, f"{rp}.convs1.{j}", p["convs1"][j], weight_norm)
            _conv(sd, f"{rp}.convs2.{j}", p["convs2"][j], weight_norm)
            sd[f"{rp}.activations1.{j}.alpha"] = np.asarray(p["alphas1"][j]["alpha"])
            sd[f"{rp}.activations2.{j}.alpha"] = np.asarray(p["alphas2"][j]["alpha"])

    _conv(sd, prefix + "conv_pre", tree["conv_pre"], weight_norm)
    for i, p in enumerate(tree["ups"]):
        _conv_t(sd, f"{prefix}ups.{i}", p, weight_norm)
    for i, p in enumerate(tree["source_downs"]):
        _conv(sd, f"{prefix}source_downs.{i}", p)
    for i, p in enumerate(tree["source_resblocks"]):
        res(f"{prefix}source_resblocks.{i}", p)
    for i, p in enumerate(tree["resblocks"]):
        res(f"{prefix}resblocks.{i}", p)
    _conv(sd, prefix + "conv_post", tree["conv_post"], weight_norm)
    _lin(sd, prefix + "m_source.l_linear", tree["m_source_linear"])
    for i, p in enumerate(tree["f0_predictor"]["convs"]):
        _conv(sd, f"{prefix}f0_predictor.condnet.{2 * i}", p, weight_norm)
    _lin(sd, prefix + "f0_predictor.classifier", tree["f0_predictor"]["classifier"])


def campplus_state_dict(sd, tree, prefix="speaker_encoder."):
    head, x = prefix + "head.", prefix + "xvector."
    h = tree["head"]
    _conv2d(sd, head + "conv1", h["conv1"])
    _bn(sd, head + "bn1", h["bn1"])
    for layer in ("layer1", "layer2"):
        for j, p in enumerate(h[layer]):
            rp = f"{head}{layer}.{j}"
            _conv2d(sd, rp + ".conv1", p["conv1"])
            _bn(sd, rp + ".bn1", p["bn1"])
            _conv2d(sd, rp + ".conv2", p["conv2"])
            _bn(sd, rp + ".bn2", p["bn2"])
            if "shortcut_conv" in p:
                _conv2d(sd, rp + ".shortcut.0", p["shortcut_conv"])
                _bn(sd, rp + ".shortcut.1", p["shortcut_bn"])
    _conv2d(sd, head + "conv2", h["conv2"])
    _bn(sd, head + "bn2", h["bn2"])
    _conv(sd, x + "tdnn.linear", tree["tdnn"]["conv"])
    _bn(sd, x + "tdnn.nonlinear.batchnorm", tree["tdnn"]["nl"])
    for bi, blk in enumerate(tree["blocks"], start=1):
        for i, p in enumerate(blk["layers"]):
            lp = f"{x}block{bi}.tdnnd{i + 1}."
            _bn(sd, lp + "nonlinear1.batchnorm", p["nl1"])
            _conv(sd, lp + "linear1", p["lin1"])
            _bn(sd, lp + "nonlinear2.batchnorm", p["nl2"])
            _conv(sd, lp + "cam_layer.linear_local", p["cam"]["local"])
            _conv(sd, lp + "cam_layer.linear1", p["cam"]["lin1"])
            _conv(sd, lp + "cam_layer.linear2", p["cam"]["lin2"])
        _bn(sd, f"{x}transit{bi}.nonlinear.batchnorm", blk["transit_nl"])
        _conv(sd, f"{x}transit{bi}.linear", blk["transit"])
    _bn(sd, x + "out_nonlinear.batchnorm", tree["out_nl"])
    _conv(sd, x + "dense.linear", tree["dense"]["conv"])
    _bn(sd, x + "dense.nonlinear.batchnorm", tree["dense"]["bn"])


def sinusoids(length, channels):
    """Whisper's positional embedding (the tokenizer's shipped buffer)."""
    inv = np.exp(-np.log(10000.0) / (channels // 2 - 1) * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def s3tokenizer_state_dict(sd, tree, prefix="tokenizer.", n_audio_ctx=1500):
    """The S3TokenizerV2 subtree, with its positional buffer and the FSQ
    projection under ``quantizer._codebook`` (the converter finds it by
    suffix)."""
    e = prefix + "encoder."
    _conv(sd, e + "conv1", tree["conv1"])
    _conv(sd, e + "conv2", tree["conv2"])
    for i, p in enumerate(tree["blocks"]):
        b = f"{e}blocks.{i}."
        _ln(sd, b + "attn_ln", p["attn_ln"])
        for name, key in (("q", "query"), ("k", "key"), ("v", "value"), ("attn_out", "out")):
            _lin(sd, f"{b}attn.{key}", p[name])
        _conv(sd, b + "attn.fsmn_block", p["fsmn"])
        _ln(sd, b + "mlp_ln", p["mlp_ln"])
        _lin(sd, b + "mlp.0", p["mlp1"])
        _lin(sd, b + "mlp.2", p["mlp2"])
    _ln(sd, e + "ln_post", tree["ln_post"])
    width = np.asarray(tree["conv1"]["w"]).shape[-1]
    sd[e + "positional_embedding"] = sinusoids(n_audio_ctx, width)
    _lin(sd, prefix + "quantizer._codebook.project_down", tree["fsq_proj"])


def s3gen_state_dict(tree, weight_norm="parametrizations"):
    """The S3Gen tree -> the reference ``s3gen`` state dict: the flow, HiFT
    under ``mel2wav.``, CAMPPlus under ``speaker_encoder.`` and, when the
    tree has one, the tokenizer under ``tokenizer.``."""
    sd = {}
    flow_state_dict(sd, tree["flow"])
    hift_state_dict(sd, tree["hift"], weight_norm=weight_norm)
    campplus_state_dict(sd, tree["campplus"])
    if tree.get("tokenizer") is not None:
        s3tokenizer_state_dict(sd, tree["tokenizer"])
    return sd


# ---------------------------------------------------------------------------
# tokenizer.json, conds.pt and the whole set
# ---------------------------------------------------------------------------


def tokenizer_spec(seed=0, n_merges=400):
    """A chatterbox-shaped tokenizer.json (tests/test_tokenizer_fuzz.py's
    ``build_spec``): a character vocabulary with learned-looking merges and
    the [UNK]/[START]/[STOP]/[SPACE] specials, under 704 ids."""
    rng = random.Random(seed)
    specials = ["[UNK]", "[START]", "[STOP]", "[SPACE]"]
    chars = list(string.ascii_lowercase) + list(string.ascii_uppercase) + \
        list("0123456789") + list(".,!?'-\"():;")
    vocab = {t: i for i, t in enumerate(specials)}
    for c in chars:
        vocab[c] = len(vocab)
    merges, tokens = [], list(chars)
    for _ in range(n_merges):
        a, b = rng.choice(tokens), rng.choice(tokens)
        merged = a + b
        if merged in vocab or (a, b) in {tuple(m.split(" ", 1)) for m in merges}:
            continue
        if " " in merged:
            continue
        merges.append(f"{a} {b}")
        vocab[merged] = len(vocab)
        tokens.append(merged)
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": vocab[t], "content": t, "special": True, "single_word": False,
                          "lstrip": False, "rstrip": False, "normalized": False}
                         for t in specials],
        "normalizer": None, "pre_tokenizer": None, "post_processor": None, "decoder": None,
        "model": {"type": "BPE", "dropout": None, "unk_token": "[UNK]",
                  "continuing_subword_prefix": None, "end_of_word_suffix": None,
                  "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": merges},
    }


def write_conds_pt(path, speaker_emb, prompt_tokens, emotion_adv, prompt_token,
                   prompt_token_len, prompt_feat, embedding):
    """A reference ``conds.pt``: ``torch.save`` of {"t3": T3Cond's fields,
    "gen": the ref dict} (tts.py:91-103), the tokens int64 and the emotion
    (B, 1, 1), as the reference stores them."""
    def t(x, dtype=None):
        x = torch.as_tensor(np.asarray(x))
        return x if dtype is None else x.to(dtype)

    torch.save({
        "t3": {"speaker_emb": t(speaker_emb), "clap_emb": None,
               "cond_prompt_speech_tokens": t(prompt_tokens, torch.int64),
               "cond_prompt_speech_emb": None,
               "emotion_adv": t(emotion_adv).reshape(-1, 1, 1)},
        "gen": {"prompt_token": t(prompt_token, torch.int64),
                "prompt_token_len": t(prompt_token_len, torch.int64),
                "prompt_feat": t(prompt_feat), "prompt_feat_len": None,
                "embedding": t(embedding)},
    }, path)


def write_reference_set(out_dir, t3, s3gen, ve, conds=None, t3_prefix="",
                        weight_norm="parametrizations"):
    """Write a reference checkpoint set from JAX-layout trees (numpy):
    ``ve``, ``t3_cfg`` (its keys under ``t3_prefix``, e.g. "model.") and
    ``s3gen.safetensors``, ``tokenizer.json`` and, given ``conds`` (the
    seven arrays of ``write_conds_pt``, in its order), ``conds.pt``. Each
    state dict is written and dropped before the next is built."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    save_state_dict(ve_state_dict(ve), out / "ve.safetensors")
    save_state_dict({t3_prefix + k: v for k, v in t3_state_dict(t3).items()},
                    out / "t3_cfg.safetensors")
    save_state_dict(s3gen_state_dict(s3gen, weight_norm), out / "s3gen.safetensors")
    (out / "tokenizer.json").write_text(json.dumps(tokenizer_spec()))
    if conds is not None:
        write_conds_pt(out / "conds.pt", *conds)
    return out
