"""Weight bridge: the JAX package's parameter pytrees -> the port's parameter
dicts, the native checkpoint reader, and the port's own seeded inits.

The JAX package keeps linear weights as (Cin, Cout) and conv weights as
(W, Cin, Cout). The port keeps PyTorch's layouts, and every layout change
happens here, once:
  - linear (Cin, Cout) -> (Cout, Cin); the stacked T3 layers (L, Cin, Cout)
    -> (L, Cout, Cin)
  - conv1d (W, Cin, Cout) -> (Cout, Cin, W)
  - conv2d (KH, KW, Cin, Cout) -> (Cout, Cin, KH, KW) (CAMPPlus's FCM head)
  - conv_transpose1d (W, Cin, Cout) -> (Cin, Cout, W) (the HiFT ``ups``)
  - embedding tables stay (N, C)
Only leaves named ``w`` change, and under ``llama`` also the int8 ``w8``
of the runtime layout (``quantize_llama_weights``), whose per-output
``scale`` (L, Cout) passes through; a fused ``qkv`` is a linear leaf like
any other. Everything else (norm scales, biases,
batch-norm statistics, snake alphas, the perceiver query, rel-pos biases)
passes through. So do the voice encoder's LSTM leaves ``w_ih`` (Cin, 4H)
and ``w_hh`` (H, 4H): ``core/layers.lstm`` multiplies by them in the JAX
layout.

``load_native`` reads the ``*.jax.safetensors`` files the JAX package's
``save_native`` writes: keys are slash-joined tree paths, ``#i`` a list
index and ``@none`` a None leaf (``checkpoint/pytree_io.py``, whose
``save_params`` writes them from ``jax_layout`` trees).
"""

import numpy as np
import torch

from .checkpoint.pytree_io import load_params

_EMBEDDINGS = {"text_emb", "speech_emb", "text_pos_emb", "speech_pos_emb", "input_embedding"}


def _layout(path, ndim):
    """Layout kind of leaf ``path`` (a tuple of dict keys and list indices)."""
    if not path:
        return "as_is"
    names = [p for p in path[:-1] if isinstance(p, str)]
    if "llama" in names and path[-1] in ("w", "w8"):
        return "linear" if ndim == 3 else "as_is"
    if path[-1] != "w":
        return "as_is"
    owner = names[-1] if names else ""
    if owner in _EMBEDDINGS:
        return "as_is"
    if owner == "ups" and ndim == 3:
        return "conv_transpose"
    if ndim == 4:
        return "conv2d"
    if ndim == 3:
        return "conv"
    if ndim == 2:
        return "linear"
    return "as_is"


# (to the port, back to the JAX package) permutations of each layout kind
_PERMS = {
    "conv": ((2, 1, 0), (2, 1, 0)),
    "conv2d": ((3, 2, 0, 1), (2, 3, 1, 0)),
    "conv_transpose": ((1, 2, 0), (2, 0, 1)),
}


def _to_port(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return x.transpose(-1, -2).contiguous()
    if kind in _PERMS:
        return x.permute(*_PERMS[kind][0]).contiguous()
    return x


def _from_port(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return x.transpose(-1, -2).contiguous()
    if kind in _PERMS:
        return x.permute(*_PERMS[kind][1]).contiguous()
    return x


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from a JAX array
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _map_tree(tree, fn, path=()):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn, path + (i,)) for i, v in enumerate(tree)]
    if tree is None:
        return None
    return fn(path, tree)


def from_jax_tree(tree):
    """JAX parameter pytree (numpy or JAX arrays) -> the port's parameters
    (nested dicts/lists of CPU torch tensors, PyTorch layouts)."""
    def conv(path, a):
        t = _tensor(a)
        return _to_port(t, _layout(path, t.ndim))

    return _map_tree(tree, conv)


def jax_layout(params):
    """The port's parameters -> CPU tensors in the JAX package's layouts,
    dtypes kept (the tree ``checkpoint/pytree_io.save_params`` writes)."""
    return _map_tree(params, lambda path, t: _from_port(t.detach().cpu(), _layout(path, t.ndim)))


def jax_layout_meta(params):
    """``jax_layout`` as meta tensors: each leaf's JAX-layout shape and
    dtype, without a copy of its data."""
    return _map_tree(params, lambda path, t: _from_port(
        torch.empty(t.shape, dtype=t.dtype, device="meta"), _layout(path, t.ndim)))


def from_jax_layout(tree):
    """Tensors in the JAX package's layouts (on any device) -> the port's
    layouts, on the same device."""
    return _map_tree(tree, lambda path, t: _to_port(t, _layout(path, t.ndim)))


def to_jax_tree(params):
    """Inverse of ``from_jax_tree``: the port's parameters -> numpy arrays in
    the JAX package's layouts (bf16 tensors come back as float32)."""
    def conv(path, t):
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()

    return _map_tree(jax_layout(params), conv)


def tree_to(tree, device=None, dtype=None):
    """Move a parameter tree to ``device``; cast floating leaves to ``dtype``."""
    def conv(path, t):
        if dtype is not None and t.is_floating_point():
            return t.to(device=device, dtype=dtype)
        return t.to(device=device)

    return _map_tree(tree, conv)


def load_native(path):
    """A ``save_native`` ``*.jax.safetensors`` file -> the port's parameters
    (CPU tensors, PyTorch layouts). BF16 payloads are viewed as
    ``torch.bfloat16`` bit for bit."""
    return from_jax_layout(load_params(path, device="cpu"))


# ---------------------------------------------------------------------------
# seeded inits, directly in the port's layouts (the card has no JAX). The
# distributions follow the JAX package's init_* functions.
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, seed: int, device, dtype):
        # the meta device (shapes only, ``runtime/fast_init.py``) has no generator
        self.g = (None if torch.device(device).type == "meta"
                  else torch.Generator(device=device).manual_seed(int(seed)))
        self.device = device
        self.dtype = dtype

    def normal(self, shape, std):
        x = torch.randn(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return (x * std).to(self.dtype)

    def uniform(self, shape, lo, hi):
        x = torch.rand(shape, generator=self.g, device=self.device, dtype=torch.float32)
        return (lo + (hi - lo) * x).to(self.dtype)

    def zeros(self, shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def ones(self, shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def lin(self, cin, cout, std=None, bias=True):
        p = {"w": self.normal((cout, cin), (cin ** -0.5) if std is None else std)}
        if bias:
            p["b"] = self.zeros((cout,))
        return p

    def conv(self, w, cin, cout, std, bias=True):
        p = {"w": self.normal((cout, cin, w), std)}
        if bias:
            p["b"] = self.zeros((cout,))
        return p

    def norm(self, c):
        return {"scale": self.ones((c,)), "bias": self.zeros((c,))}

    def batch_norm(self, c, affine=True):
        p = {"mean": self.zeros((c,)), "var": self.ones((c,))}
        if affine:
            p.update(self.norm(c))
        return p


def init_t3(cfg, seed: int = 0, device="cpu", dtype=torch.float32):
    """Random T3 parameters (llama + cond encoder + embeddings + heads)."""
    r = _Init(seed, device, dtype)
    lc = cfg.llama
    n_l, c, f = lc.num_hidden_layers, lc.hidden_size, lc.intermediate_size
    hd = lc.num_attention_heads * lc.head_dim
    kvd = lc.num_key_value_heads * lc.head_dim
    d, n_q = cfg.dim, 32
    qv = float(np.sqrt(3.0) * np.sqrt(2.0 / (n_q + n_q)))
    return {
        "llama": {
            "layers": {
                "input_ln": {"scale": r.ones((n_l, c))},
                "q": {"w": r.normal((n_l, hd, c), 0.02)},
                "k": {"w": r.normal((n_l, kvd, c), 0.02)},
                "v": {"w": r.normal((n_l, kvd, c), 0.02)},
                "o": {"w": r.normal((n_l, c, hd), 0.02)},
                "post_ln": {"scale": r.ones((n_l, c))},
                "gate_up": {"w": r.normal((n_l, 2 * f, c), 0.02)},
                "down": {"w": r.normal((n_l, c, f), 0.02)},
            },
            "final_ln": {"scale": r.ones((c,))},
        },
        "cond_enc": {
            "spkr_enc": r.lin(cfg.speaker_embed_size, d, 0.02),
            "emotion_adv_fc": r.lin(1, d, 0.02, bias=False),
            "perceiver": {
                "query": r.uniform((1, n_q, d), -qv, qv),
                "attn": {
                    "norm": r.norm(d),
                    "to_q": r.lin(d, d, 0.02),
                    "to_k": r.lin(d, d, 0.02),
                    "to_v": r.lin(d, d, 0.02),
                    "proj_out": r.lin(d, d, 0.02),
                },
            },
        },
        "text_emb": {"w": r.normal((cfg.text_tokens_dict_size, d), 0.02)},
        "speech_emb": {"w": r.normal((cfg.speech_tokens_dict_size, d), 0.02)},
        "text_pos_emb": {"w": r.normal((cfg.max_text_tokens + 2, d), 0.02)},
        "speech_pos_emb": {"w": r.normal((cfg.max_speech_tokens + 4, d), 0.02)},
        "text_head": {"w": r.normal((cfg.text_tokens_dict_size, d), 0.02)},
        "speech_head": {"w": r.normal((cfg.speech_tokens_dict_size, d), 0.02)},
    }


def _init_conformer(r, cfg):
    c, f = cfg.output_size, cfg.linear_units
    dk = c // cfg.attention_heads

    def layer():
        return {
            "norm_mha": r.norm(c),
            "norm_ff": r.norm(c),
            "attn": {
                "q": r.lin(c, c), "k": r.lin(c, c), "v": r.lin(c, c), "out": r.lin(c, c),
                "pos": r.lin(c, c, bias=False),
                "pos_bias_u": r.normal((cfg.attention_heads, dk), 0.02),
                "pos_bias_v": r.normal((cfg.attention_heads, dk), 0.02),
            },
            "ff_w1": r.lin(c, f),
            "ff_w2": r.lin(f, c),
        }

    def embed():
        return {"linear": r.lin(cfg.input_size, c), "ln": r.norm(c)}

    return {
        "embed": embed(),
        "pre_lookahead": {
            "conv1": r.conv(cfg.pre_lookahead_len + 1, c, c, 0.02),
            "conv2": r.conv(3, c, c, 0.02),
        },
        "encoders": [layer() for _ in range(cfg.num_blocks)],
        "up_layer": {"conv": r.conv(cfg.up_stride * 2 + 1, c, c, 0.02)},
        "up_embed": embed(),
        "up_encoders": [layer() for _ in range(cfg.num_up_blocks)],
        "after_norm": r.norm(c),
    }


def _init_unet(r, cfg):
    c, te = cfg.channels, cfg.time_embed_dim
    inner = cfg.num_heads * cfg.attention_head_dim

    def conv(w, i, o):
        return r.conv(w, i, o, (w * i) ** -0.5)

    def resnet(cin, cout):
        return {
            "block1": {"conv": conv(3, cin, cout), "ln": r.norm(cout)},
            "block2": {"conv": conv(3, cout, cout), "ln": r.norm(cout)},
            "mlp": r.lin(te, cout, 0.02),
            "res_conv": conv(1, cin, cout),
        }

    def tf():
        return {
            "norm1": r.norm(c),
            "norm3": r.norm(c),
            "attn": {"to_qkv": r.lin(c, 3 * inner, bias=False), "to_out": r.lin(inner, c)},
            "ff_in": r.lin(c, 4 * c),
            "ff_out": r.lin(4 * c, c),
        }

    return {
        "time_mlp1": r.lin(cfg.in_channels, te, 0.02),
        "time_mlp2": r.lin(te, te, 0.02),
        "down_resnet": resnet(cfg.in_channels, c),
        "down_tf": [tf() for _ in range(cfg.n_blocks)],
        "down_conv": conv(3, c, c),
        "mid": [
            {"resnet": resnet(c, c), "tf": [tf() for _ in range(cfg.n_blocks)]}
            for _ in range(cfg.num_mid_blocks)
        ],
        "up_resnet": resnet(2 * c, c),
        "up_tf": [tf() for _ in range(cfg.n_blocks)],
        "up_conv": conv(3, c, c),
        "final_block": {"conv": conv(3, c, c), "ln": r.norm(c)},
        "final_proj": conv(1, c, cfg.out_channels),
    }


def init_flow(cfg, seed: int = 0, device="cpu", dtype=torch.float32):
    """Random S3Gen flow parameters (token embedding, conformer, UNet)."""
    r = _Init(seed, device, dtype)
    return {
        "input_embedding": {"w": r.normal((cfg.vocab_size, cfg.input_size), 0.02)},
        "spk_embed_affine": r.lin(cfg.spk_embed_dim, cfg.output_size, 0.02),
        "encoder": _init_conformer(r, cfg.encoder),
        "encoder_proj": r.lin(cfg.encoder.output_size, cfg.output_size, 0.02),
        "estimator": _init_unet(r, cfg.estimator),
    }


def init_hift(cfg, seed: int = 0, device="cpu"):
    """Random HiFT vocoder parameters (always fp32)."""
    r = _Init(seed, device, torch.float32)
    n_fft2 = cfg.istft_n_fft + 2

    def resblock(ch, kernel, dilations):
        n = len(dilations)
        return {
            "convs1": [r.conv(kernel, ch, ch, 0.01) for _ in range(n)],
            "convs2": [r.conv(kernel, ch, ch, 0.01) for _ in range(n)],
            "alphas1": [{"alpha": r.ones((ch,))} for _ in range(n)],
            "alphas2": [{"alpha": r.ones((ch,))} for _ in range(n)],
        }

    p = {"conv_pre": r.conv(7, cfg.in_channels, cfg.base_channels, 0.01), "ups": []}
    for i, (u, k) in enumerate(zip(cfg.upsample_rates, cfg.upsample_kernel_sizes)):
        cin = cfg.base_channels // (2**i)
        cout = cfg.base_channels // (2 ** (i + 1))
        p["ups"].append({"w": r.normal((cin, cout, k), 0.01), "b": r.zeros((cout,))})
    p["source_downs"], p["source_resblocks"] = [], []
    for i, ((k, _s, _pad), rk, rd) in enumerate(zip(
        cfg.source_down_specs, cfg.source_resblock_kernel_sizes,
        cfg.source_resblock_dilation_sizes,
    )):
        ch = cfg.base_channels // (2 ** (i + 1))
        p["source_downs"].append(r.conv(k, n_fft2, ch, 0.01))
        p["source_resblocks"].append(resblock(ch, rk, rd))
    p["resblocks"] = []
    for i in range(len(cfg.upsample_rates)):
        ch = cfg.base_channels // (2 ** (i + 1))
        for k, d in zip(cfg.resblock_kernel_sizes, cfg.resblock_dilation_sizes):
            p["resblocks"].append(resblock(ch, k, d))
    p["conv_post"] = r.conv(7, ch, n_fft2, 0.01)
    p["m_source_linear"] = r.lin(cfg.nb_harmonics + 1, 1, 0.1)
    convs, cin = [], cfg.in_channels
    for _ in range(5):
        convs.append(r.conv(3, cin, cfg.f0_cond_channels, 0.05))
        cin = cfg.f0_cond_channels
    p["f0_predictor"] = {"convs": convs, "classifier": r.lin(cfg.f0_cond_channels, 1, 0.05)}
    return p


def init_voice_encoder(cfg, seed: int = 0, device="cpu"):
    """Random voice-encoder parameters (fp32; the LSTM in the JAX layout)."""
    r = _Init(seed, device, torch.float32)
    h, s = cfg.hidden_size, cfg.hidden_size ** -0.5
    layers, cin = [], cfg.num_mels
    for _ in range(cfg.num_layers):
        layers.append({"w_ih": r.uniform((cin, 4 * h), -s, s), "w_hh": r.uniform((h, 4 * h), -s, s),
                       "b": r.zeros((4 * h,))})
        cin = h
    return {"lstm": layers, "proj": r.lin(h, cfg.speaker_embed_size, 0.02)}


def init_campplus(cfg, seed: int = 0, device="cpu"):
    """Random CAMPPlus parameters (fp32), He-normal convs and identity
    batch-norm statistics, as the JAX package's ``init_campplus``."""
    r = _Init(seed, device, torch.float32)

    def c2(kh, kw, i, o):
        return {"w": r.normal((o, i, kh, kw), (2.0 / (kh * kw * i)) ** 0.5)}

    def c1(w, i, o, bias=False):
        return r.conv(w, i, o, (2.0 / (w * i)) ** 0.5, bias=bias)

    def res_block(c, stride):
        p = {"conv1": c2(3, 3, c, c), "bn1": r.batch_norm(c), "conv2": c2(3, 3, c, c),
             "bn2": r.batch_norm(c)}
        if stride != 1:
            p["shortcut_conv"] = c2(1, 1, c, c)
            p["shortcut_bn"] = r.batch_norm(c)
        return p

    m = cfg.m_channels
    p = {
        "head": {
            "conv1": c2(3, 3, 1, m), "bn1": r.batch_norm(m),
            "layer1": [res_block(m, 2), res_block(m, 1)],
            "layer2": [res_block(m, 2), res_block(m, 1)],
            "conv2": c2(3, 3, m, m), "bn2": r.batch_norm(m),
        },
        "tdnn": {"conv": c1(5, m * (cfg.feat_dim // 8), cfg.init_channels),
                 "nl": r.batch_norm(cfg.init_channels)},
        "blocks": [],
    }
    channels, bnc = cfg.init_channels, cfg.bn_size * cfg.growth_rate
    for n_layers in cfg.block_layers:
        layers = []
        for i in range(n_layers):
            cin = channels + i * cfg.growth_rate
            layers.append({
                "nl1": r.batch_norm(cin), "lin1": c1(1, cin, bnc), "nl2": r.batch_norm(bnc),
                "cam": {"local": c1(3, bnc, cfg.growth_rate),
                        "lin1": c1(1, bnc, bnc // 2, bias=True),
                        "lin2": c1(1, bnc // 2, cfg.growth_rate, bias=True)},
            })
        cin = channels + n_layers * cfg.growth_rate
        p["blocks"].append({"layers": layers, "transit_nl": r.batch_norm(cin),
                            "transit": c1(1, cin, cin // 2)})
        channels = cin // 2
    p["out_nl"] = r.batch_norm(channels)
    p["dense"] = {"conv": c1(1, channels * 2, cfg.embedding_size),
                  "bn": r.batch_norm(cfg.embedding_size, affine=False)}
    return p


def init_s3tokenizer(cfg, seed: int = 0, device="cpu"):
    """Random S3-tokenizer parameters (fp32): linears N(0, 1/Cin), convs
    N(0, 0.02^2), the FSMN conv depthwise (C, 1, K)."""
    r = _Init(seed, device, torch.float32)
    c = cfg.n_state

    def lin(i, o, bias=True):
        return r.lin(i, o, i ** -0.5, bias=bias)

    return {
        "conv1": r.conv(3, cfg.n_mels, c, 0.02),
        "conv2": r.conv(3, c, c, 0.02),
        "blocks": [
            {"attn_ln": r.norm(c), "q": lin(c, c), "k": lin(c, c, bias=False), "v": lin(c, c),
             "fsmn": r.conv(cfg.fsmn_kernel, 1, c, 0.02), "attn_out": lin(c, c),
             "mlp_ln": r.norm(c), "mlp1": lin(c, 4 * c), "mlp2": lin(4 * c, c)}
            for _ in range(cfg.n_layer)
        ],
        "ln_post": r.norm(c),
        "fsq_proj": lin(c, cfg.fsq_dim),
    }


def split_unet_qkv(flow_params):
    """A copy of flow parameters whose UNet attention weights are in the
    reference checkpoint's unfused layout: each fused ``to_qkv`` (3*inner,
    C) becomes ``to_q``/``to_k``/``to_v`` (inner, C) each. The same
    function: ``unet._attn`` then takes kernel K5 in place of K3."""
    def split(tree):
        if isinstance(tree, list):
            return [split(x) for x in tree]
        if not isinstance(tree, dict):
            return tree
        if "to_qkv" in tree:
            q, k, v = tree["to_qkv"]["w"].chunk(3, dim=0)
            rest = {n: x for n, x in tree.items() if n != "to_qkv"}
            return {**rest, **{n: {"w": w.contiguous()} for n, w in
                               (("to_q", q), ("to_k", k), ("to_v", v))}}
        return {n: split(x) for n, x in tree.items()}

    return split(flow_params)
