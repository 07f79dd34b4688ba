"""Weight bridge: the JAX package's parameter pytrees -> the port's parameter
dicts, the native checkpoint reader, and the port's own seeded inits.

The JAX package keeps linear weights as (Cin, Cout) and conv weights as
(W, Cin, Cout). The port keeps PyTorch's layouts, and every layout change
happens here, once:
  - linear (Cin, Cout) -> (Cout, Cin); the stacked T3 layers (L, Cin, Cout)
    -> (L, Cout, Cin)
  - conv1d (W, Cin, Cout) -> (Cout, Cin, W)
  - conv_transpose1d (W, Cin, Cout) -> (Cin, Cout, W) (the HiFT ``ups``)
  - embedding tables stay (N, C)
Only leaves named ``w`` change; everything else (norm scales, biases, snake
alphas, the perceiver query, rel-pos biases) passes through.

``load_native`` reads the ``*.jax.safetensors`` files the JAX package's
``save_native`` writes: keys are slash-joined tree paths, ``#i`` a list
index and ``@none`` a None leaf (checkpoint/pytree_io.py:16-51).
"""

import numpy as np
import torch

from .checkpoint.safetensors_io import load_safetensors

_EMBEDDINGS = {"text_emb", "speech_emb", "text_pos_emb", "speech_pos_emb", "input_embedding"}


def _layout(path, ndim):
    """Layout kind of leaf ``path`` (a tuple of dict keys and list indices)."""
    if not path or path[-1] != "w":
        return "as_is"
    names = [p for p in path[:-1] if isinstance(p, str)]
    owner = names[-1] if names else ""
    if "llama" in names:
        return "linear" if ndim == 3 else "as_is"
    if owner in _EMBEDDINGS:
        return "as_is"
    if owner == "ups" and ndim == 3:
        return "conv_transpose"
    if ndim == 3:
        return "conv"
    if ndim == 2:
        return "linear"
    return "as_is"


def _to_port(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return x.transpose(-1, -2).contiguous()
    if kind == "conv":
        return x.permute(2, 1, 0).contiguous()
    if kind == "conv_transpose":
        return x.permute(1, 2, 0).contiguous()
    return x


def _from_port(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "linear":
        return x.transpose(-1, -2).contiguous()
    if kind == "conv":
        return x.permute(2, 1, 0).contiguous()
    if kind == "conv_transpose":
        return x.permute(2, 0, 1).contiguous()
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


def to_jax_tree(params):
    """Inverse of ``from_jax_tree``: the port's parameters -> numpy arrays in
    the JAX package's layouts (bf16 tensors come back as float32)."""
    def conv(path, t):
        t = _from_port(t.detach().cpu(), _layout(path, t.ndim))
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return _map_tree(params, conv)


def tree_to(tree, device=None, dtype=None):
    """Move a parameter tree to ``device``; cast floating leaves to ``dtype``."""
    def conv(path, t):
        if dtype is not None and t.is_floating_point():
            return t.to(device=device, dtype=dtype)
        return t.to(device=device)

    return _map_tree(tree, conv)


def _unflatten(flat):
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def convert(node):
        if not isinstance(node, dict):
            return node
        if "@none" in node:
            return None
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            return [convert(node[k]) for k in sorted(keys, key=lambda k: int(k[1:]))]
        return {k: convert(v) for k, v in node.items()}

    return convert(root)


def load_native(path):
    """A ``save_native`` ``*.jax.safetensors`` file -> the port's parameters
    (CPU tensors, PyTorch layouts). BF16 payloads are viewed as
    ``torch.bfloat16`` bit for bit."""
    arrays, bf16 = load_safetensors(path)
    flat = {}
    for name, a in arrays.items():
        t = torch.from_numpy(a.copy())
        flat[name] = t.view(torch.bfloat16) if name in bf16 else t
    tree = _unflatten(flat)
    return _map_tree(tree, lambda path, t: _to_port(t, _layout(path, t.ndim)))


# ---------------------------------------------------------------------------
# seeded inits, directly in the port's layouts (the card has no JAX). The
# distributions follow the JAX package's init_* functions.
# ---------------------------------------------------------------------------


class _Init:
    def __init__(self, seed: int, device, dtype):
        self.g = torch.Generator(device=device).manual_seed(int(seed))
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

    def conv(self, w, cin, cout, std):
        return {"w": self.normal((cout, cin, w), std), "b": self.zeros((cout,))}

    def norm(self, c):
        return {"scale": self.ones((c,)), "bias": self.zeros((c,))}


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
