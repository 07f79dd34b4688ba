"""Functional NN building blocks over parameter dicts of torch tensors.

Port of ``chatterbox_tpu/core/layers.py``. Public layouts stay the JAX
package's: sequences are (B, T, C), images (B, H, W, C). Weights are in
PyTorch's layout, turned once by ``weights.py``:
  - linear: (Cout, Cin)
  - conv1d: (Cout, Cin/groups, W)
  - conv2d: (Cout, Cin, KH, KW)
  - conv_transpose1d: (Cin, Cout, W)
The LSTM keeps the JAX package's layout, w_ih (Cin, 4H) and w_hh (H, 4H),
because its explicit time loop multiplies by them as they are.
"""

import torch
import torch.nn.functional as F


def cast_tree(tree, dtype):
    """A copy of a nested dict/list tree with its floating tensors cast to
    ``dtype``; integer and boolean leaves are kept as they are."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [cast_tree(v, dtype) for v in tree]
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def linear(p, x):
    return F.linear(x, p["w"], p.get("b"))


def embedding(p, ids):
    return F.embedding(ids, p["w"])


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def batch_norm(p, x, eps=1e-5):
    """Inference-mode BatchNorm from running stats over the last axis;
    ``scale``/``bias`` are optional (an affine-free norm has neither)."""
    y = (x - p["mean"]) * torch.rsqrt(p["var"] + eps)
    if "scale" in p:
        y = y * p["scale"] + p["bias"]
    return y


def _pad_pair(padding):
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


def conv1d(p, x, stride=1, padding=0, dilation=1, groups=1):
    """1-D conv on (B, T, C) with weight (Cout, Cin/groups, W). ``padding``
    is a symmetric int or an explicit (lo, hi) pair."""
    w = p["w"]
    xc = x.to(w.dtype).transpose(1, 2)  # weights define compute precision
    lo, hi = _pad_pair(padding)
    if lo or hi:
        xc = F.pad(xc, (lo, hi))
    y = F.conv1d(xc, w, p.get("b"), stride=stride, dilation=dilation, groups=groups)
    return y.transpose(1, 2)


def causal_conv1d(p, x, dilation=1):
    """Left-padded conv, matching reference decoder.py:71-97 CausalConv1d."""
    return conv1d(p, x, padding=((p["w"].shape[-1] - 1) * dilation, 0), dilation=dilation)


def conv2d(p, x, stride=(1, 1), padding=(0, 0)):
    """2-D conv on (B, H, W, C) with weight (Cout, Cin, KH, KW); ``padding``
    is an int or a pair, each entry an int or an explicit (lo, hi) pair."""
    w = p["w"]
    if isinstance(padding, int):
        padding = (padding, padding)
    (top, bottom), (left, right) = (_pad_pair(pp) for pp in padding)
    xc = F.pad(x.to(w.dtype).permute(0, 3, 1, 2), (left, right, top, bottom))
    return F.conv2d(xc, w, p.get("b"), stride=stride).permute(0, 2, 3, 1)


def conv_transpose1d(p, x, stride, padding=0):
    """ConvTranspose1d on (B, T, C); weight (Cin, Cout, W).
    out_len = (T-1)*stride + W - 2*padding."""
    w = p["w"]
    y = F.conv_transpose1d(
        x.to(w.dtype).transpose(1, 2), w, p.get("b"), stride=stride, padding=padding
    )
    return y.transpose(1, 2)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------


# least-squares fit of sin^2(pi f) / f^2 as a degree-4 polynomial in f^2 on
# f in [-1/2, 1/2] (the program's HiFT default)
_SNAKE_POLY = (
    9.869599831501965,
    -32.468686165908665,
    42.69306392165783,
    -29.692025709511967,
    11.062041862215489,
)
_INV_PI = 0.3183098861837907


def snake_fast(p, x):
    """Snake, x + sin^2(a x) / a with per-channel alpha, via mod-1 range
    reduction and a polynomial for sin^2:
    sin^2(pi t) == sin^2(pi f) with f = t - round(t) in [-1/2, 1/2]."""
    alpha = p["alpha"]
    c0, c1, c2, c3, c4 = _SNAKE_POLY
    t = x * (alpha * _INV_PI)
    f = t - torch.round(t)
    z = f * f
    sin2 = z * (c0 + z * (c1 + z * (c2 + z * (c3 + z * c4))))
    return x + (1.0 / (alpha + 1e-9)) * sin2


def mish(x):
    return x * torch.tanh(F.softplus(x))


def leaky_relu(x, negative_slope=0.1):
    return torch.where(x >= 0, x, x * negative_slope)


# ---------------------------------------------------------------------------
# dense attention and head reshapes (the T3 perceiver and prefill; the
# kernels of the main path live in ops/)
# ---------------------------------------------------------------------------


def sdpa(q, k, v, mask=None, scale=None):
    """Scaled dot-product attention, q,k,v (B, H, T, D) with an optional
    mask broadcast to (B, H, T, S): an additive fp32 bias, or a bool mask
    (True = attend) that sets the other logits to the fp32 minimum. fp32
    logits and softmax with ``scale`` (None: 1/sqrt(D)), probs cast to v's
    dtype before the value product."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None and mask.dtype == torch.bool:
        logits = logits.masked_fill(~mask, torch.finfo(torch.float32).min)
    elif mask is not None:
        logits = logits + mask
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def split_heads(x, n_heads):
    b, t, c = x.shape
    return x.reshape(b, t, n_heads, c // n_heads).transpose(1, 2)


def merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


# ---------------------------------------------------------------------------
# LSTM (the voice encoder's), as an explicit loop over time
# ---------------------------------------------------------------------------


def lstm(p_layers, x):
    """Multi-layer LSTM over (B, T, C). Each layer: w_ih (Cin, 4H), w_hh
    (H, 4H), b (4H,) = b_ih + b_hh folded; gate order [i, f, g, o] as in
    torch. Returns (output (B, T, H), [last hidden (B, H) of each layer])."""
    hs = []
    for p in p_layers:
        hdim = p["w_hh"].shape[0]
        xproj = torch.matmul(x, p["w_ih"]) + p["b"]  # the whole sequence at once
        h = x.new_zeros((x.shape[0], hdim))
        c = x.new_zeros((x.shape[0], hdim))
        ys = []
        for t in range(x.shape[1]):
            i, f, g, o = (xproj[:, t] + torch.matmul(h, p["w_hh"])).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys.append(h)
        x = torch.stack(ys, dim=1)
        hs.append(h)
    return x, hs
