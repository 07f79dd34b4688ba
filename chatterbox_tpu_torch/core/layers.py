"""Functional NN building blocks over parameter dicts of torch tensors.

Port of ``chatterbox_tpu/core/layers.py``. Public layouts stay the JAX
package's: sequences are (B, T, C). Weights are in PyTorch's layout, turned
once by ``weights.py``:
  - linear: (Cout, Cin)
  - conv1d: (Cout, Cin, W)
  - conv_transpose1d: (Cin, Cout, W)
"""

import torch
import torch.nn.functional as F


def linear(p, x):
    return F.linear(x, p["w"], p.get("b"))


def embedding(p, ids):
    return F.embedding(ids, p["w"])


def layer_norm(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def rms_norm(p, x, eps=1e-5):
    # HF LlamaRMSNorm: statistics in fp32, scale after the cast back
    dt = x.dtype
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = (x32 * torch.rsqrt(var + eps)).to(dt)
    return y * p["scale"]


def group_norm(p, x, num_groups, eps=1e-5):
    """GroupNorm over (B, T, C) with channel groups (torch GroupNorm parity)."""
    y = F.group_norm(x.transpose(1, 2), num_groups, p["scale"], p["bias"], eps)
    return y.transpose(1, 2)


def _pad_pair(padding):
    return (padding, padding) if isinstance(padding, int) else tuple(padding)


def conv1d(p, x, stride=1, padding=0, dilation=1):
    """1-D conv on (B, T, C) with weight (Cout, Cin, W). ``padding``
    is a symmetric int or an explicit (lo, hi) pair."""
    w = p["w"]
    xc = x.to(w.dtype).transpose(1, 2)  # weights define compute precision
    lo, hi = _pad_pair(padding)
    if lo or hi:
        xc = F.pad(xc, (lo, hi))
    y = F.conv1d(xc, w, p.get("b"), stride=stride, dilation=dilation)
    return y.transpose(1, 2)


def causal_conv1d(p, x):
    """Left-padded conv, matching reference decoder.py:71-97 CausalConv1d."""
    return conv1d(p, x, padding=(p["w"].shape[-1] - 1, 0))


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


def snake(p, x):
    """Snake activation x + sin^2(a x)/a with per-channel alpha; x (B,T,C)."""
    alpha = p["alpha"]
    return x + (1.0 / (alpha + 1e-9)) * torch.sin(x * alpha) ** 2


# least-squares fit of sin^2(pi f) / f^2 as a degree-4 polynomial in f^2 on
# f in [-1/2, 1/2] (the JAX package's HiFT default, layers.snake_fast)
_SNAKE_POLY = (
    9.869599831501965,
    -32.468686165908665,
    42.69306392165783,
    -29.692025709511967,
    11.062041862215489,
)
_INV_PI = 0.3183098861837907


def snake_fast(p, x):
    """snake() via mod-1 range reduction and a polynomial for sin^2:
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


def sdpa(q, k, v, bias=None):
    """Scaled dot-product attention, q,k,v (B, H, T, D) with an optional
    additive fp32 bias broadcast to (B, H, T, S): fp32 logits and softmax
    with scale 1/sqrt(D), probs cast to v's dtype before the value product."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if bias is not None:
        logits = logits + bias
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def split_heads(x, n_heads):
    b, t, c = x.shape
    return x.reshape(b, t, n_heads, c // n_heads).transpose(1, 2)


def merge_heads(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)
