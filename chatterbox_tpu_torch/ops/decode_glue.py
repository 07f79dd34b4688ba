"""The glue of T3's Llama decode step: three hand-written CUDA kernels
(``csrc/decode_glue.cu``), each beside its plain PyTorch version.

- ``add_rms_norm(x, r, scale, eps)``: the residual add ``h = x + r`` and
  HF's RMSNorm of ``h`` (``core.layers.rms_norm``); r None: h = x. Returns
  (h, y). The kernel writes h over r (the projection's output, which
  nothing reads after), so the caller's x is never written.
- ``rope_split_kv(q, k, v, cos, sin, new_kv, i)``: rope on the rows of the
  q and k projections (``apply_rope``), q returned as a
  contiguous (B, Hq, D), k and v written into ``new_kv[i, 0]`` and
  ``new_kv[i, 1]`` of the step's (L, 2, B, Hkv, D) K/V. q, k and v are (B,
  1, H * D): the fused ``qkv`` product's views or three products; the head
  counts come from their widths and new_kv's.
- ``silu_mul(gate_up)``: (B, 1, 2F) -> ``silu(g) * u`` (B, 1, F), the
  gated MLP's activation (``models/t3/llama._mlp``).

Each ``_plain`` version is the PyTorch expression the decode step ran
before, and is the step's path on the CPU. The kernels keep that
expression's rounding at every operation, in bf16 and in fp32, so they
equal it bit for bit, except the norm's mean: an fp32 sum in another
order, within ``2^-7 |want| + 1e-5`` of it in bf16 and ``2^-18 |want| +
1e-7`` in fp32. They take head dim 64, and are bound by launches (see the
source note). ``apply_rope`` is the rope of the prefill, training and the
probes too.

A wrapper takes the plain version for CPU tensors and launches the kernel
or raises for CUDA tensors; under grad mode with an operand that requires
grad it raises (``_build.refuse_autograd``). Each counts its launches in
``fn.launches``.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..core.layers import rms_norm, split_heads
from . import _build
from ._build import require
from .flash_decode import _DTYPE_CODE

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {
    "cbx_add_rms_norm": [_P, _P, _P, _P, _I, _I, _I, ctypes.c_float, _P],
    "cbx_rope_split_kv": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "cbx_silu_mul": [_P, _P, _I, _I, _I, _P],
}
HEAD_DIM = 64  # the rope kernel's head dim (T3's)
_NORM_MAX_C = 4096  # the norm kernel holds a row in registers: 128 threads x 4 vectors of 8


def _lib():
    return _build.load("decode_glue", _SIG)


def _aligned(*tensors):
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def add_rms_norm_plain(x, r, scale, eps: float):
    h = x if r is None else x + r
    return h, rms_norm({"scale": scale}, h, eps)


def add_rms_norm(x, r, scale, eps: float):
    """(h, y): h = x + r (x when r is None), y = RMSNorm(h) * scale; on the
    card h is r's storage, overwritten."""
    _build.refuse_autograd("add_rms_norm", x, r, scale)
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, r, scale, eps)
    require(x.device.type == "cuda", f"unsupported device {x.device}")
    c = x.shape[-1]
    ts = (x, scale) if r is None else (x, r, scale)
    require(x.dtype in _DTYPE_CODE and all(t.dtype == x.dtype and t.is_contiguous()
                                           and t.device == x.device for t in ts)
            and _aligned(*ts),
            "add_rms_norm takes contiguous, 16-byte aligned tensors of one dtype, float32 or "
            "bfloat16, on one device")
    require((r is None or r.shape == x.shape) and scale.shape == (c,)
            and c % 8 == 0 and c <= _NORM_MAX_C,
            f"add_rms_norm takes r of x's shape {tuple(x.shape)} and a scale ({c},), the width "
            f"a multiple of 8 up to {_NORM_MAX_C}")
    y = torch.empty_like(x)
    status = _lib().cbx_add_rms_norm(
        x.data_ptr(), None if r is None else r.data_ptr(), scale.data_ptr(), y.data_ptr(),
        _DTYPE_CODE[x.dtype], x.numel() // c, c, eps, _build.stream_ptr(x))
    _build.check(status, "add_rms_norm")
    add_rms_norm.launches += 1
    return (x if r is None else r), y


def _rotate_half(x):
    d = x.shape[-1] // 2
    return torch.cat([-x[..., d:], x[..., :d]], dim=-1)


def apply_rope(q, k, cos, sin):
    """q,k: (B, H, T, D); cos,sin: (B, T, D). Keeps q/k dtype."""
    cos = cos[:, None].to(q.dtype)
    sin = sin[:, None].to(q.dtype)
    return q * cos + _rotate_half(q) * sin, k * cos + _rotate_half(k) * sin


def rope_split_kv_plain(q, k, v, cos, sin, new_kv, i: int):
    hkv, d = new_kv.shape[3], new_kv.shape[4]
    q, k, v = split_heads(q, q.shape[-1] // d), split_heads(k, hkv), split_heads(v, hkv)
    q, k = apply_rope(q, k, cos, sin)
    new_kv[i, 0] = k[:, :, 0]
    new_kv[i, 1] = v[:, :, 0]
    return q[:, :, 0].contiguous()


def rope_split_kv(q, k, v, cos, sin, new_kv, i: int):
    """Rope'd q (B, Hq, D), contiguous; rope'd k and v written into
    ``new_kv[i, 0]`` and ``new_kv[i, 1]``. q, k, v (B, 1, H * D); cos, sin
    (B, 1, D) fp32 (``rope_cos_sin``)."""
    _build.refuse_autograd("rope_split_kv", q, k, v)
    if q.device.type == "cpu":
        return rope_split_kv_plain(q, k, v, cos, sin, new_kv, i)
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    n_layers, two, b, hkv, d = new_kv.shape
    hq = q.shape[-1] // d
    require(d == HEAD_DIM and two == 2 and 0 <= i < n_layers,
            f"rope_split_kv takes head dim {HEAD_DIM} and new_kv (L, 2, B, Hkv, D), i < L")
    require(q.shape == (b, 1, hq * d) and k.shape == v.shape == (b, 1, hkv * d),
            f"q must be ({b}, 1, H * {d}) and k, v ({b}, 1, {hkv * d}) for new_kv "
            f"{tuple(new_kv.shape)}")
    require(cos.shape == sin.shape == (b, 1, d) and cos.dtype == sin.dtype == torch.float32
            and cos.is_contiguous() and sin.is_contiguous(),
            f"cos and sin must be contiguous fp32 ({b}, 1, {d})")
    qkv = (q, k, v)
    require(q.dtype in _DTYPE_CODE and all(t.dtype == q.dtype and t.stride(-1) == 1
                                           and t.stride(0) % 8 == 0 for t in qkv)
            and new_kv.dtype == q.dtype and new_kv.is_contiguous() and _aligned(*qkv, new_kv),
            "q, k, v must be rows of unit stride, their row strides multiples of 8, and new_kv "
            "contiguous, all of one dtype, float32 or bfloat16, and 16-byte aligned")
    require(all(t.device == q.device for t in (k, v, cos, sin, new_kv)),
            "every operand on q's device")
    q1 = torch.empty((b, hq, d), dtype=q.dtype, device=q.device)
    status = _lib().cbx_rope_split_kv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _DTYPE_CODE[q.dtype], q.stride(0),
        k.stride(0), v.stride(0),
        cos.data_ptr(), sin.data_ptr(), q1.data_ptr(), new_kv[i, 0].data_ptr(),
        new_kv[i, 1].data_ptr(), b, hq, hkv, _build.stream_ptr(q))
    _build.check(status, "rope_split_kv")
    rope_split_kv.launches += 1
    return q1


def silu_mul_plain(gate_up):
    g, u = gate_up.chunk(2, dim=-1)
    return F.silu(g) * u


def silu_mul(gate_up):
    """(..., 2F) gate|up -> silu(gate) * up (..., F)."""
    _build.refuse_autograd("silu_mul", gate_up)
    if gate_up.device.type == "cpu":
        return silu_mul_plain(gate_up)
    require(gate_up.device.type == "cuda", f"unsupported device {gate_up.device}")
    f = gate_up.shape[-1] // 2
    require(gate_up.dtype in _DTYPE_CODE and gate_up.is_contiguous() and _aligned(gate_up)
            and f % 8 == 0 and gate_up.shape[-1] == 2 * f,
            "silu_mul takes a contiguous, 16-byte aligned float32 or bfloat16 (..., 2F), F a "
            "multiple of 8")
    out = torch.empty(gate_up.shape[:-1] + (f,), dtype=gate_up.dtype, device=gate_up.device)
    status = _lib().cbx_silu_mul(gate_up.data_ptr(), out.data_ptr(), _DTYPE_CODE[gate_up.dtype],
                                 gate_up.numel() // (2 * f), f, _build.stream_ptr(gate_up))
    _build.check(status, "silu_mul")
    silu_mul.launches += 1
    return out


add_rms_norm.launches = 0
rope_split_kv.launches = 0
silu_mul.launches = 0
