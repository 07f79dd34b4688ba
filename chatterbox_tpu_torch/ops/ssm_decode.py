"""The Mamba-2 decode update of T3's Granite backbone: a hand-written CUDA
kernel (``csrc/ssm_decode.cu``) beside its plain PyTorch version.

One launch a Mamba layer a decode step takes the layer's in_proj output
row (z, xBC, dt) of each row and, in fp32 inside: shifts the row's conv
state (the raw xBC of its last 3 tokens) by the new token, convolves xBC
(width 4, with bias) and applies SiLU, splits x, B and C, takes ``dt =
softplus(dt + dt_bias)``, updates the recurrent state in place, ``s = exp(dt
A) s + (dt x) (x) B``, and returns ``y = s C + D x`` (R, H * P) in fp32. The
gate, the norm and out_proj stay with the caller
(``models/t3/granite_hybrid.py``).

The wrapper takes the whole state tensors, conv (Lm, R, conv_dim, 3) and
ssm (Lm, R, H, P, N) fp32, and the layer's index, as K1 takes the whole KV
cache. The kernel is bound by bytes (each state value read and written
once); it takes P = 64, N = 128, one group and a conv of width 4 (Granite
4.0-H's), in bf16 or fp32. It reads no position, so a CUDA graph replays
it. Its per-row counters (``_tickets``) belong to the ssm tensor: made at
its first launch, outside any capture, and zero between launches.

A wrapper takes the plain version for CPU tensors and launches the kernel
or raises for CUDA tensors; under grad mode with an operand that requires
grad it raises (``_build.refuse_autograd``).
"""

import ctypes

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from . import _build
from ._build import require

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIG = {"cbx_ssm_update": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P]}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM, _STATE, _CONV = 64, 128, 4  # the kernel's P, N and conv width
_tickets = WeakTensorKeyDictionary()  # ssm state -> (R,) int32 counters


def _lib():
    return _build.load("ssm_decode", _SIG)


def ssm_decode_update_plain(conv_state, ssm_state, layer: int, zxbcdt, conv_w, conv_b, dt_bias,
                            A, D):
    """The update in fp32 with PyTorch operations; state tensors updated in
    place, y (R, H * P) fp32 returned. conv_w (conv_dim, K), conv_b
    (conv_dim,), dt_bias, A (= -exp(A_log)) and D (H,)."""
    _, r, h, p, n = ssm_state.shape
    xbc, dt = zxbcdt[:, h * p:].split([h * p + 2 * n, h], dim=-1)
    win = torch.cat([conv_state[layer].float(), xbc.float()[..., None]], dim=-1)
    xc = F.silu((win * conv_w.float()).sum(dim=-1) + conv_b.float())
    conv_state[layer].copy_(torch.cat([conv_state[layer][..., 1:], xbc[..., None]], dim=-1))
    x, B, C = xc.split([h * p, n, n], dim=-1)
    x = x.view(r, h, p)
    dt = F.softplus(dt.float() + dt_bias.float())
    dA = torch.exp(dt * A.float())
    dtx = dt[..., None] * x
    s = ssm_state[layer]
    s.copy_(dA[..., None, None] * s + dtx[..., None] * B[:, None, None, :])
    y = torch.einsum("rhpn,rn->rhp", s, C) + D.float()[:, None] * x
    return y.reshape(r, h * p)


def ssm_decode_update(conv_state, ssm_state, layer: int, zxbcdt, conv_w, conv_b, dt_bias, A, D):
    """One Mamba layer's decode update (see the module docstring); returns
    y (R, H * P) fp32 and advances ``conv_state[layer]`` and
    ``ssm_state[layer]`` in place."""
    _build.refuse_autograd("ssm_decode_update", zxbcdt, conv_w, conv_b, dt_bias, A, D)
    n_layers, r, h, p, n = ssm_state.shape
    conv_dim = h * p + 2 * n
    require(conv_state.shape[:3] == (n_layers, r, conv_dim)
            and zxbcdt.shape == (r, h * p + conv_dim + h) and 0 <= layer < n_layers,
            f"conv_state must be (Lm, {r}, {conv_dim}, K - 1) and zxbcdt ({r}, "
            f"{h * p + conv_dim + h}) for an ssm state {tuple(ssm_state.shape)}, layer < Lm")
    if ssm_state.device.type == "cpu":
        return ssm_decode_update_plain(conv_state, ssm_state, layer, zxbcdt, conv_w, conv_b,
                                       dt_bias, A, D)
    require(ssm_state.device.type == "cuda", f"unsupported device {ssm_state.device}")
    require((p, n, conv_state.shape[3] + 1) == (_HEAD_DIM, _STATE, _CONV),
            f"the kernel takes head dim {_HEAD_DIM}, state {_STATE} and conv width {_CONV}")
    require(ssm_state.dtype == torch.float32 and ssm_state.is_contiguous()
            and ssm_state.data_ptr() % 16 == 0, "ssm_state must be contiguous, aligned fp32")
    require(zxbcdt.dtype in _DTYPE_CODE and conv_state.dtype == zxbcdt.dtype
            and conv_state.is_contiguous() and zxbcdt.is_contiguous(),
            "conv_state and zxbcdt must be contiguous, of one dtype, float32 or bfloat16")
    for name, t, shape in (("conv_w", conv_w, (conv_dim, _CONV)), ("conv_b", conv_b, (conv_dim,)),
                           ("dt_bias", dt_bias, (h,)), ("A", A, (h,)), ("D", D, (h,))):
        require(t.shape == shape and t.dtype == torch.float32 and t.is_contiguous()
                and t.device == ssm_state.device, f"{name} must be a contiguous fp32 {shape}")
    require(all(t.device == ssm_state.device for t in (conv_state, zxbcdt)),
            "every operand on the state's device")
    y = torch.empty((r, h * p), dtype=torch.float32, device=ssm_state.device)
    status = _lib().cbx_ssm_update(
        conv_state[layer].data_ptr(), ssm_state[layer].data_ptr(), zxbcdt.data_ptr(),
        _DTYPE_CODE[zxbcdt.dtype], conv_w.data_ptr(), conv_b.data_ptr(), dt_bias.data_ptr(),
        A.data_ptr(), D.data_ptr(), y.data_ptr(), r, h, zxbcdt.shape[1],
        _workspace(ssm_state, r).data_ptr(), _build.stream_ptr(ssm_state))
    _build.check(status, "ssm_decode_update")
    ssm_decode_update.launches += 1
    return y


def _workspace(ssm_state, rows: int):
    """The kernel's per-row counters for ``ssm_state``: zero, made at its
    first launch (never while a graph is captured) and freed with it; each
    stream that launches on it is recorded with the allocator."""
    have = _tickets.get(ssm_state)
    if have is None:
        require(not torch.cuda.is_current_stream_capturing(),
                "the update's counters are made at the state's first launch: launch once "
                "before capturing")
        have = _tickets[ssm_state] = (torch.zeros(rows, dtype=torch.int32,
                                                  device=ssm_state.device), set())
    stream = torch.cuda.current_stream(ssm_state.device)
    if stream.cuda_stream not in have[1] and not torch.cuda.is_current_stream_capturing():
        have[0].record_stream(stream)
        have[1].add(stream.cuda_stream)
    return have[0]


ssm_decode_update.launches = 0
