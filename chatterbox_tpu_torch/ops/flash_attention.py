"""Flow attention kernels K3, K4 and K5, each beside its plain PyTorch
version. One hand-written CUDA source for Hopper (``sm_90a``,
``csrc/flash_attention_sm90.cu``) computes all three with one
warp-specialised design: a producer warpgroup feeds shared memory with TMA
(128-byte swizzle, mbarriers); two consumer warpgroups of 64 query rows
compute S = Q.K^T with ``wgmma`` from shared memory, the online softmax on
the fp32 accumulator in registers (scale and bias folded into one FMA in
the log2 domain), and O += P.V with ``wgmma``, P in registers as its A
operand.

- K3 and K5 run one kernel body: Q once, then a ring of three K/V/bias
  stages; each tile's softmax runs while the previous tile's P.V is on the
  tensor cores. The two entry points differ only in their TMA descriptors
  and output strides, so they agree bit for bit on the same q, k, v.
- K4 keeps Q at depth 64 + C resident (q_u and the 64-wide q-hat chunks)
  and streams each key tile's k, s-hat chunks and v through a ring of
  single 16 KB boxes; S accumulates over the depth chunks in one fp32
  fragment.

K3 ``flash_self_attention_packed`` replaces the Pallas kernel
``chatterbox_tpu/ops/flash_attention.py::flash_self_attention_packed``: UNet
self-attention straight from the packed to_qkv output (B, T, 3*H*D), exact
non-causal softmax with scale 1/sqrt(D) and an additive (B, T) key bias;
returns (B, T, H*D).

K4 ``flash_relpos_attention`` replaces
``chatterbox_tpu/ops/flash_attention.py::flash_relpos_attention``: the
conformer's ESPnet rel-pos attention, scores = (q_u.k^T + qhat.shat^T) * scale
+ bias, with qhat (B, T, H*C) and the shared sinusoid table shat (T, C).

K5 ``flash_self_attention`` replaces
``chatterbox_tpu/ops/flash_attention.py::flash_self_attention``: K3's
function on separate q, k, v in (B, H, T, D), returning (B, H, T, D); the
UNet takes it for unfused to_q/to_k/to_v weights and for fused widths that
are not a multiple of 128.

All three round the unnormalised probabilities of the online softmax to
bf16 for the value product and divide by their fp32 sum afterwards. What
bounds them on the card: operations (T*T*D work per (row, head) on T*D
data); see the source note. The kernels take bf16 operands, head dim 64
(the flow's working dtype and width) and T a multiple of 128 (the query
and key tiles; the UNet and the conformer pad to it); K4 a q-hat depth C a
multiple of 64, at most 512. A wrapper takes its plain version only for
CPU tensors; for CUDA tensors it launches the kernel or raises. No kernel
has a backward: on either device a wrapper raises when grad mode is on and
an operand requires grad (``_build.refuse_autograd``); the plain versions
stay differentiable functions.
"""

import ctypes

import torch

from ..core.layers import merge_heads, split_heads
from . import _build
from ._build import require

_HEAD_DIM = 64
_T_MULT = 128  # 128-row query and key tiles
_C_MAX_RELPOS = 512  # K4: q-hat depth chunks of 64 held in shared memory


_SIG = {
    "cbx_flash_attention_packed": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
    "cbx_flash_attention_heads": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
    "cbx_flash_relpos": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
    ],
}


def _lib():
    return _build.load("flash_attention_sm90", _SIG)


def _check_operand(name, t, shape, dtype, device):
    require(
        t.shape == shape and t.dtype == dtype and t.is_contiguous() and t.device == device
        and t.data_ptr() % 16 == 0,
        f"{name} must be a contiguous, 16-byte aligned {shape} {dtype} tensor on {device}",
    )


# ---------------------------------------------------------------------------
# K3
# ---------------------------------------------------------------------------


def flash_self_attention_packed_plain(qkv, key_bias, n_heads: int):
    """fp32 softmax attention over the packed bands; probs are cast to the
    input dtype before the value product, as the TPU kernel does."""
    b, t, chd = qkv.shape
    hd = chd // 3
    d = hd // n_heads
    x = qkv.float()
    q, k, v = (split_heads(x[..., i * hd : (i + 1) * hd], n_heads) for i in range(3))
    logits = torch.matmul(q, k.transpose(-1, -2)) * d ** -0.5
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(qkv.dtype).float()
    return merge_heads(torch.matmul(probs, v)).to(qkv.dtype)


def flash_self_attention_packed(qkv, key_bias, n_heads: int):
    """qkv (B, T, 3*H*D), key_bias (B, T) additive f32 or None ->
    (B, T, H*D) in qkv's dtype."""
    _build.refuse_autograd("flash_self_attention_packed", qkv, key_bias)
    if qkv.device.type == "cpu":
        return flash_self_attention_packed_plain(qkv, key_bias, n_heads)
    require(qkv.device.type == "cuda", f"unsupported device {qkv.device}")
    b, t, chd = qkv.shape
    hd = chd // 3
    require(chd == 3 * n_heads * _HEAD_DIM, f"kernel takes head dim {_HEAD_DIM}")
    require(t % _T_MULT == 0, f"T={t} must be a multiple of {_T_MULT}")
    _check_operand("qkv", qkv, (b, t, chd), torch.bfloat16, qkv.device)
    if key_bias is None:
        key_bias = torch.zeros((b, t), dtype=torch.float32, device=qkv.device)
    _check_operand("key_bias", key_bias, (b, t), torch.float32, qkv.device)
    out = torch.empty((b, t, hd), dtype=qkv.dtype, device=qkv.device)
    status = _lib().cbx_flash_attention_packed(
        qkv.data_ptr(), key_bias.data_ptr(), out.data_ptr(), b, t, n_heads,
        _HEAD_DIM ** -0.5, _build.stream_ptr(qkv),
    )
    _build.check(status, "flash_self_attention_packed")
    flash_self_attention_packed.launches += 1
    return out


flash_self_attention_packed.launches = 0


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------


def flash_self_attention_plain(q, k, v, key_bias=None):
    """The Pallas kernel's arithmetic: fp32 logits q.k^T/sqrt(D) + bias,
    p = exp(logits - max) cast to v's dtype for the value product, divided
    by the fp32 sum of p afterwards."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if key_bias is not None:
        logits = logits + key_bias.float()[:, None, None, :]
    p = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    out = torch.matmul(p.to(v.dtype).float(), v.float()) / p.sum(dim=-1, keepdim=True)
    return out.to(q.dtype)


def flash_self_attention(q, k, v, key_bias=None):
    """q, k, v (B, H, T, D); key_bias (B, T) additive f32 or None ->
    (B, H, T, D) in q's dtype. Exact, non-causal."""
    _build.refuse_autograd("flash_self_attention", q, k, v, key_bias)
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, key_bias)
    require(q.device.type == "cuda", f"unsupported device {q.device}")
    b, h, t, d = q.shape
    require(d == _HEAD_DIM, f"kernel takes head dim {_HEAD_DIM}")
    require(t % _T_MULT == 0, f"T={t} must be a multiple of {_T_MULT}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, x, (b, h, t, d), torch.bfloat16, q.device)
    if key_bias is None:
        key_bias = torch.zeros((b, t), dtype=torch.float32, device=q.device)
    _check_operand("key_bias", key_bias, (b, t), torch.float32, q.device)
    out = torch.empty_like(q)
    status = _lib().cbx_flash_attention_heads(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_bias.data_ptr(), out.data_ptr(), b, t, h,
        _HEAD_DIM ** -0.5, _build.stream_ptr(q),
    )
    _build.check(status, "flash_self_attention")
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0


# ---------------------------------------------------------------------------
# K4
# ---------------------------------------------------------------------------


def flash_relpos_attention_plain(q_u, q_hat, k, s_hat, v, key_bias, n_heads: int,
                                 scale: float):
    """fp32 rel-pos attention: (q_u.k^T + qhat_h.shat^T) * scale + bias,
    exact softmax, probs cast to the input dtype before the value product."""
    b, t, hd = q_u.shape
    c = q_hat.shape[-1] // n_heads
    qu, kk, vv = (split_heads(x.float(), n_heads) for x in (q_u, k, v))
    qh = split_heads(q_hat.float(), n_heads)  # (B, H, T, C)
    sh = s_hat.to(q_hat.dtype).float().reshape(t, c)
    logits = torch.matmul(qu, kk.transpose(-1, -2)) + torch.matmul(qh, sh.t())
    logits = logits * scale + key_bias.float()[:, None, None, :]
    probs = torch.softmax(logits, dim=-1).to(q_u.dtype).float()
    return merge_heads(torch.matmul(probs, vv)).to(q_u.dtype)


def flash_relpos_attention(q_u, q_hat, k, s_hat, v, key_bias, n_heads: int,
                           scale: float):
    """q_u, k, v (B, T, H*D); q_hat (B, T, H*C); s_hat (1, T, C) or (T, C);
    key_bias (B, T) additive f32 -> (B, T, H*D) in q_u's dtype."""
    _build.refuse_autograd("flash_relpos_attention", q_u, q_hat, k, s_hat, v, key_bias)
    if q_u.device.type == "cpu":
        return flash_relpos_attention_plain(q_u, q_hat, k, s_hat, v, key_bias, n_heads, scale)
    require(q_u.device.type == "cuda", f"unsupported device {q_u.device}")
    b, t, hd = q_u.shape
    c = q_hat.shape[-1] // n_heads
    dev = q_u.device
    require(hd == n_heads * _HEAD_DIM, f"kernel takes head dim {_HEAD_DIM}")
    require(t % _T_MULT == 0 and c % 64 == 0 and 0 < c <= _C_MAX_RELPOS,
            f"T={t} must be a multiple of {_T_MULT} and C={c} a multiple of 64 up to "
            f"{_C_MAX_RELPOS}")
    for name, x in (("q_u", q_u), ("k", k), ("v", v)):
        _check_operand(name, x, (b, t, hd), torch.bfloat16, dev)
    _check_operand("q_hat", q_hat, (b, t, n_heads * c), torch.bfloat16, dev)
    shat = s_hat.reshape(t, c).to(torch.bfloat16).contiguous()
    _check_operand("s_hat", shat, (t, c), torch.bfloat16, dev)
    _check_operand("key_bias", key_bias, (b, t), torch.float32, dev)
    out = torch.empty((b, t, hd), dtype=q_u.dtype, device=dev)
    status = _lib().cbx_flash_relpos(
        q_u.data_ptr(), k.data_ptr(), v.data_ptr(), q_hat.data_ptr(), shat.data_ptr(),
        key_bias.data_ptr(), out.data_ptr(), b, t, n_heads, c, float(scale),
        _build.stream_ptr(q_u),
    )
    _build.check(status, "flash_relpos_attention")
    flash_relpos_attention.launches += 1
    return out


flash_relpos_attention.launches = 0
