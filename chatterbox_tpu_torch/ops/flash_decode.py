"""T3 decode attention (K1) and KV-cache append (K2), each a hand-written
CUDA kernel (``csrc/flash_decode.cu``) beside its plain PyTorch version.

K1 ``flash_decode_layer_attention`` replaces the Pallas kernel
``chatterbox_tpu/ops/flash_decode.py::flash_decode_layer_attention``
(variant a: no stats, no int8 cache, no SD tail). One new token per row
attends to layer ``layer_idx`` of the whole (L, 2, B, H, S, D) cache without
a copy. Slot i of row b is valid iff ``i < row_prefix[b]`` or
``gap_end <= i < cur_len`` (the T3 cache: [cond; right-padded text; BOS;
decoded]); the current token's k/v seed the softmax as a self-logit; slots at
or past ``cur_len`` are never read.
What bounds it on the card: bytes (the live K/V rows of the layer). Design:
one block per (row, head), an fp32 online softmax over 128-slot tiles; see
the source note in csrc/flash_decode.cu. Split-S is queued for a later PR.
The main path runs it in bf16; the fp32 kernel serves the exact-token check
of a small fp32 T3 on the card against the CPU (``chip_smoke.py``).

K2 ``kv_cache_append`` replaces ``flash_cache_merge_ds``: the (L, 2, B, H, D)
new K/V of one decode step, written in place at slot ``pos`` of every layer
with one launch. Bound by bytes; one thread per 16-byte vector.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

import ctypes

import torch

from . import _build
from ._build import require

_SIG = {
    "cbx_flash_decode": [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_float, ctypes.c_void_p,
    ],
    "cbx_kv_append": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    return _build.load("flash_decode", _SIG)


# ---------------------------------------------------------------------------
# K1
# ---------------------------------------------------------------------------


def flash_decode_layer_attention_plain(cache, layer_idx, cur_len, row_prefix, gap_end,
                                      q, k_new, v_new):
    """softmax([valid cache logits; self logit]) @ [cache V; v_new] in fp32,
    returned in q's dtype. cache (L, 2, B, H, S, D); q/k_new/v_new (B, H, D);
    row_prefix (B,) int; layer_idx, cur_len, gap_end ints."""
    d = q.shape[-1]
    scale = d ** -0.5
    k = cache[layer_idx, 0, :, :, :cur_len].float()  # (B, H, cur, D)
    v = cache[layer_idx, 1, :, :, :cur_len].float()
    qf = q.float()
    logits = torch.einsum("bhd,bhsd->bhs", qf, k) * scale
    idx = torch.arange(cur_len, device=cache.device)
    valid = (idx[None] < row_prefix.to(cache.device)[:, None].long()) | (idx[None] >= gap_end)
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    self_logit = (qf * k_new.float()).sum(-1, keepdim=True) * scale
    probs = torch.softmax(torch.cat([logits, self_logit], dim=-1), dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs[..., :cur_len], v)
    out = out + probs[..., cur_len:] * v_new.float()
    return out.to(q.dtype)


def flash_decode_layer_attention(cache, layer_idx: int, cur_len: int, row_prefix,
                                gap_end: int, q, k_new, v_new):
    """Decode attention for one layer against the full multi-layer cache;
    returns (B, H, D) in q's dtype. See the module docstring."""
    if cache.device.type == "cpu":
        return flash_decode_layer_attention_plain(
            cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new
        )
    require(cache.device.type == "cuda", f"unsupported device {cache.device}")
    n_layers, two, b, h, s, d = cache.shape
    require(two == 2 and cache.is_contiguous(), "cache must be contiguous (L, 2, B, H, S, D)")
    require(cache.dtype in _DTYPE_CODE, f"cache dtype {cache.dtype} is not float32/bfloat16")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        require(t.shape == (b, h, d) and t.dtype == cache.dtype and t.is_contiguous()
                and t.device == cache.device,
                f"{name} must be a contiguous {(b, h, d)} {cache.dtype} tensor on {cache.device}")
    require(row_prefix.shape == (b,) and row_prefix.dtype == torch.int32
            and row_prefix.is_contiguous() and row_prefix.device == cache.device,
            "row_prefix must be a contiguous (B,) int32 tensor on the cache's device")
    require(128 % d == 0 and (d * cache.element_size()) % 16 == 0,
            f"head dim {d} must divide 128 and span whole 16-byte vectors")
    require(0 <= layer_idx < n_layers and 0 <= cur_len <= s, "layer_idx / cur_len out of range")
    require(cache.data_ptr() % 16 == 0, "cache must be 16-byte aligned")
    out = torch.empty_like(q)
    status = _lib().cbx_flash_decode(
        cache.data_ptr(), _DTYPE_CODE[cache.dtype], int(layer_idx), b, h, s, d,
        row_prefix.data_ptr(), int(gap_end), int(cur_len), q.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), d ** -0.5,
        _build.stream_ptr(cache),
    )
    _build.check(status, "flash_decode_layer_attention")
    flash_decode_layer_attention.launches += 1
    return out


flash_decode_layer_attention.launches = 0


# ---------------------------------------------------------------------------
# K2
# ---------------------------------------------------------------------------


def kv_cache_append_plain(cache, new_kv, pos: int):
    """cache[:, :, :, :, pos] = new_kv, in place. cache (L, 2, B, H, S, D),
    new_kv (L, 2, B, H, D)."""
    cache[:, :, :, :, pos] = new_kv.to(cache.dtype)
    return cache


def kv_cache_append(cache, new_kv, pos: int):
    """Write one decode step's K/V of every layer into slot ``pos`` of the
    cache, in place; returns the cache."""
    if cache.device.type == "cpu":
        return kv_cache_append_plain(cache, new_kv, pos)
    require(cache.device.type == "cuda", f"unsupported device {cache.device}")
    n_layers, two, b, h, s, d = cache.shape
    require(cache.is_contiguous(), "cache must be contiguous")
    require(new_kv.shape == (n_layers, two, b, h, d) and new_kv.dtype == cache.dtype
            and new_kv.is_contiguous() and new_kv.device == cache.device,
            "new_kv must be a contiguous (L, 2, B, H, D) tensor of the cache's dtype")
    row_bytes = d * cache.element_size()
    require(row_bytes % 16 == 0 and cache.data_ptr() % 16 == 0 and new_kv.data_ptr() % 16 == 0,
            "rows must be whole, aligned 16-byte vectors")
    require(0 <= pos < s, f"pos {pos} outside the cache length {s}")
    status = _lib().cbx_kv_append(
        cache.data_ptr(), new_kv.data_ptr(), n_layers * two * b * h, s, row_bytes,
        int(pos), _build.stream_ptr(cache),
    )
    _build.check(status, "kv_cache_append")
    kv_cache_append.launches += 1
    return cache


kv_cache_append.launches = 0
