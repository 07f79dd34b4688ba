"""T3 decode attention (K1) and the KV-cache writes (K2), each a hand-written
CUDA kernel (``csrc/flash_decode.cu``) beside its plain PyTorch version.

K1 replaces the Pallas kernel
``chatterbox_tpu/ops/flash_decode.py::flash_decode_layer_attention``
(``_kernel``, flash_decode.py:54-270). One new token per row attends to layer
``layer_idx`` of the whole (L, 2, B, H, S, D) cache without a copy. Slot i of
row b is valid iff ``i < row_prefix[b]`` or ``gap_end <= i < cur_len`` (the
T3 cache: [cond; right-padded text; BOS; decoded]); the current token's k/v
seed the softmax as a self-logit; slots at or past ``cur_len`` are never
read. Three variants, one wrapper each:

- a ``flash_decode_layer_attention``: a bf16 (or fp32) cache, no stats;
- b ``flash_decode_layer_attention_stats``: a, plus the final softmax stats
  (m, l) per (row, head) (Pallas ``return_stats``, flash_decode.py:260-270,
  525-553): m is the max of the scaled logits, self-logit included, and
  l = sum exp(logit - m), so ``exp(logit - m) / l`` is the exact probability
  of any valid slot. The alignment watchdog rebuilds its text-window
  probabilities from them; only the alignment layer launches it;
- c+d ``flash_decode_layer_attention_int8``: the int8 cache with per-token
  K/V scales for slots below ``merge_base`` (the K scale folds into the
  logit, the V scale into the probability, flash_decode.py:204-256), and the
  tail of the most recent ``cur_len - merge_base < TAIL_W`` tokens, read
  exact in the working dtype (flash_decode.py:109-140, 398-418).

What bounds K1 on the card: bytes (the live K/V rows of the layer; on the
int8 path one byte per value plus two fp32 scales per slot). Design:
split-S flash-decoding in one launch: one CTA per chunk of 64 live slots
of one (row, head), each writing an fp32 partial (m, l, acc) to a
workspace; the last chunk of each (row, head) to finish folds the partials
in chunk order with the self-logit (see the source note in
csrc/flash_decode.cu). The grid is all of S's chunks, whatever ``cur_len``.
The workspace and its tickets belong to the cache (``_workspace``): sized
once from its (B*H, S), reused by every launch on it, and freed with it;
the tickets are 0 between launches. Launches on one cache must therefore
run in order on the device, as its writes already must. The kernels take
head dim 64 (T3's). The
main path runs K1 in bf16; the fp32 kernels serve the exact-token check of
a small fp32 T3 on the card against the CPU (``chip_smoke.py``).

K2 replaces ``flash_cache_merge_ds`` (flash_decode.py:273-353):
- ``kv_cache_append``: the (L, 2, B, H, D) new K/V of one decode step,
  written in place at slot ``pos`` of every layer with one launch: of the
  cache itself on the bf16 path, of the tail on the int8 path;
- K2b ``kv_cache_quantize_write``: n tokens of every (layer, k/v, row,
  head) quantized by ``quantize_kv`` and written in place into the int8 cache
  and its scales (the JAX package's XLA ``quantize_kv`` followed by the int8
  column merge, llama.py:632-646): the prefill's tokens once, then the full
  tail every ``TAIL_W`` steps. Bit-exact with ``quantize_kv``. Eight
  lanes a token, one 16-byte vector each, two tokens a lane in flight
  (see the source note).
Both are bound by bytes.

A wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises. On either device it raises when grad mode is
on and an operand requires grad (``_build.refuse_autograd``): no kernel has a
backward.
"""

import ctypes

import torch
from torch.utils.weak import WeakTensorKeyDictionary

from . import _build
from ._build import require

# tokens the int8 path keeps exact in the tail between merges (the JAX
# package's TAIL_W)
TAIL_W = 8

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIG = {
    "cbx_flash_decode": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P, _P, _P, _P, _F, _P, _P,
                         _P],
    "cbx_flash_decode_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P, _P,
                              _P, _P, _F, _P, _P, _P],
    "cbx_kv_append": [_P, _P, _LL, _I, _I, _I, _P],
    "cbx_kv_quantize": [_P, _P, _P, _I, _LL, _I, _I, _I, _I, _P],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64  # K1's and K2b's kernels: T3's head dim
_CHUNK = 64  # slots a K1 CTA: csrc/flash_decode.cu's CH
_workspaces = WeakTensorKeyDictionary()  # cache -> (partials, tickets, streams recorded)


def _lib():
    return _build.load("flash_decode", _SIG)


def _workspace(cache, pairs: int, s: int):
    """K1's workspace for ``cache`` (the tensor the kernel reads: the cache,
    or the int8 values): pairs * ceil(s / 64) fp32 partials of D + 2 floats,
    and ``pairs`` int32 tickets that are 0 between launches (each launch's
    last chunk CTA resets its own). It belongs to the cache: made at the
    cache's first K1 launch, never regrown, and freed with it, so a CUDA
    graph that captured a launch on the cache stays valid while the cache
    lives. It cannot be made while a graph is being captured: the first
    launch on a cache runs outside the capture. Each stream that launches
    on it is recorded with the allocator, so its memory is not handed out
    again before that stream's work is done."""
    have = _workspaces.get(cache)
    if have is None:
        require(not torch.cuda.is_current_stream_capturing(),
                "K1's workspace is made at the cache's first launch: launch once before capturing")
        have = (torch.empty(pairs * -(-s // _CHUNK) * (_HEAD_DIM + 2), dtype=torch.float32,
                            device=cache.device),
                torch.zeros(pairs, dtype=torch.int32, device=cache.device), set())
        _workspaces[cache] = have
    stream = torch.cuda.current_stream(cache.device)
    if stream.cuda_stream not in have[2] and not torch.cuda.is_current_stream_capturing():
        have[0].record_stream(stream)
        have[1].record_stream(stream)
        have[2].add(stream.cuda_stream)
    return have[0], have[1]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def quantize_kv(kv, axis=-1):
    """Per-token symmetric int8 quantization over ``axis`` (the head dim),
    a copy of the JAX package's ``quantize_kv`` as XLA compiles it: kv
    (..., D) -> (int8 values, fp32 scales with ``axis`` reduced), ``kv ~=
    values * scales[..., None]``, with ``scale = max(absmax * f32(1/127), 1e-8)`` (XLA
    folds the division by the constant 127 into a multiply by its fp32
    reciprocal inside a compiled function, as the JAX decode loop is; JAX
    run op by op divides, and differs in the last bit of a few scales) and
    ``round(x / scale)`` half to even, clipped to +-127. An all-zero
    (padding) token stays zero. ``x / scale`` is a true division (the
    divisor is a tensor; PyTorch's CUDA division by a Python scalar would
    multiply by its reciprocal), so the CUDA kernel K2b matches this bit for
    bit. (A Python scalar factor is applied in fp32, as f32(1/127).)"""
    x = kv.float()
    absmax = x.abs().amax(dim=axis)
    scale = torch.clamp_min(absmax * (1.0 / 127.0), 1e-8)
    q = torch.round(x / scale.unsqueeze(axis)).clamp(-127, 127).to(torch.int8)
    return q, scale


def _attend_plain(k, v, row_prefix, gap_end: int, q, k_new, v_new):
    """softmax([valid logits; self logit]) @ [v; v_new] in fp32 over the
    fp32 keys ``k`` and values ``v`` (B, H, n, D) of slots [0, n). Returns
    (out fp32 (B, H, D), m (B, H), l (B, H)) with m the max of the scaled
    logits and l = sum exp(logit - m), self-logit included in both."""
    n, d = k.shape[2], q.shape[-1]
    scale = d ** -0.5
    qf = q.float()
    logits = torch.einsum("bhd,bhsd->bhs", qf, k) * scale
    idx = torch.arange(n, device=k.device)
    valid = (idx[None] < row_prefix.to(k.device)[:, None].long()) | (idx[None] >= gap_end)
    logits = logits.masked_fill(~valid[:, None, :], float("-inf"))
    self_logit = (qf * k_new.float()).sum(-1, keepdim=True) * scale
    logits = torch.cat([logits, self_logit], dim=-1)
    m = logits.amax(dim=-1)
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)
    probs = e / l[..., None]
    out = torch.einsum("bhs,bhsd->bhd", probs[..., :n], v) + probs[..., n:] * v_new.float()
    return out, m, l


def flash_decode_layer_attention_plain(cache, layer_idx, cur_len, row_prefix, gap_end,
                                      q, k_new, v_new):
    """K1a in fp32, returned in q's dtype. cache (L, 2, B, H, S, D);
    q/k_new/v_new (B, H, D); row_prefix (B,) int; layer_idx, cur_len,
    gap_end ints."""
    out, _, _ = flash_decode_layer_attention_stats_plain(
        cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new)
    return out


def flash_decode_layer_attention_stats_plain(cache, layer_idx, cur_len, row_prefix, gap_end,
                                            q, k_new, v_new):
    """K1b: (out in q's dtype, m (B, H) fp32, l (B, H) fp32)."""
    k = cache[layer_idx, 0, :, :, :cur_len].float()
    v = cache[layer_idx, 1, :, :, :cur_len].float()
    out, m, l = _attend_plain(k, v, row_prefix, gap_end, q, k_new, v_new)
    return out.to(q.dtype), m, l


def flash_decode_layer_attention_int8_plain(cache8, scales, tail, merge_base, layer_idx, cur_len,
                                           row_prefix, gap_end, q, k_new, v_new):
    """K1c+d in fp32, returned in q's dtype: slots [0, merge_base) are
    ``values * scale`` from the int8 cache (L, 2, B, H, S, D) and its scales
    (L, 2, B, H, S); slots [merge_base, cur_len) are tail slots
    [0, cur_len - merge_base) of the tail (L, 2, B, H, W, D)."""
    n_tail = cur_len - merge_base

    def keys(kv):
        main = cache8[layer_idx, kv, :, :, :merge_base].float()
        main = main * scales[layer_idx, kv, :, :, :merge_base, None]
        return torch.cat([main, tail[layer_idx, kv, :, :, :n_tail].float()], dim=2)

    out, _, _ = _attend_plain(keys(0), keys(1), row_prefix, gap_end, q, k_new, v_new)
    return out.to(q.dtype)


def kv_cache_append_plain(cache, new_kv, pos: int):
    """cache[:, :, :, :, pos] = new_kv, in place. cache (L, 2, B, H, S, D),
    new_kv (L, 2, B, H, D)."""
    cache[:, :, :, :, pos] = new_kv.to(cache.dtype)
    return cache


def kv_cache_quantize_write_plain(cache8, scales, src, pos: int):
    """Quantize src (L, 2, B, H, n, D) with ``quantize_kv`` into slots
    [pos, pos + n) of cache8 (L, 2, B, H, S, D) int8 and scales
    (L, 2, B, H, S) fp32, in place."""
    q8, sc = quantize_kv(src)
    n = src.shape[4]
    cache8[:, :, :, :, pos:pos + n] = q8
    scales[:, :, :, :, pos:pos + n] = sc
    return cache8, scales


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_decode_args(cache, row_prefix, q, k_new, v_new):
    """The shared checks of the K1 wrappers; returns (B, H, D)."""
    require(cache.device.type == "cuda", f"unsupported device {cache.device}")
    b, h, d = q.shape
    require(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} is not float32/bfloat16")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new)):
        require(t.shape == (b, h, d) and t.dtype == q.dtype and t.is_contiguous()
                and t.device == cache.device and t.data_ptr() % 16 == 0,
                f"{name} must be a contiguous, 16-byte aligned {(b, h, d)} {q.dtype} tensor "
                f"on {cache.device}")
    require(row_prefix.shape == (b,) and row_prefix.dtype == torch.int32
            and row_prefix.is_contiguous() and row_prefix.device == cache.device,
            "row_prefix must be a contiguous (B,) int32 tensor on the cache's device")
    require(d == _HEAD_DIM, f"head dim {d}: the kernels take {_HEAD_DIM}")
    return b, h, d


def _decode(cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, ml):
    n_layers, two, b, h, s, d = cache.shape
    require(two == 2 and cache.is_contiguous(), "cache must be contiguous (L, 2, B, H, S, D)")
    require(cache.dtype == q.dtype and (b, h, d) == _check_decode_args(
        cache, row_prefix, q, k_new, v_new), "cache and q must agree in dtype and (B, H, D)")
    require(0 <= layer_idx < n_layers and 0 <= cur_len <= s, "layer_idx / cur_len out of range")
    require(cache.data_ptr() % 16 == 0, "cache must be 16-byte aligned")
    out = torch.empty_like(q)
    work, tickets = _workspace(cache, b * h, s)
    status = _lib().cbx_flash_decode(
        cache.data_ptr(), _DTYPE_CODE[cache.dtype], int(layer_idx), b, h, s, d,
        row_prefix.data_ptr(), int(gap_end), int(cur_len), q.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(), d ** -0.5, work.data_ptr(), tickets.data_ptr(),
        _build.stream_ptr(cache),
    )
    _build.check(status, "flash_decode")
    return out


def flash_decode_layer_attention(cache, layer_idx: int, cur_len: int, row_prefix,
                                gap_end: int, q, k_new, v_new):
    """K1a: decode attention for one layer against the full multi-layer
    cache; returns (B, H, D) in q's dtype. See the module docstring."""
    _build.refuse_autograd("flash_decode_layer_attention", cache, q, k_new, v_new)
    if cache.device.type == "cpu":
        return flash_decode_layer_attention_plain(
            cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new)
    out = _decode(cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, None)
    flash_decode_layer_attention.launches += 1
    return out


def flash_decode_layer_attention_stats(cache, layer_idx: int, cur_len: int, row_prefix,
                                      gap_end: int, q, k_new, v_new):
    """K1b: K1a plus the final softmax stats; returns (out (B, H, D) in q's
    dtype, m (B, H) fp32, l (B, H) fp32)."""
    _build.refuse_autograd("flash_decode_layer_attention_stats", cache, q, k_new, v_new)
    if cache.device.type == "cpu":
        return flash_decode_layer_attention_stats_plain(
            cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new)
    ml = torch.empty(q.shape[:2] + (2,), dtype=torch.float32, device=q.device)
    out = _decode(cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, ml)
    flash_decode_layer_attention_stats.launches += 1
    return out, ml[..., 0], ml[..., 1]


def flash_decode_layer_attention_int8(cache8, scales, tail, merge_base: int, layer_idx: int,
                                     cur_len: int, row_prefix, gap_end: int, q, k_new, v_new):
    """K1c+d: decode attention over the int8 cache below ``merge_base`` and
    the tail from ``merge_base`` to ``cur_len``; returns (B, H, D) in q's
    dtype. ``0 <= merge_base <= cur_len <= merge_base + W``."""
    _build.refuse_autograd("flash_decode_layer_attention_int8", scales, tail, q, k_new, v_new)
    n_layers, two, b, h, s, d = cache8.shape
    w = tail.shape[4]
    require(0 <= merge_base <= cur_len <= merge_base + w <= s and 0 <= layer_idx < n_layers,
            f"need 0 <= merge_base ({merge_base}) <= cur_len ({cur_len}) <= merge_base + "
            f"{w} <= {s}, and layer_idx < {n_layers}")
    if cache8.device.type == "cpu":
        return flash_decode_layer_attention_int8_plain(
            cache8, scales, tail, merge_base, layer_idx, cur_len, row_prefix, gap_end,
            q, k_new, v_new)
    require(cache8.dtype == torch.int8 and cache8.is_contiguous() and two == 2,
            "cache8 must be a contiguous (L, 2, B, H, S, D) int8 tensor")
    require(scales.shape == cache8.shape[:5] and scales.dtype == torch.float32
            and scales.is_contiguous() and scales.device == cache8.device,
            "scales must be a contiguous (L, 2, B, H, S) float32 tensor on the cache's device")
    require(tail.shape == (n_layers, 2, b, h, w, d) and tail.dtype == q.dtype
            and tail.is_contiguous() and tail.device == cache8.device,
            "tail must be a contiguous (L, 2, B, H, W, D) tensor of q's dtype")
    require((b, h, d) == _check_decode_args(cache8, row_prefix, q, k_new, v_new),
            "q must be (B, H, D) of the cache")
    require(d % 16 == 0 and cache8.data_ptr() % 16 == 0 and tail.data_ptr() % 16 == 0,
            "int8 rows must be whole, aligned 16-byte vectors")
    out = torch.empty_like(q)
    work, tickets = _workspace(cache8, b * h, s)
    status = _lib().cbx_flash_decode_int8(
        cache8.data_ptr(), scales.data_ptr(), tail.data_ptr(), _DTYPE_CODE[q.dtype],
        int(layer_idx), b, h, s, w, d, row_prefix.data_ptr(), int(gap_end), int(cur_len),
        int(merge_base), q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        d ** -0.5, work.data_ptr(), tickets.data_ptr(), _build.stream_ptr(cache8),
    )
    _build.check(status, "flash_decode_layer_attention_int8")
    flash_decode_layer_attention_int8.launches += 1
    return out


def kv_cache_append(cache, new_kv, pos: int):
    """K2: write one decode step's K/V of every layer into slot ``pos`` of
    the cache (or the tail), in place; returns the cache."""
    _build.refuse_autograd("kv_cache_append", cache, new_kv)
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


def kv_cache_quantize_write(cache8, scales, src, pos: int):
    """K2b: quantize src (L, 2, B, H, n, D) per token into slots
    [pos, pos + n) of the int8 cache and its scales, in place; returns
    (cache8, scales)."""
    _build.refuse_autograd("kv_cache_quantize_write", scales, src)
    n_layers, two, b, h, s, d = cache8.shape
    n = src.shape[4]
    require(src.shape == (n_layers, two, b, h, n, d) and 0 <= pos and pos + n <= s,
            f"src must be (L, 2, B, H, n, D) of the cache with pos + n <= {s}")
    if cache8.device.type == "cpu":
        return kv_cache_quantize_write_plain(cache8, scales, src, pos)
    require(cache8.device.type == "cuda", f"unsupported device {cache8.device}")
    require(cache8.dtype == torch.int8 and cache8.is_contiguous(),
            "cache8 must be a contiguous int8 tensor")
    require(scales.shape == cache8.shape[:5] and scales.dtype == torch.float32
            and scales.is_contiguous() and scales.device == cache8.device,
            "scales must be a contiguous (L, 2, B, H, S) float32 tensor on the cache's device")
    require(src.dtype in _DTYPE_CODE and src.is_contiguous() and src.device == cache8.device
            and src.data_ptr() % 16 == 0,
            "src must be a contiguous, 16-byte aligned float32/bfloat16 tensor on the cache's "
            "device")
    require(d == _HEAD_DIM and cache8.data_ptr() % 16 == 0,
            f"head dim {d}: the kernel takes {_HEAD_DIM}, in whole, aligned int8 rows")
    require(n > 0, "src holds no token")
    status = _lib().cbx_kv_quantize(
        cache8.data_ptr(), scales.data_ptr(), src.data_ptr(), _DTYPE_CODE[src.dtype],
        n_layers * two * b * h, s, n, d, int(pos), _build.stream_ptr(cache8),
    )
    _build.check(status, "kv_cache_quantize_write")
    kv_cache_quantize_write.launches += 1
    return cache8, scales


for _fn in (flash_decode_layer_attention, flash_decode_layer_attention_stats,
            flash_decode_layer_attention_int8, kv_cache_append, kv_cache_quantize_write):
    _fn.launches = 0
