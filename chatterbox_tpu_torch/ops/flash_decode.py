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
  G query heads a KV head (grouped-query attention: 1 for T3's Llama, 4
  for the Granite backbone's attention layers, whose softmax scale the
  caller passes), each CTA loading a chunk of its KV head once for the G;
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
The workspace and its tickets belong to the cache (``_workspace``): one
for each number of (row, query head) pairs a launch takes (B * H * G),
sized from it and S, reused by every launch on it, and freed with it; the
tickets are 0 between launches. Launches on one cache must therefore
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

Positions on the device. The kernels read ``cur_len`` (K1) and ``pos`` (K2,
K2b) from a (1,) int32 tensor on the cache's device when they run: the decode
loop keeps its step on the device, so that a CUDA graph captured once replays
every step (``models/t3/t3.py``). A wrapper also takes an int, which it
checks against the cache and uploads (``device_position``; the upload waits
for the card, and a capture refuses it). The int8 path's tail is a ring of
``TAIL_W`` slots: K1c+d takes ``merge_base = cur_len // TAIL_W * TAIL_W``, K2
writes slot ``pos % S`` (of the tail: ``pos - merge_base``), and K2b takes
``pos`` as the write slot of the last of its n tokens: it quantizes them into
``[pos + 1 - n, pos + 1)`` when ``(pos + 1) % n == 0`` and writes nothing
otherwise, so the decode loop launches it every step and the tail is merged
when ``pos + 1`` closes it (the prefill's s0 tokens: ``pos = s0 - 1``). The
host cannot check a device position against the cache's length: its caller
does, where it still knows the step; K1 clamps ``cur_len`` to [0, S].

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
    "cbx_flash_decode": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _F, _P,
                         _P, _P],
    "cbx_flash_decode_int8": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P, _P,
                              _P, _F, _P, _P, _P],
    "cbx_kv_append": [_P, _P, _LL, _I, _I, _P, _P],
    "cbx_kv_quantize": [_P, _P, _P, _I, _LL, _I, _I, _I, _P, _P],
}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIM = 64  # K1's and K2b's kernels: T3's head dim
_CHUNK = 64  # slots a K1 CTA: csrc/flash_decode.cu's CH
_workspaces = WeakTensorKeyDictionary()  # cache -> {pairs: (partials, tickets, streams)}


def _lib():
    return _build.load("flash_decode", _SIG)


def device_position(pos, device) -> torch.Tensor:
    """A position as the (1,) int32 tensor on ``device`` that the kernels
    read: ``pos`` itself, or an int uploaded (which waits for the card)."""
    if isinstance(pos, torch.Tensor):
        require(pos.shape == (1,) and pos.dtype == torch.int32 and pos.device == device,
                f"a device position must be a (1,) int32 tensor on {device}")
        return pos
    return torch.tensor([int(pos)], dtype=torch.int32, device=device)


def _workspace(cache, pairs: int, s: int):
    """K1's workspace for ``cache`` (the tensor the kernel reads: the cache,
    or the int8 values): pairs * ceil(s / 64) fp32 partials of D + 2 floats,
    and ``pairs`` int32 tickets that are 0 between launches (each launch's
    last chunk CTA resets its own). It belongs to the cache and to
    ``pairs`` (a launch with G query heads a KV head takes G times the
    pairs of one with G = 1, so each G has its own): made at the first K1
    launch of that size on the cache, never regrown, and freed with the
    cache, so a CUDA graph that captured a launch on the cache stays valid
    while the cache lives. It cannot be made while a graph is being
    captured: the first launch of each size on a cache runs outside the
    capture. Each stream that launches on it is recorded with the
    allocator, so its memory is not handed out again before that stream's
    work is done."""
    sized = _workspaces.get(cache)
    if sized is None:
        sized = _workspaces[cache] = {}
    have = sized.get(pairs)
    if have is None:
        require(not torch.cuda.is_current_stream_capturing(),
                "K1's workspace is made at the cache's first launch of each size: launch once "
                "before capturing")
        have = sized[pairs] = (
            torch.empty(pairs * -(-s // _CHUNK) * (_HEAD_DIM + 2), dtype=torch.float32,
                        device=cache.device),
            torch.zeros(pairs, dtype=torch.int32, device=cache.device), set())
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


def _attend_plain(k, v, row_prefix, gap_end: int, q, k_new, v_new, scale=None):
    """softmax([valid logits; self logit]) @ [v; v_new] in fp32 over the
    fp32 keys ``k`` and values ``v`` (B, H, n, D) of slots [0, n), the
    logits times ``scale`` (None: D ** -0.5). q (B, Hq, D) with Hq = G * H:
    query head j reads KV head j // G (K, V, k_new and v_new repeated).
    Returns (out fp32 (B, Hq, D), m (B, Hq), l (B, Hq)) with m the max of
    the scaled logits and l = sum exp(logit - m), self-logit included in
    both."""
    n, d = k.shape[2], q.shape[-1]
    scale = d ** -0.5 if scale is None else scale
    g = q.shape[1] // k.shape[1]
    if g > 1:
        k, v, k_new, v_new = (t.repeat_interleave(g, dim=1) for t in (k, v, k_new, v_new))
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
                                      q, k_new, v_new, *, scale=None):
    """K1a in fp32, returned in q's dtype. cache (L, 2, B, H, S, D);
    q (B, G * H, D), k_new/v_new (B, H, D); row_prefix (B,) int; layer_idx
    and gap_end ints; cur_len an int or a (1,) int tensor; ``scale`` the
    softmax's (None: D ** -0.5)."""
    cur_len = int(cur_len)
    k = cache[layer_idx, 0, :, :, :cur_len].float()
    v = cache[layer_idx, 1, :, :, :cur_len].float()
    out, _, _ = _attend_plain(k, v, row_prefix, gap_end, q, k_new, v_new, scale)
    return out.to(q.dtype)


def flash_decode_layer_attention_stats_plain(cache, layer_idx, cur_len, row_prefix, gap_end,
                                            q, k_new, v_new):
    """K1b: (out in q's dtype, m (B, H) fp32, l (B, H) fp32)."""
    _one_query_head("flash_decode_layer_attention_stats", cache, q)
    cur_len = int(cur_len)
    k = cache[layer_idx, 0, :, :, :cur_len].float()
    v = cache[layer_idx, 1, :, :, :cur_len].float()
    out, m, l = _attend_plain(k, v, row_prefix, gap_end, q, k_new, v_new)
    return out.to(q.dtype), m, l


def _one_query_head(what: str, cache, q):
    """K1b and K1c+d take one query head a KV head."""
    require(q.shape[1] == cache.shape[3],
            f"{what} takes one query head a KV head: q has {q.shape[1]} heads, the cache "
            f"{cache.shape[3]}")


def flash_decode_layer_attention_int8_plain(cache8, scales, tail, merge_base, layer_idx, cur_len,
                                           row_prefix, gap_end, q, k_new, v_new):
    """K1c+d in fp32, returned in q's dtype: slots [0, merge_base) are
    ``values * scale`` from the int8 cache (L, 2, B, H, S, D) and its scales
    (L, 2, B, H, S); slots [merge_base, cur_len) are tail slots
    [0, cur_len - merge_base) of the tail (L, 2, B, H, W, D), where
    ``merge_base = cur_len // W * W`` (``_merge_base``)."""
    _one_query_head("flash_decode_layer_attention_int8", cache8, q)
    merge_base, cur_len = _merge_base(merge_base, cur_len, tail.shape[4]), int(cur_len)
    n_tail = cur_len - merge_base

    def keys(kv):
        main = cache8[layer_idx, kv, :, :, :merge_base].float()
        main = main * scales[layer_idx, kv, :, :, :merge_base, None]
        return torch.cat([main, tail[layer_idx, kv, :, :, :n_tail].float()], dim=2)

    out, _, _ = _attend_plain(keys(0), keys(1), row_prefix, gap_end, q, k_new, v_new)
    return out.to(q.dtype)


def _merge_base(merge_base, cur_len, w: int) -> int:
    """K1c+d's merge_base, ``cur_len // w * w``: ``merge_base`` is None, or
    with an int cur_len that value."""
    if isinstance(cur_len, torch.Tensor):
        require(merge_base is None, "a device cur_len takes merge_base None: the kernel derives it")
    base = int(cur_len) // w * w
    require(merge_base is None or merge_base == base,
            f"merge_base {merge_base} is not cur_len // {w} * {w} = {base}")
    return base


def kv_cache_append_plain(cache, new_kv, pos):
    """cache[:, :, :, :, pos] = new_kv, in place. cache (L, 2, B, H, S, D),
    new_kv (L, 2, B, H, D); a tensor pos writes slot ``pos % S``."""
    if isinstance(pos, torch.Tensor):
        pos = int(pos) % cache.shape[4]
    cache[:, :, :, :, pos] = new_kv.to(cache.dtype)
    return cache


def kv_cache_quantize_write_plain(cache8, scales, src, pos):
    """Quantize src (L, 2, B, H, n, D) with ``quantize_kv`` into slots
    [pos + 1 - n, pos + 1) of cache8 (L, 2, B, H, S, D) int8 and scales
    (L, 2, B, H, S) fp32, in place, when ``(pos + 1) % n == 0``; otherwise
    nothing is written. pos (an int or a (1,) tensor) is the write slot of
    the last token."""
    n, w = src.shape[4], int(pos)
    if (w + 1) % n or not 0 <= w + 1 - n <= w < cache8.shape[4]:
        return cache8, scales
    q8, sc = quantize_kv(src)
    cache8[:, :, :, :, w + 1 - n:w + 1] = q8
    scales[:, :, :, :, w + 1 - n:w + 1] = sc
    return cache8, scales


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check_decode_args(cache, row_prefix, q, k_new, v_new):
    """The shared checks of the K1 wrappers; returns (B, H, D) of the KV
    heads (q holds G * H heads)."""
    require(cache.device.type == "cuda", f"unsupported device {cache.device}")
    b, h, d = k_new.shape
    require(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} is not float32/bfloat16")
    for name, t, shape in (("q", q, (b, q.shape[1], d)), ("k_new", k_new, (b, h, d)),
                           ("v_new", v_new, (b, h, d))):
        require(t.shape == shape and t.dtype == q.dtype and t.is_contiguous()
                and t.device == cache.device and t.data_ptr() % 16 == 0,
                f"{name} must be a contiguous, 16-byte aligned {shape} {q.dtype} tensor "
                f"on {cache.device}")
    require(row_prefix.shape == (b,) and row_prefix.dtype == torch.int32
            and row_prefix.is_contiguous() and row_prefix.device == cache.device,
            "row_prefix must be a contiguous (B,) int32 tensor on the cache's device")
    require(d == _HEAD_DIM, f"head dim {d}: the kernels take {_HEAD_DIM}")
    return b, h, d


def _decode(cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, ml, scale=None):
    n_layers, two, b, h, s, d = cache.shape
    require(two == 2 and cache.is_contiguous(), "cache must be contiguous (L, 2, B, H, S, D)")
    require(cache.dtype == q.dtype and (b, h, d) == _check_decode_args(
        cache, row_prefix, q, k_new, v_new), "cache and q must agree in dtype and (B, H, D)")
    g = q.shape[1] // h
    require(q.shape[1] == g * h and g in (1, 4) and (ml is None or g == 1),
            f"q's {q.shape[1]} heads must be 1 or 4 (K1b: 1) a KV head of the {h}")
    require(0 <= layer_idx < n_layers and (isinstance(cur_len, torch.Tensor) or 0 <= cur_len <= s),
            "layer_idx / cur_len out of range")
    cur_len = device_position(cur_len, cache.device)
    require(cache.data_ptr() % 16 == 0, "cache must be 16-byte aligned")
    out = torch.empty_like(q)
    work, tickets = _workspace(cache, b * h * g, s)
    status = _lib().cbx_flash_decode(
        cache.data_ptr(), _DTYPE_CODE[cache.dtype], int(layer_idx), b, h, g, s, d,
        row_prefix.data_ptr(), int(gap_end), cur_len.data_ptr(), q.data_ptr(),
        k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(),
        None if ml is None else ml.data_ptr(), d ** -0.5 if scale is None else float(scale),
        work.data_ptr(), tickets.data_ptr(), _build.stream_ptr(cache),
    )
    _build.check(status, "flash_decode")
    return out


def flash_decode_layer_attention(cache, layer_idx: int, cur_len, row_prefix,
                                gap_end: int, q, k_new, v_new, *, scale=None):
    """K1a: decode attention for one layer against the full multi-layer
    cache; returns (B, Hq, D) in q's dtype. q holds G query heads a KV head
    of the cache (the kernel takes G = 1 or 4; the plain version any G;
    head j reads KV head j // G), and
    ``scale`` is the softmax's (None: D ** -0.5). See the module
    docstring."""
    _build.refuse_autograd("flash_decode_layer_attention", cache, q, k_new, v_new)
    if cache.device.type == "cpu":
        return flash_decode_layer_attention_plain(
            cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, scale=scale)
    out = _decode(cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, None, scale)
    flash_decode_layer_attention.launches += 1
    return out


def flash_decode_layer_attention_stats(cache, layer_idx: int, cur_len, row_prefix,
                                      gap_end: int, q, k_new, v_new):
    """K1b: K1a plus the final softmax stats; returns (out (B, H, D) in q's
    dtype, m (B, H) fp32, l (B, H) fp32)."""
    _build.refuse_autograd("flash_decode_layer_attention_stats", cache, q, k_new, v_new)
    if cache.device.type == "cpu":
        return flash_decode_layer_attention_stats_plain(
            cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new)
    _one_query_head("flash_decode_layer_attention_stats", cache, q)
    ml = torch.empty(q.shape[:2] + (2,), dtype=torch.float32, device=q.device)
    out = _decode(cache, layer_idx, cur_len, row_prefix, gap_end, q, k_new, v_new, ml)
    flash_decode_layer_attention_stats.launches += 1
    return out, ml[..., 0], ml[..., 1]


def flash_decode_layer_attention_int8(cache8, scales, tail, merge_base, layer_idx: int,
                                     cur_len, row_prefix, gap_end: int, q, k_new, v_new):
    """K1c+d: decode attention over the int8 cache below ``merge_base`` and
    the tail from ``merge_base`` to ``cur_len``; returns (B, H, D) in q's
    dtype, where ``merge_base = cur_len // W * W``: the kernel derives it,
    and the argument is None or, with an int ``cur_len``, that value."""
    _build.refuse_autograd("flash_decode_layer_attention_int8", scales, tail, q, k_new, v_new)
    n_layers, two, b, h, s, d = cache8.shape
    w = tail.shape[4]
    if isinstance(cur_len, torch.Tensor):
        require(merge_base is None, "a device cur_len takes merge_base None: the kernel derives it")
    else:
        merge_base = _merge_base(merge_base, cur_len, w)
        require(0 <= cur_len <= s, f"cur_len {cur_len} outside the cache length {s}")
    require(0 <= layer_idx < n_layers, f"layer_idx {layer_idx} is not below {n_layers}")
    if cache8.device.type == "cpu":
        return flash_decode_layer_attention_int8_plain(
            cache8, scales, tail, merge_base, layer_idx, cur_len, row_prefix, gap_end,
            q, k_new, v_new)
    _one_query_head("flash_decode_layer_attention_int8", cache8, q)
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
    cur_len = device_position(cur_len, cache8.device)
    out = torch.empty_like(q)
    work, tickets = _workspace(cache8, b * h, s)
    status = _lib().cbx_flash_decode_int8(
        cache8.data_ptr(), scales.data_ptr(), tail.data_ptr(), _DTYPE_CODE[q.dtype],
        int(layer_idx), b, h, s, w, d, row_prefix.data_ptr(), int(gap_end), cur_len.data_ptr(),
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), out.data_ptr(), d ** -0.5,
        work.data_ptr(), tickets.data_ptr(), _build.stream_ptr(cache8),
    )
    _build.check(status, "flash_decode_layer_attention_int8")
    flash_decode_layer_attention_int8.launches += 1
    return out


def kv_cache_append(cache, new_kv, pos):
    """K2: write one decode step's K/V of every layer into slot ``pos`` of
    the cache (or the tail), in place; returns the cache. A device ``pos``
    writes slot ``pos % S``."""
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
    if not isinstance(pos, torch.Tensor):  # (a message must not format a device tensor)
        require(0 <= pos < s, f"pos {pos} outside the cache length {s}")
    pos = device_position(pos, cache.device)
    status = _lib().cbx_kv_append(
        cache.data_ptr(), new_kv.data_ptr(), n_layers * two * b * h, s, row_bytes,
        pos.data_ptr(), _build.stream_ptr(cache),
    )
    _build.check(status, "kv_cache_append")
    kv_cache_append.launches += 1
    return cache


def kv_cache_quantize_write(cache8, scales, src, pos):
    """K2b: quantize src (L, 2, B, H, n, D) per token into slots
    [pos + 1 - n, pos + 1) of the int8 cache and its scales, in place, when
    ``(pos + 1) % n == 0``, and write nothing otherwise; returns (cache8,
    scales). ``pos`` is the write slot of the last token: the decode step's
    slot, whose tail ``src`` is merged when it closes it, or the prefill's
    ``s0 - 1`` with its s0 tokens."""
    _build.refuse_autograd("kv_cache_quantize_write", scales, src)
    n_layers, two, b, h, s, d = cache8.shape
    n = src.shape[4]
    require(src.shape == (n_layers, two, b, h, n, d) and n <= s
            and (isinstance(pos, torch.Tensor) or 0 <= pos < s),
            f"src must be (L, 2, B, H, n <= {s}, D) of the cache, and pos a slot of it")
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
    pos = device_position(pos, cache8.device)
    status = _lib().cbx_kv_quantize(
        cache8.data_ptr(), scales.data_ptr(), src.data_ptr(), _DTYPE_CODE[src.dtype],
        n_layers * two * b * h, s, n, d, pos.data_ptr(), _build.stream_ptr(cache8),
    )
    _build.check(status, "kv_cache_quantize_write")
    kv_cache_quantize_write.launches += 1
    return cache8, scales


for _fn in (flash_decode_layer_attention, flash_decode_layer_attention_stats,
            flash_decode_layer_attention_int8, kv_cache_append, kv_cache_quantize_write):
    _fn.launches = 0
