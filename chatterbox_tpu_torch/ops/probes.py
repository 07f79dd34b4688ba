"""The kernels of the five Pallas probes (P1-P5, ``csrc/probes.cu``), each
beside its plain PyTorch version. ``probes/`` drives them.

- P1 ``noop_copy`` (``scripts/probe_boundary.py::_noop``): a copy of q, a
  kernel whose only cost is its launch, launched with programmatic
  dependent launch so that chained launches overlap their set-up;
- P2/P3 ``cache_column_write`` and ``cache_block_rmw``
  (``scripts/probe_cache_write2.py``, ``probe_cache_write3.py``): one K/V
  column written at slot ``pos`` of an (L, 2, B, H, D, S) cache, in place
  (the function of ``lax.dynamic_update_slice``). The scripts' variants
  (a column-only write, or a read-modify-write of the ``s_blk``-slot
  segment that holds ``pos``; ``b_blk`` rows and ``fold_kv`` for the work
  of one Pallas grid cell) all launch one kernel, one thread a line of
  the column;
- P4 ``int8_probe`` (``scripts/probe_int8_cache.py``): the six int8
  fragments ``INT8_CASES``. The probe's two grid steps write the same
  block with the same values, so the kernel, like the plain version,
  computes it once;
- P5 ``softmax_probe`` (``scripts/probe_ops.py``): the nine online-softmax
  fragments ``SOFTMAX_CASES``, over the probe's two grid steps and one
  persistent (1, D) fp32 scratch whose initial value is an argument (case H
  reads it before writing it). Both steps see the same x and v, so the
  kernel computes their shared work once and applies H's scratch update
  twice; ``softmax_probe_plain`` runs the two steps as the probe does and
  stays the specification.

What bounds each kernel and its design: the note in ``csrc/probes.cu``. A
wrapper takes its plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.
"""

import ctypes

import torch

from . import _build
from ._build import require

SB, PD = 128, 64  # the P4/P5 probes' slot block and head dim
INT8_CASES = ("i8_load_convert", "i8_dequant_matmul", "i8_pv", "i8_matmul_direct", "i8_store",
              "i8_sd_tail")
SOFTMAX_CASES = ("A_round1_seq", "B_sum_bcast_store", "C_sum_via_dot", "D_max_full_store",
                 "E_dual_consumer", "F_keepdims_sum", "G_keepdims_softmax",
                 "H_dotgen_transpose_rhs", "I_bf16_dots")

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SIG = {
    "cbx_noop_copy": [_P, _P, _LL, _P],
    "cbx_cache_column_write": [_P, _P, _LL, _I, _I, _P],
    "cbx_int8_probe": [_I, _P, _P, _P, _P, _P, _P],
    "cbx_softmax_probe": [_I, _P, _P, _P, _P, _P],
    "cbx_cuda_versions": [_P, _P],
}


def _lib():
    return _build.load("probes", _SIG)


def cuda_versions() -> dict:
    """The CUDA runtime that the probes' library was built with and the
    driver's version, as "major.minor" (PDL inside a captured CUDA graph
    needs 12.3)."""
    runtime, driver = ctypes.c_int(), ctypes.c_int()
    _build.check(_lib().cbx_cuda_versions(ctypes.byref(runtime), ctypes.byref(driver)),
                 "cuda_versions")
    return {k: f"{n.value // 1000}.{n.value % 1000 // 10}"
            for k, n in (("runtime", runtime), ("driver", driver))}


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def noop_copy_plain(q):
    return q.clone()


def cache_column_write_plain(cache, new, pos: int):
    """cache[..., pos] = new, in place; cache (L, 2, B, H, D, S), new
    (L, 2, B, H, D) or (L, 2, B, H, D, 1). Returns the cache."""
    cache[..., pos] = new.reshape(cache.shape[:5])
    return cache


def int8_probe_plain(case: str, k8, sc, q, t8):
    """P4's case ``case`` on k8 (64, 128) int8, sc (8, 128) f32, q (8, 64)
    f32, t8 (8, 64) int8 (probe_int8_cache.py:61-97). The probe's two grid
    steps write the same block with the same values, so one is computed."""
    d = q.shape[1]

    def bcast(qk):  # zeros((1, D)) + sum(qk, axis=1, keepdims=True)
        return torch.zeros((1, d), dtype=torch.float32, device=q.device) + qk.sum(1, keepdim=True)

    if case == "i8_load_convert":
        return k8.float()[:, :d] * 0.5
    if case == "i8_dequant_matmul":
        return bcast(q[0:1] @ (k8.float() * sc[0:1]))
    if case == "i8_pv":
        return sc[0:1] @ k8.float().T
    if case == "i8_matmul_direct":
        return bcast(q[0:1] @ k8.float())
    if case == "i8_store":  # the f32 -> int8 convert truncates toward zero
        return (sc * 100.0).to(torch.int8)
    if case == "i8_sd_tail":
        return bcast(q[0:1] @ t8.float().T)
    raise ValueError(f"unknown P4 case {case!r}")


def _softmax_step(case: str, x, v, scr):
    """One grid step of P5's case (probe_ops.py:45-144): (out (1, D), scr)."""
    d = v.shape[1]
    zeros = torch.zeros((1, d), dtype=torch.float32, device=x.device)
    p, p2 = x[0], x[0:1]
    if case == "A_round1_seq":
        e = torch.exp(p - p.max())
        return (e / e.sum())[None] @ v, scr
    if case in ("B_sum_bcast_store", "F_keepdims_sum"):
        scr = zeros + p2.sum(1, keepdim=True)
        return scr, scr
    if case == "C_sum_via_dot":
        scr = p[None] @ torch.ones((x.shape[1], d), dtype=torch.float32, device=x.device)
        return scr * 2.0, scr
    if case == "D_max_full_store":
        scr = zeros + p.max()
        return scr, scr
    if case == "E_dual_consumer":
        m = p.max()
        scr = zeros + m
        return torch.exp(p - m)[None] @ v + scr, scr
    if case == "G_keepdims_softmax":
        m = p2.max(1, keepdim=True).values
        e = torch.exp(p2 - m)
        l = e.sum(1, keepdim=True)
        return (e @ v) / (zeros + l), zeros + m + l
    if case == "H_dotgen_transpose_rhs":
        scores = x[0:1, :d] @ v.T
        m = scores.max(1, keepdim=True).values
        e = torch.exp(scores - m)
        l = e.sum(1, keepdim=True)
        pv = e @ v
        m_new = torch.maximum(scr, m)  # NaN-propagating, as jnp.maximum
        scr = scr * torch.exp(scr - m_new) + pv * torch.exp(m - m_new) + l
        return scr, scr
    if case == "I_bf16_dots":
        q2 = x[0:1, :d].to(torch.bfloat16).float()
        k2 = v.to(torch.bfloat16).float()
        scores = q2 @ k2.T
        e = torch.exp(scores - scores.max(1, keepdim=True).values)
        return e.to(torch.bfloat16).float() @ k2, scr
    raise ValueError(f"unknown P5 case {case!r}")


def softmax_probe_plain(case: str, x, v, scr0):
    """P5's case ``case`` over the probe's two grid steps: x (8, 128) f32,
    v (128, 64) f32, scr0 (1, 64) f32 the scratch's initial value. Returns
    the (1, 64) output of the second step."""
    scr = scr0.reshape(1, -1).float()
    for _ in range(2):
        out, scr = _softmax_step(case, x, v, scr)
    return out


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _on_cuda(*ts):
    require(all(t.device.type == "cuda" for t in ts), f"unsupported device {ts[0].device}")
    require(all(t.device == ts[0].device for t in ts), "all tensors must be on one device")


def noop_copy(q):
    """P1: a copy of q (any contiguous tensor whose bytes are whole 16-byte
    vectors)."""
    _build.refuse_autograd("noop_copy", q)
    if q.device.type == "cpu":
        return noop_copy_plain(q)
    _on_cuda(q)
    nbytes = q.numel() * q.element_size()
    require(q.is_contiguous() and nbytes % 16 == 0 and q.data_ptr() % 16 == 0,
            "q must be contiguous and span whole, aligned 16-byte vectors")
    out = torch.empty_like(q)
    _build.check(_lib().cbx_noop_copy(q.data_ptr(), out.data_ptr(), nbytes,
                                      _build.stream_ptr(q)), "noop_copy")
    noop_copy.launches += 1
    return out


def _check_cache(cache, new):
    _on_cuda(cache, new)
    require(cache.dim() == 6 and cache.shape[1] == 2 and cache.is_contiguous()
            and cache.dtype == torch.bfloat16, "cache must be a contiguous (L, 2, B, H, D, S) bf16")
    require(new.numel() == cache[..., 0].numel() and new.dtype == cache.dtype
            and new.is_contiguous(),
            "new must be a contiguous (L, 2, B, H, D[, 1]) tensor of the cache's dtype")
    return cache.shape


def cache_column_write(cache, new, pos: int, b_blk: int):
    """P2/P3 "col": the column ``new`` written at slot ``pos`` of every
    (layer, k/v, row, head, dim) line of ``cache``, in place. ``b_blk``, the
    rows of one Pallas grid cell, must divide B; the kernel's grid follows
    the column, not ``b_blk``. Returns the cache."""
    _build.refuse_autograd("cache_column_write", cache, new)
    if cache.device.type == "cpu":
        return cache_column_write_plain(cache, new, pos)
    _, _, b, _, _, s = _check_cache(cache, new)
    require(b % b_blk == 0 and 0 <= pos < s, f"b_blk {b_blk} must divide B {b}; pos < {s}")
    _build.check(_lib().cbx_cache_column_write(
        cache.data_ptr(), new.data_ptr(), new.numel(), s, int(pos), _build.stream_ptr(cache)),
        "cache_column_write")
    cache_column_write.launches += 1
    return cache


def cache_block_rmw(cache, new, pos: int, b_blk: int, s_blk: int, fold_kv: bool):
    """P2/P3 "rmw": the same write as ``cache_column_write``, by the same
    kernel. On the TPU this variant reads and rewrites the ``s_blk``-slot
    segment that holds ``pos``, one grid cell per (layer, k/v plane unless
    ``fold_kv``, ``b_blk`` rows): whole (D, s_blk) blocks are the smallest
    unit its DMA moves. The card writes 32-byte sectors, so that rewrite has
    no counterpart here; the arguments are checked as the Pallas variant
    takes them. Returns the cache."""
    _build.refuse_autograd("cache_block_rmw", cache, new)
    if cache.device.type == "cpu":
        return cache_column_write_plain(cache, new, pos)
    _, _, b, _, _, s = _check_cache(cache, new)
    require(b % b_blk == 0 and 0 <= pos < s and s_blk % 8 == 0 and s % s_blk == 0
            and cache.data_ptr() % 16 == 0,
            f"b_blk {b_blk} must divide B {b}, s_blk {s_blk} a multiple of 8 dividing S {s}, "
            f"pos < S, and the cache 16-byte aligned")
    _build.check(_lib().cbx_cache_column_write(
        cache.data_ptr(), new.data_ptr(), new.numel(), s, int(pos), _build.stream_ptr(cache)),
        "cache_block_rmw")
    cache_block_rmw.launches += 1
    return cache


def int8_probe(case: str, k8, sc, q, t8):
    """P4: one of ``INT8_CASES`` on the probe's inputs (see
    ``int8_probe_plain``). The kernel reads every input in 16-byte vectors,
    so all four must be 16-byte aligned."""
    _build.refuse_autograd("int8_probe", sc, q)
    if k8.device.type == "cpu":
        return int8_probe_plain(case, k8, sc, q, t8)
    _on_cuda(k8, sc, q, t8)
    for name, x, shape, dtype in (("k8", k8, (PD, SB), torch.int8),
                                  ("sc", sc, (8, SB), torch.float32),
                                  ("q", q, (8, PD), torch.float32),
                                  ("t8", t8, (8, PD), torch.int8)):
        require(tuple(x.shape) == shape and x.dtype == dtype and x.is_contiguous()
                and x.data_ptr() % 16 == 0, f"{name} must be a contiguous, 16-byte aligned "
                f"{shape} {dtype}")
    require(case in INT8_CASES, f"unknown P4 case {case!r}")
    shape, dtype = {"i8_load_convert": ((PD, PD), torch.float32),
                    "i8_store": ((8, SB), torch.int8)}.get(case, ((1, PD), torch.float32))
    out = torch.empty(shape, dtype=dtype, device=k8.device)
    _build.check(_lib().cbx_int8_probe(
        INT8_CASES.index(case), k8.data_ptr(), sc.data_ptr(), q.data_ptr(), t8.data_ptr(),
        out.data_ptr(), _build.stream_ptr(k8)), f"int8_probe {case}")
    int8_probe.launches += 1
    return out


def softmax_probe(case: str, x, v, scr0):
    """P5: one of ``SOFTMAX_CASES`` over the probe's two grid steps (see
    ``softmax_probe_plain``); returns (1, 64) f32. The kernel copies v into
    shared memory in one bulk copy, so v must be 16-byte aligned."""
    _build.refuse_autograd("softmax_probe", x, v, scr0)
    if x.device.type == "cpu":
        return softmax_probe_plain(case, x, v, scr0)
    _on_cuda(x, v, scr0)
    for name, t, shape in (("x", x, (8, SB)), ("v", v, (SB, PD)), ("scr0", scr0, (1, PD))):
        require(tuple(t.shape) == shape and t.dtype == torch.float32 and t.is_contiguous(),
                f"{name} must be a contiguous {shape} float32")
    require(v.data_ptr() % 16 == 0, "v must be 16-byte aligned")
    require(case in SOFTMAX_CASES, f"unknown P5 case {case!r}")
    out = torch.empty((1, PD), dtype=torch.float32, device=x.device)
    _build.check(_lib().cbx_softmax_probe(
        SOFTMAX_CASES.index(case), x.data_ptr(), v.data_ptr(), scr0.data_ptr(), out.data_ptr(),
        _build.stream_ptr(x)), f"softmax_probe {case}")
    softmax_probe.launches += 1
    return out


for _fn in (noop_copy, cache_column_write, cache_block_rmw, int8_probe, softmax_probe):
    _fn.launches = 0
