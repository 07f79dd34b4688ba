"""The probes' plain versions (P1-P5, ``chatterbox_tpu_torch/ops/probes.py``
and ``chatterbox_tpu_torch/probes/``), held against the Pallas probes of
``scripts/`` run on the CPU in interpret mode (fp32).

- P4 and P5 run the scripts' own case functions through ``pl.pallas_call``
  with the scripts' specs. The scripts set a JAX compilation cache and run
  their sweeps when imported, so only their imports, constants and
  functions are executed here (``_script_defs``).
- P2 and P3 are not imported at all (each allocates two ~755 MB arrays and
  runs its sweep at import): their writes are held against
  ``lax.dynamic_update_slice``, the scripts' own check, bit for bit.
- P1 rebuilds the boundary probe's chains (probe_boundary.py:124-189) from
  the JAX package's Llama pieces and its decode kernel with the (D, S)
  cache and the bf16 tail, on the tiny Llama, dense and int8 weights.
"""

import ast
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from torch_parity import J_T3, P_T3, assert_close, j, t, t3_params

from chatterbox_tpu_torch.ops import probes
from chatterbox_tpu_torch.probes import boundary, cache_write, int8_cache, ops

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
CPU = torch.device("cpu")


def _script_defs(name):
    """The module-level imports, assignments and functions of
    ``scripts/<name>``, executed without its configuration calls and sweeps."""
    tree = ast.parse((SCRIPTS / name).read_text())
    keep = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom, ast.Assign,
                                                    ast.FunctionDef))]
    ns = {}
    exec(compile(ast.Module(keep, type_ignores=[]), str(SCRIPTS / name), "exec"), ns)
    return ns


def _fixed(shape):
    return pl.BlockSpec(shape, lambda i: (0,) * len(shape))


# ---------------------------------------------------------------- P4

def _fma(a, b, c):
    """fp32 a * b + c rounded once (the product is exact in fp64)."""
    return (a.double() * b.double() + c.double()).float()


def _block_sum(vals):
    """common.cuh's block_sum over 128 fp32 values: each warp's xor
    butterfly, then 0 + warp 0 + warp 1 + warp 2 + warp 3."""
    w = vals.reshape(4, 32)
    for o in (16, 8, 4, 2, 1):
        w = w + w[:, torch.arange(32) ^ o]
    r = torch.zeros((), dtype=torch.float32)
    for k in range(4):
        r = r + w[k, 0]
    return r


_INT8_FNS = {"i8_load_convert": "case_load_convert", "i8_dequant_matmul": "case_dequant_matmul",
             "i8_pv": "case_pv", "i8_matmul_direct": "case_matmul_direct",
             "i8_store": "case_store", "i8_sd_tail": "case_sd_tail"}


@pytest.mark.parametrize("case", probes.INT8_CASES)
def test_int8_probe_plain_matches_pallas(case):
    """Each P4 case as probe_int8_cache.py runs it (:39-52, grid (2,) onto one
    output block): the convert and the truncating store exactly, the sums
    within the port's limit, (n + 2) 2^-24 sum|terms| (fp32 in another
    order)."""
    ns = _script_defs("probe_int8_cache.py")
    d, sb = ns["D"], ns["SB"]
    shape, dtype = {"i8_load_convert": ((d, d), jnp.float32),
                    "i8_store": ((8, sb), jnp.int8)}.get(case, ((1, d), jnp.float32))
    arrays = (ns["K8"], ns["SC"], ns["Q"], ns["KSD8"])
    want = pl.pallas_call(
        ns[_INT8_FNS[case]], grid=(2,),
        in_specs=[_fixed((d, sb)), _fixed((8, sb)), _fixed((8, d)), _fixed((8, d))],
        out_specs=_fixed(shape), out_shape=jax.ShapeDtypeStruct(shape, dtype), interpret=True,
    )(*arrays)
    ins = int8_cache.inputs(CPU)
    for got_in, script_in in zip(ins, arrays):  # the port's inputs are the script's
        np.testing.assert_array_equal(got_in.numpy(), np.asarray(script_in))
    got = probes.int8_probe(case, *ins)
    lim, _ = int8_cache.limit(case, ins)
    if lim is None:
        assert got.dtype == {jnp.int8: torch.int8, jnp.float32: torch.float32}[dtype]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    else:
        assert bool(((got - t(np.asarray(want))).abs() <= lim).all())


def _int8_kernel_walk(case, k8, sc, q, t8):
    """P4's kernel (``csrc/probes.cu`` ``int8_probe_kernel``) in its own order
    and layout, in fp32 on the CPU. K8 as 512 16-byte vectors, vector g =
    row g // 8, slots 16 (g % 8) + k, its 16 values summed in one chain from
    0 (pv and dequant_matmul: sc[0, s] k; matmul_direct: the exact integer
    sum). pv: vector g on thread g of four blocks, a row's 8 lanes added by a
    shuffle-xor tree (4, 2, 1). dequant_matmul and matmul_direct: thread t
    of one block holds vectors t + 128 r, multiplies each row's sum by
    q[0, row], adds its four pairwise, then ``_block_sum``. sd_tail: lane l
    of one warp holds KSD8's vector l (row l // 4, dims 16 (l % 4) + k), then
    a warp's xor butterfly. The convert (a 4-byte word a thread, 8 blocks of
    128) and the store (sc's float4 t + 128 r) follow the same words."""
    tt = torch.arange(128)
    if case == "i8_load_convert":  # thread (b, t): row 8 b + t // 16, word t % 16
        g = torch.arange(8 * 128)
        row, word = g // 16, g % 16
        src = (row * 128 + 4 * word)[:, None] + torch.arange(4)
        out = torch.empty(64 * 64)
        out[(4 * g)[:, None] + torch.arange(4)] = k8.reshape(-1)[src].float() * 0.5
        return out.reshape(64, 64)
    if case == "i8_store":  # float4 t + 128 r of sc -> four int8
        out = torch.empty(8 * 128, dtype=torch.int8)
        s4 = sc.reshape(256, 4)
        for r in range(2):
            x = torch.trunc(s4[tt + 128 * r] * 100.0).clamp(-128, 127)
            out[((tt + 128 * r) * 4)[:, None] + torch.arange(4)] = x.to(torch.int8)
        return out.reshape(8, 128)

    def chain(w, vals):  # sum_k w[:, k] vals[:, k], one fp32 chain from 0
        acc = torch.zeros(vals.shape[0])
        for k in range(16):
            acc = _fma(w[:, k], vals[:, k], acc)
        return acc

    if case == "i8_sd_tail":
        lanes = torch.arange(32)
        qd = q[0][(16 * (lanes % 4))[:, None] + torch.arange(16)]
        acc = chain(qd, t8.reshape(32, 16).float())
        for o in (16, 8, 4, 2, 1):
            acc = acc + acc[lanes ^ o]
        return (0.0 + acc[0]).expand(1, 64)
    g = torch.arange(512)
    kv = k8.reshape(512, 16).float()  # vector g: row g // 8, slots 16 (g % 8) + k
    s = sc[0][(16 * (g % 8))[:, None] + torch.arange(16)]
    if case == "i8_matmul_direct":
        rows_sum = k8.reshape(512, 16).int().sum(1).float()  # exact
    else:
        rows_sum = chain(s, kv)
    if case == "i8_pv":
        p = rows_sum
        for o in (4, 2, 1):
            p = p + p[g ^ o]
        return p[g % 8 == 0][None]
    a = (q[0][g // 8] * rows_sum).reshape(4, 128)  # (r, thread): vector t + 128 r
    return (0.0 + _block_sum((a[0] + a[1]) + (a[2] + a[3]))).expand(1, 64)


@pytest.mark.parametrize("which", ["probe", "wide"])
@pytest.mark.parametrize("case", probes.INT8_CASES)
def test_int8_kernel_walk_within_limit(case, which):
    """The card's P4 kernel sums in another order than the plain version:
    its walk, emulated in fp32, stays within ``int8_cache.limit`` of the plain
    version (the convert and the store bit for bit) on the probe's inputs and
    on ``wide_inputs``, whose K8 and KSD8 span -128..127 and whose signed SC
    makes the store truncate toward zero on both signs."""
    ins = int8_cache.inputs(CPU) if which == "probe" else int8_cache.wide_inputs(CPU)
    if which == "wide":
        k8, sc = ins[0], ins[1]
        assert int(k8.min()) == -128 and int(k8.max()) == 127 and int(ins[3].min()) == -128
        x = sc * 100.0
        assert bool((x.abs() < 127).all()) and bool(((x < 0) & (x != x.trunc())).any())
    got = _int8_kernel_walk(case, *ins)
    want = probes.int8_probe_plain(case, *ins)
    assert got.shape == want.shape and got.dtype == want.dtype
    lim, _ = int8_cache.limit(case, ins)
    if lim is None:
        assert torch.equal(got, want)
    else:
        assert bool(((got - want).abs() <= lim).all())


# ---------------------------------------------------------------- P5

_SOFTMAX_FNS = dict(zip(probes.SOFTMAX_CASES, ("case_a", "case_b", "case_c", "case_d", "case_e",
                                               "case_f", "case_g", "case_h", "case_i")))


@pytest.mark.parametrize("case", probes.SOFTMAX_CASES)
def test_softmax_probe_plain_matches_pallas(case):
    """Each P5 case as probe_ops.py runs it (:22-36): two grid steps over one
    (1, 64) fp32 scratch. Interpret mode starts the scratch as NaN, and case
    H reads it before writing it, so the plain version gets NaN as the
    scratch's initial value and H is all NaN on both sides; the others
    never read it before writing it. Limit: the port's ``ops.limit``."""
    ns = _script_defs("probe_ops.py")
    d, sb = ns["D"], ns["SB"]
    x = jnp.asarray(np.random.default_rng(0).standard_normal((8, sb)), jnp.float32)
    v = jnp.asarray(np.random.default_rng(1).standard_normal((sb, d)), jnp.float32)
    want = np.asarray(pl.pallas_call(
        ns[_SOFTMAX_FNS[case]], grid=(2,), in_specs=[_fixed((8, sb)), _fixed((sb, d))],
        out_specs=_fixed((1, d)), out_shape=jax.ShapeDtypeStruct((1, d), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, d), jnp.float32)], interpret=True,
    )(x, v))
    xt, vt = ops.inputs(CPU)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(x))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(v))
    got = probes.softmax_probe(case, xt, vt, torch.full((1, d), float("nan")))
    if case == "H_dotgen_transpose_rhs":
        assert np.isnan(want).all() and bool(torch.isnan(got).all())
        return
    assert np.isfinite(want).all()
    lim, _ = ops.limit(case, xt, vt, torch.zeros((1, d)))  # scr0 unread by these cases
    assert bool(((got - t(want)).abs() <= lim).all())


def test_softmax_probe_h_from_a_zero_scratch_is_finite():
    """Case H from the zero scratch the card's check uses: finite, and its
    first step's max is the NaN-propagating one (a NaN scratch stays NaN)."""
    x, v = ops.inputs(CPU)
    out = probes.softmax_probe("H_dotgen_transpose_rhs", x, v, torch.zeros((1, 64)))
    assert bool(torch.isfinite(out).all())
    half = torch.zeros((1, 64))
    half[0, :32] = float("nan")
    out = probes.softmax_probe("H_dotgen_transpose_rhs", x, v, half)
    assert bool(torch.isnan(out[0, :32]).all()) and bool(torch.isfinite(out[0, 32:]).all())


def _softmax_kernel_walk(case, x, v, scr0):
    """P5's kernel (``csrc/probes.cu`` ``softmax_probe_kernel``) in its own
    order, in fp32 on the CPU: the two grid steps' shared work once; q.k^T
    (H, I) a key row a thread in four partial sums over 16-byte column blocks
    that start at the row's index (mod 16), added pairwise; e @ v by four
    warps, each over its 32 slots, their sums added pairwise; H's update
    applied twice with the NaN-propagating max."""
    bf = lambda a: a.to(torch.bfloat16).float()  # noqa: E731
    p, scr0 = x[0], scr0.reshape(-1)
    if case in ("B_sum_bcast_store", "F_keepdims_sum"):
        return (0.0 + _block_sum(p)).expand(1, 64)
    if case == "C_sum_via_dot":
        return (_block_sum(p) * 2.0).expand(1, 64)
    if case == "D_max_full_store":
        return p.max().expand(1, 64)
    sc = p
    if case in ("H_dotgen_transpose_rhs", "I_bf16_dots"):
        q = bf(p[:64]) if case == "I_bf16_dots" else p[:64]
        k = bf(v) if case == "I_bf16_dots" else v
        rows = torch.arange(128)
        a = torch.zeros((4, 128), dtype=torch.float32)
        for j in range(16):
            c = ((j + rows) & 15) * 4
            for i in range(4):
                a[i] = _fma(q[c + i], k[rows, c + i], a[i])
        sc = (a[0] + a[1]) + (a[2] + a[3])
    m = sc.max()
    e = torch.exp(sc - m)
    l = _block_sum(e)
    if case == "A_round1_seq":
        e = e / l
    vv = v
    if case == "I_bf16_dots":
        e, vv = bf(e), bf(v)
    part = torch.zeros((4, 64), dtype=torch.float32)
    for kk in range(32):
        s_idx = 32 * torch.arange(4) + kk
        part = _fma(e[s_idx][:, None], vv[s_idx], part)
    pv = (part[0] + part[1]) + (part[2] + part[3])
    if case in ("A_round1_seq", "I_bf16_dots"):
        return pv[None]
    if case == "E_dual_consumer":
        return (pv + (0.0 + m))[None]
    if case == "G_keepdims_softmax":
        return (pv / (0.0 + l))[None]
    s = scr0.clone()
    for _ in range(2):
        m_new = torch.where(torch.isnan(s) | (s > m), s, m)
        s = s * torch.exp(s - m_new) + pv * torch.exp(m - m_new) + l
    return s[None]


_SCRATCHES = [(c, "zero") for c in probes.SOFTMAX_CASES] + \
    [(c, "random") for c in probes.SOFTMAX_CASES] + [("H_dotgen_transpose_rhs", "nan")]


@pytest.mark.parametrize("case,scratch", _SCRATCHES)
def test_softmax_kernel_walk_within_limit(case, scratch):
    """The card's kernel sums in another order than the plain version and
    computes the two grid steps' shared work once: its walk, emulated in
    fp32, stays within ``ops.limit`` of the plain version from a zero, a
    random and (H) a NaN-holding scratch, with the NaN where the plain
    version has it. The random scratch is on the scale of H's largest score
    (~15.6), so that H's result depends on it and on its update being
    applied twice: one application alone is far outside the limit."""
    x, v = ops.inputs(CPU)
    scr0 = torch.zeros((1, 64))
    if scratch != "zero":
        scr0 = torch.from_numpy(16 * np.random.default_rng(2).standard_normal((1, 64)).astype(
            np.float32))
    if scratch == "nan":
        scr0[0, 5] = float("nan")
    if case == "H_dotgen_transpose_rhs" and scratch == "random":
        once, _ = probes._softmax_step(case, x, v, scr0)
        lim, _ = ops.limit(case, x, v, scr0)
        assert not bool(((once - probes.softmax_probe_plain(case, x, v, scr0)).abs()
                         <= lim).all())
    got = _softmax_kernel_walk(case, x, v, scr0)
    want = probes.softmax_probe_plain(case, x, v, scr0)
    lim, _ = ops.limit(case, x, v, scr0)
    assert got.shape == want.shape == (1, 64)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert bool(((got - want).abs() <= lim)[~nan].all())
    assert scratch != "nan" or bool(nan[0, 5]) and int(nan.sum()) == 1


# ---------------------------------------------------------------- P2, P3

@pytest.mark.parametrize("key", list(cache_write.VARIANTS), ids=" ".join)
def test_cache_write_plain_matches_dynamic_update_slice(key):
    """Every P2/P3 variant (on the CPU, the plain slice assignment) equals
    ``lax.dynamic_update_slice`` of the column at ``pos`` bit for bit, at a
    small (l, b, h, d, s) in bf16."""
    l, b, h, d, s, pos = 2, 16, 2, 8, 128, 77
    cache, new = cache_write.make_inputs(CPU, l, b, h, d, s, seed=5)
    want = lax.dynamic_update_slice(j(cache.float().numpy()).astype(jnp.bfloat16),
                                    j(new.float().numpy()).astype(jnp.bfloat16),
                                    (0, 0, 0, 0, 0, pos))
    got = cache_write.write(cache, new, pos, cache_write.VARIANTS[key])
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))


def test_cache_write_moved_bytes():
    """Every variant launches the one column-write kernel: it moves the
    column read and written once, and dirties one 32-byte sector a value
    (each lies S * 2 = 768 bytes from the next)."""
    shape = (30, 2, 16, 16, 64, 384)
    col = 30 * 2 * 16 * 16 * 64 * 2
    assert cache_write.moved_bytes(shape) == 2 * col
    assert cache_write.sectors_written(shape) == col // 2 == 983040


# ---------------------------------------------------------------- P1

P1_ROWS, P1_S, P1_CUR = 4, 128, 77  # cur % 8 == 5: a tail of 5 slots [72, 77)


def _p1_inputs(quant):
    """(JAX params, port params, JAX cache (D, S) and tail, port cache, x0,
    q0): the tiny Llama fused (and int8) as the JAX package compiles it and
    as the port computes it; the port's (S, D) cache holds the JAX tail's
    slots at [merge_base, merge_base + W)."""
    from chatterbox_tpu.models.t3 import llama as jl
    from chatterbox_tpu.ops.flash_decode import TAIL_W
    from chatterbox_tpu_torch.models.t3 import llama as ptl

    jp, pp = t3_params()
    jllama = jax.jit(jl.fuse_qkv_params)(jax.tree.map(jnp.asarray, jp["llama"]))
    pllama = ptl.fuse_qkv_params(pp["llama"])
    if quant:
        jllama = jax.jit(jl.quantize_llama_weights)(jllama)
        pllama = ptl.quantize_llama_weights(pllama)
    cfg = J_T3.llama
    n_l, h, d = cfg.num_hidden_layers, cfg.num_attention_heads, cfg.head_dim
    rng = np.random.default_rng(12)
    cache_ds = (rng.standard_normal((n_l, 2, P1_ROWS, h, d, P1_S)) * 0.5).astype(np.float32)
    tail = (rng.standard_normal((n_l, 2, P1_ROWS, h, TAIL_W, d)) * 0.5).astype(np.float32)
    mb = P1_CUR // TAIL_W * TAIL_W
    cache_sd = np.ascontiguousarray(cache_ds.swapaxes(-1, -2))
    cache_sd[..., mb:mb + TAIL_W, :] = tail
    x0 = (rng.standard_normal((P1_ROWS, 1, cfg.hidden_size)) * 0.5).astype(np.float32)
    q0 = (rng.standard_normal((P1_ROWS, h, d)) * 0.5).astype(np.float32)
    return jllama, pllama, cache_ds, tail, mb, cache_sd, x0, q0


def _p1_jax_chain(params, mode, k, cache, tail, mb, x0, q0):
    """The boundary probe's chain (probe_boundary.py:124-189) in eager JAX on
    the JAX package's pieces, its decode kernel and noop copy in interpret
    mode."""
    from chatterbox_tpu.core.layers import rms_norm
    from chatterbox_tpu.models.t3.llama import _mlp, _qkv, _wmat, apply_rope, rope_cos_sin
    from chatterbox_tpu.ops.flash_decode import flash_decode_layer_attention

    cfg = J_T3.llama
    rows, h, d = P1_ROWS, cfg.num_attention_heads, cfg.head_dim
    cos, sin = rope_cos_sin(cfg, jnp.full((rows, 1), P1_CUR, jnp.int32))
    row_prefix = jnp.full((rows,), boundary.ROW_PREFIX, jnp.int32)

    def attn(lid, q, k_new, v_new):
        return flash_decode_layer_attention(
            cache, lid, P1_CUR, row_prefix, boundary.GAP_END, q, k_new, v_new, tail=tail,
            merge_base=mb, interpret=True, ds_layout=True)

    def noop(q):  # probe_boundary.py:114-122
        def kern(x_ref, o_ref):
            o_ref[...] = x_ref[...]

        return pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(q.shape, q.dtype),
                              interpret=True)(q)

    def layer_body(lp, xx, lid):
        y = rms_norm(lp["input_ln"], xx, cfg.rms_norm_eps)
        q, kk, v = _qkv(lp, y, h, cfg.num_key_value_heads, d)
        q, kk = apply_rope(q, kk, cos, sin)
        if mode == "full":
            a = attn(lid, q[:, :, 0], kk[:, :, 0], v[:, :, 0]).reshape(rows, 1, h * d)
        elif mode == "noop":
            a = noop(q[:, :, 0]).reshape(rows, 1, h * d)
        else:
            a = v.transpose(0, 2, 1, 3).reshape(rows, 1, h * d)
        xx = xx + _wmat(a, lp["o"])
        y = _mlp(lp, rms_norm(lp["post_ln"], xx, cfg.rms_norm_eps))
        return xx + _wmat(y, lp["down"])

    eps = jnp.float32(1e-6)
    c = q0 if mode == "kernel" else x0
    for i in range(k):
        c = c + (eps * (i + 1) * 1e-30).astype(c.dtype)
        for lid in range(cfg.num_hidden_layers):
            if mode == "kernel":
                c = attn(lid, c, c, c)
            else:
                c = layer_body(jax.tree.map(lambda a: a[lid], params["layers"]), c, lid)
    return np.asarray(c)


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("mode", boundary.MODES)
def test_boundary_chains_match_jax(mode, quant):
    """Two repetitions of each P1 chain on the tiny Llama (fused q/k/v, dense
    or int8): the port's ``boundary.chain`` within 1e-5 of the probe's JAX
    chain in fp32 (the products and sums differ in round-off only)."""
    from chatterbox_tpu_torch.models.t3.llama import rope_cos_sin, unstack_layers

    jllama, pllama, cache_ds, tail, mb, cache_sd, x0, q0 = _p1_inputs(quant)
    cfg = P_T3.llama
    cos, sin = rope_cos_sin(cfg, torch.full((P1_ROWS, 1), P1_CUR))
    st = boundary.Setup(
        cfg, unstack_layers(pllama), t(cache_sd),
        torch.full((P1_ROWS,), boundary.ROW_PREFIX, dtype=torch.int32), boundary.GAP_END,
        P1_CUR, cos, sin, t(x0), t(q0), torch.tensor(1e-6))
    want = _p1_jax_chain(jllama, mode, 2, j(cache_ds), j(tail), mb, j(x0), j(q0))
    got = boundary.chain(st, mode, 2)
    assert got.shape == want.shape
    assert_close(got, want, 1e-5, 1e-5)


def test_noop_copy_plain_matches_pallas():
    """P1's kernel: a copy of q, as the probe's ``_noop`` pallas_call."""
    q = np.random.default_rng(13).standard_normal((16, 16, 64)).astype(np.float32)

    def kern(x_ref, o_ref):
        o_ref[...] = x_ref[...]

    want = pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(q.shape, jnp.float32),
                          interpret=True)(j(q))
    src = t(q)
    got = probes.noop_copy(src)
    assert got.data_ptr() != src.data_ptr()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- the entry points

@pytest.mark.parametrize("name", ["boundary", "cache_write", "int8_cache", "ops"])
def test_probe_runs_on_the_cpu(name):
    """Each probe's ``run`` on the CPU (plain versions, nothing timed), at a
    small size where it takes one: a JSON-ready dict naming the device."""
    import json

    kw = {"boundary": dict(layers=1, rows=4),
          "cache_write": dict(l=2, b=16, h=2, d=8, s=128, pos=77)}.get(name, {})
    mod = {"boundary": boundary, "cache_write": cache_write, "int8_cache": int8_cache,
           "ops": ops}[name]
    out = mod.run(CPU, **kw)
    assert out["device"] == "cpu" and json.loads(json.dumps(out)) == out
    if name == "cache_write":
        assert all(r["exact"] for r in out["variants"].values())
        assert len(out["variants"]) == len(cache_write.VARIANTS) + 1
    if name in ("int8_cache", "ops"):
        assert set(out["cases"]) == set(probes.INT8_CASES if name == "int8_cache"
                                        else probes.SOFTMAX_CASES)
