"""The port's kernels (K1a-d, K2, K2b, K3, K4, K5), held against the JAX
package's Pallas kernels (interpret mode on the CPU), and the tile walk of
K3/K5's Hopper kernel emulated against their plain version.

On the CPU each wrapper takes its plain PyTorch version, so these tests hold
the kernels' arithmetic; the CUDA kernels themselves are held against the
plain versions by ``test_torch_cuda.py`` (skips without a card) and by
``chip_smoke.py`` on the card. Everything runs in fp32 here, so the
tolerance is fp32 round-off over sums of a few hundred terms: 1e-5.
"""

import jax
import numpy as np
import pytest
import torch

from torch_parity import assert_close, j, t

from chatterbox_tpu.ops import flash_attention as j_fa
from chatterbox_tpu.ops import flash_decode as j_fd
from chatterbox_tpu_torch.ops import flash_attention as p_fa
from chatterbox_tpu_torch.ops import flash_decode as p_fd
from chatterbox_tpu_torch.ops import kernels, launch_counts, reset_launch_counts

TOL = 1e-5


def _decode_case(seed, b=4, h=2, s=256, d=32, layers=3):
    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((layers, 2, b, h, s, d)).astype(np.float32)
    q, kn, vn = (rng.standard_normal((b, h, d)).astype(np.float32) for _ in range(3))
    return cache, q, kn, vn


@pytest.mark.parametrize("layer,cur_len,gap_end,row_prefix", [
    (0, 200, 200, [200, 200, 200, 200]),  # prefix-only mask (gap_end == cur_len)
    (1, 157, 96, [40, 70, 96, 12]),  # text-padding gap, length not a multiple of 128
    (2, 129, 100, [99, 5, 60, 100]),  # one slot into the second 128-slot block
    (2, 37, 37, [1, 37, 20, 0]),  # row with no valid cache slot: self only
])
def test_flash_decode_plain_matches_pallas(layer, cur_len, gap_end, row_prefix):
    cache, q, kn, vn = _decode_case(layer)
    rp = np.asarray(row_prefix, np.int32)
    want = j_fd.flash_decode_layer_attention(
        j(cache), layer, cur_len, j(rp), gap_end, j(q), j(kn), j(vn),
        interpret=True, ds_layout=False,
    )
    got = p_fd.flash_decode_layer_attention(
        t(cache), layer, cur_len, t(rp), gap_end, t(q), t(kn), t(vn))
    assert got.shape == (4, 2, 32)
    assert_close(got, np.asarray(want), TOL, TOL)


def test_flash_decode_ignores_slots_past_cur_len():
    """Slots at or after cur_len (the stale write slot and everything later)
    never enter the result."""
    cache, q, kn, vn = _decode_case(7)
    rp = t(np.full((4,), 50, np.int32))
    a = p_fd.flash_decode_layer_attention(t(cache), 1, 90, rp, 60, t(q), t(kn), t(vn))
    cache[:, :, :, :, 90:] = 1e4
    cache[:, :, :, :, 50:60] = -1e4  # the gap
    b = p_fd.flash_decode_layer_attention(t(cache), 1, 90, rp, 60, t(q), t(kn), t(vn))
    assert torch.equal(a, b)


def _int8_case(seed, l=3, b=4, h=4, s=256, d=64):
    """The inputs of the JAX package's test_flash_decode_int8_cache_matches_bf16
    (test_ops.py:227-258), in fp32: a cache quantized per token, q and the
    current token's k/v."""
    from chatterbox_tpu.models.t3.llama import quantize_kv

    rng = np.random.default_rng(seed)
    cache = rng.standard_normal((l, 2, b, h, s, d)).astype(np.float32)
    q, kn, vn = (rng.standard_normal((b, h, d)).astype(np.float32) for _ in range(3))
    q8, sc = (np.array(a) for a in quantize_kv(j(cache)))
    return cache, q8, sc, q, kn, vn


@pytest.mark.parametrize("layer,cur_len,gap_end,row_prefix", [
    (1, 141, 100, [30, 140, 1, 64]),  # the JAX test's case: a gap, cur_len % 8 == 5
    (2, 136, 100, [30, 136, 1, 64]),  # cur_len == merge_base: an empty tail
    (0, 135, 135, [135, 135, 135, 135]),  # prefix-only, a tail of 7 slots
])
def test_flash_decode_int8_plain_matches_pallas(layer, cur_len, gap_end, row_prefix):
    """K1c+d: slots below merge_base from the int8 cache and its scales,
    slots [merge_base, cur_len) from the tail. The port's main-cache slots
    at and past merge_base hold poison, which must never be read. Every
    row_prefix is at most cur_len, as in T3 (row_prefix <= s0 - BOS <
    cur_len): past cur_len the Pallas tail would count slots below a larger
    row_prefix as valid, where the port reads nothing at or past cur_len."""
    cache, q8, sc, q, kn, vn = _int8_case(layer)
    w = p_fd.TAIL_W
    mb = cur_len // w * w
    tail = cache[:, :, :, :, mb:mb + w]
    rp = np.asarray(row_prefix, np.int32)
    want = j_fd.flash_decode_layer_attention(
        j(q8.swapaxes(-1, -2)), layer, cur_len, j(rp), gap_end, j(q), j(kn), j(vn),
        tail=j(tail), merge_base=mb, scales=j(sc), interpret=True, ds_layout=True)
    q8[..., mb:, :], sc[..., mb:] = 127, 1e4
    got = p_fd.flash_decode_layer_attention_int8(
        t(q8), t(sc), t(tail).contiguous(), mb, layer, cur_len, t(rp), gap_end, t(q), t(kn),
        t(vn))
    assert_close(got, np.asarray(want), TOL, TOL)


def test_flash_decode_stats_plain_matches_pallas():
    """K1b: the output and the final softmax stats (m, l), over a gap and a
    length that is not a multiple of the 128-slot block."""
    cache, q, kn, vn = _decode_case(8)
    rp = np.asarray([40, 70, 96, 12], np.int32)
    want = j_fd.flash_decode_layer_attention(
        j(cache), 1, 157, j(rp), 96, j(q), j(kn), j(vn), interpret=True, return_stats=True)
    got = p_fd.flash_decode_layer_attention_stats(t(cache), 1, 157, t(rp), 96, t(q), t(kn), t(vn))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), TOL, TOL)
    out, m, l = got
    assert torch.equal(out, p_fd.flash_decode_layer_attention(
        t(cache), 1, 157, t(rp), 96, t(q), t(kn), t(vn)))


def _split_s_walk(keys, values, v_scale, cur_len, row_prefix, gap_end, q, k_new, v_new,
                  chunk, warps=4, rows_step=16):
    """K1's split-S arithmetic (csrc/flash_decode.cu) written out in fp32.
    keys (B, H, cur_len, D): the q.k factor of each slot (on the int8 path
    the int8 values times their K scale: the kernel multiplies the dot by
    the scale, as here in fp32 up to rounding); values (B, H, cur_len, D)
    and v_scale (B, H, cur_len) (the factor a probability takes into the V
    sum: the V scale, or 1). Each chunk of ``chunk`` slots is split among
    its warps as the kernel's threads take rows (row r to warp
    (r % rows_step) // (rows_step // warps)); each warp's (m, l, acc) over
    its valid slots, the warps merged in order into the chunk's; the
    chunks folded in chunk order with the self-logit. Returns (out, M, l)."""
    b, h, _, d = keys.shape
    scale = d ** -0.5
    qf = q.float()
    idx = torch.arange(cur_len)
    valid = (idx[None] < row_prefix[:, None].long()) | (idx[None] >= gap_end)  # (B, S)
    logits = torch.einsum("bhd,bhsd->bhs", qf, keys) * scale
    logits = logits.masked_fill(~valid[:, None, :], -torch.inf)
    n_live = max(1, -(-cur_len // chunk))
    parts = []
    for c in range(n_live):
        lo, hi = c * chunk, min((c + 1) * chunk, cur_len)
        warp_of = (torch.arange(lo, hi) - lo) % rows_step // (rows_step // warps)
        mc = torch.full((b, h), -torch.inf)
        wp = []
        for w in range(warps):
            sel = torch.arange(lo, hi)[warp_of == w]
            s = logits[..., sel]
            m = s.amax(dim=-1) if len(sel) else torch.full((b, h), -torch.inf)
            p = torch.where(s == -torch.inf, 0.0, torch.exp(s - m[..., None]))
            wp.append((m, p.sum(-1), torch.einsum("bhs,bhsd->bhd", p * v_scale[..., sel],
                                                  values[..., sel, :])))
            mc = torch.maximum(mc, m)
        lc, ac = torch.zeros((b, h)), torch.zeros((b, h, d))
        for m, l, acc in wp:
            e = torch.where(l > 0, torch.exp(m - mc), 0.0)
            lc, ac = lc + l * e, ac + acc * e[..., None]
        parts.append((mc, lc, ac))
    m_self = (qf * k_new.float()).sum(-1) * scale
    big = m_self
    for mc, _, _ in parts:
        big = torch.maximum(big, mc)
    es = torch.exp(m_self - big)
    l, acc = es, es[..., None] * v_new.float()
    for mc, lc, ac in parts:
        e = torch.where(lc > 0, torch.exp(mc - big), 0.0)
        l, acc = l + lc * e, acc + ac * e[..., None]
    return acc / l[..., None], big, l


# (cur_len, gap_end, row_prefix) on a 256-slot cache of 4 rows
_SPLIT_CASES = {
    "chunk_in_gap": (200, 150, [10, 12, 5, 0]),  # slots [64, 128) are all gap
    "boundary_at_prefix_and_gap_end": (192, 128, [64, 64, 64, 64]),
    "below_one_chunk": (10, 10, [3, 10, 0, 7]),
    "cur_len_at_s": (256, 100, [40, 60, 80, 100]),
    "row_prefix_0": (150, 70, [0, 0, 64, 0]),
}


@pytest.mark.parametrize("chunk", [16, 64, 128])
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_split_s_walk_matches_plain(chunk, case):
    """K1a/K1b's chunking, the warps' merge and the in-order combine,
    emulated in fp32, against ``flash_decode_layer_attention_stats_plain``
    (itself held to the Pallas kernel above): the output within 1e-5, m
    within 1e-5|m| + 1e-5, l within 1e-4|l| (the card tests' limits). The
    cases put chunks wholly inside the gap, chunk boundaries at row_prefix
    and gap_end, cur_len below one chunk and at S, and rows with
    row_prefix 0."""
    cur_len, gap_end, row_prefix = _SPLIT_CASES[case]
    cache, q, kn, vn = _decode_case(30, d=64)
    rp = t(np.asarray(row_prefix, np.int32))
    k = t(cache[1, 0, :, :, :cur_len])
    v = t(cache[1, 1, :, :, :cur_len])
    out, m, l = _split_s_walk(k, v, torch.ones(k.shape[:3]), cur_len, rp, gap_end, t(q), t(kn),
                              t(vn), chunk)
    want, want_m, want_l = p_fd.flash_decode_layer_attention_stats_plain(
        t(cache), 1, cur_len, rp, gap_end, t(q), t(kn), t(vn))
    assert_close(out, want.numpy(), TOL, TOL)
    assert bool(((m - want_m).abs() <= 1e-5 * want_m.abs() + 1e-5).all())
    assert bool(((l - want_l).abs() <= 1e-4 * want_l).all())


@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("cur_len", [128, 135, 255, 7])
def test_split_s_walk_int8_matches_plain(chunk, cur_len):
    """K1c+d's walk: slots below merge_base from the int8 cache (the K scale
    on the logit, the V scale on the probability), the tail exact, against
    ``flash_decode_layer_attention_int8_plain``: merge_base on a chunk
    boundary with a tail of 0 (128) and of 7 (135), a tail of 7 in the last
    chunk of S (255), and cur_len below one chunk with merge_base 0 (7)."""
    cache, q8, sc, q, kn, vn = _int8_case(40)
    w = p_fd.TAIL_W
    mb = cur_len // w * w
    tail = cache[:, :, :, :, mb:mb + w]
    rp, gap_end = np.asarray([30, 0, 64, 100], np.int32), 100
    layer = 2

    def slots(kv):  # the walk's operands: the int8 values (and scales), then the tail
        vals = np.concatenate([q8[layer, kv, :, :, :mb].astype(np.float32),
                               tail[layer, kv, :, :, :cur_len - mb]], axis=2)
        scl = np.concatenate([sc[layer, kv, :, :, :mb],
                              np.ones(tail.shape[2:4] + (cur_len - mb,), np.float32)], axis=2)
        return t(vals), t(scl)

    (k8, sk), (v8, sv) = slots(0), slots(1)
    out, _, _ = _split_s_walk(k8 * sk[..., None], v8, sv, cur_len, t(rp), gap_end, t(q), t(kn),
                              t(vn), chunk)
    want = p_fd.flash_decode_layer_attention_int8_plain(
        t(q8), t(sc), t(tail).contiguous(), mb, layer, cur_len, t(rp), gap_end, t(q), t(kn),
        t(vn))
    assert_close(out, want.numpy(), TOL, TOL)


def test_kv_cache_quantize_write_matches_jax_merge():
    """K2b: n tokens quantized into the (S, D) int8 cache at ``pos`` equal
    the JAX package's ``quantize_kv`` followed by the int8 column merge into
    its (D, S) cache, bit for bit, scales included."""
    from chatterbox_tpu.models.t3.llama import quantize_kv

    rng = np.random.default_rng(9)
    l, b, h, d, s, w, pos = 3, 2, 2, 32, 256, 8, 136
    cache_ds = rng.integers(-127, 128, (l, 2, b, h, d, s)).astype(np.int8)
    scales = rng.random((l, 2, b, h, s)).astype(np.float32)
    new = rng.standard_normal((l, 2, b, h, w, d)).astype(np.float32)
    q8, sc = jax.jit(quantize_kv)(j(new))  # compiled, as in the decode loop
    want = np.asarray(j_fd.flash_cache_merge_ds(j(cache_ds), q8.swapaxes(-1, -2), pos,
                                                interpret=True))
    want_sc = scales.copy()
    want_sc[..., pos:pos + w] = np.asarray(sc)
    cache = t(cache_ds.transpose(0, 1, 2, 3, 5, 4)).contiguous()
    got_sc = t(scales)
    out = p_fd.kv_cache_quantize_write(cache, got_sc, t(new), pos)
    assert out[0] is cache and out[1] is got_sc
    np.testing.assert_array_equal(cache.numpy(), want.transpose(0, 1, 2, 3, 5, 4))
    np.testing.assert_array_equal(got_sc.numpy(), want_sc)


def test_kv_cache_append_matches_pallas_merge():
    """K2 writes one step's (L, 2, B, H, D) K/V at slot ``pos`` of the (S, D)
    cache; W appends equal the JAX W-column merge into the (D, S) cache."""
    rng = np.random.default_rng(3)
    l, b, h, d, s, w, pos = 3, 2, 2, 16, 256, 8, 136
    cache_ds = rng.standard_normal((l, 2, b, h, d, s)).astype(np.float32)
    cols = rng.standard_normal((l, 2, b, h, d, w)).astype(np.float32)
    want = np.asarray(j_fd.flash_cache_merge_ds(j(cache_ds), j(cols), pos, interpret=True))
    cache = t(cache_ds.transpose(0, 1, 2, 3, 5, 4)).contiguous()  # (L, 2, B, H, S, D)
    for i in range(w):
        out = p_fd.kv_cache_append(cache, t(cols[..., i]).contiguous(), pos + i)
        assert out is cache
    np.testing.assert_array_equal(cache.numpy(), want.transpose(0, 1, 2, 3, 5, 4))


@pytest.mark.parametrize("t_len,n_valid", [(128, [128, 100]), (256, [256, 37])])
def test_flash_self_attention_packed_plain_matches_pallas(t_len, n_valid):
    rng = np.random.default_rng(t_len)
    b, h, d = 2, 4, 64
    qkv = rng.standard_normal((b, t_len, 3 * h * d)).astype(np.float32)
    valid = np.arange(t_len)[None] < np.asarray(n_valid)[:, None]
    bias = np.where(valid, 0.0, -1.0e10).astype(np.float32)
    want = j_fa.flash_self_attention_packed(j(qkv), j(bias), n_heads=h, interpret=True)
    got = p_fa.flash_self_attention_packed(t(qkv), t(bias), h)
    assert_close(got, np.asarray(want), TOL, TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_self_attention_plain_matches_pallas(dtype):
    """K5 on (B, H, T, D) with pad keys at -1e10, as test_ops.py's
    test_flash_self_attention_matches_dense. In bf16 both sides round the
    unnormalised probabilities to bf16, divide by their fp32 sum after the
    value product, and round the output once. Logits that part in the last
    fp32 bit can round a probability to the neighbouring bf16 value (2^-8 of
    itself), so the limit is chip_smoke.py's: |got - want| <= 2^-7 |want| +
    2^-7 P|v| + 1e-5, with P|v| the fp32 attention on |v|."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    b, h, t_len, d = 2, 4, 256, 64
    q, k, v = (rng.standard_normal((b, h, t_len, d)).astype(np.float32) for _ in range(3))
    bias = np.where(np.arange(t_len)[None] < np.array([200, 256])[:, None], 0.0,
                    -1.0e10).astype(np.float32)
    jdt, pdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(j_fa.flash_self_attention(*(j(x).astype(jdt) for x in (q, k, v)), j(bias),
                                                interpret=True), np.float32)
    got = p_fa.flash_self_attention(*(t(x, pdt) for x in (q, k, v)), t(bias))
    assert got.dtype == pdt and tuple(got.shape) == (b, h, t_len, d)
    if dtype == "float32":
        assert_close(got, want, TOL, TOL)
    else:
        p_abs_v = p_fa.flash_self_attention_plain(t(q), t(k), t(np.abs(v)), t(bias)).numpy()
        limit = 2.0 ** -7 * (np.abs(want) + p_abs_v) + 1e-5
        assert (np.abs(got.float().numpy() - want) <= limit).all()


def _tile_walk(tile_scores, v, bias, scale, bn=128):
    """The online softmax of the Hopper kernels (csrc/flash_attention_sm90.cu)
    written out in fp32: keys in tiles of ``bn``, ``tile_scores(t0)`` the
    fp32 scores of keys [t0, t0 + bn) of every (row, head, query);
    x = S * (scale * log2 e) + bias * log2 e; a running row max m;
    P = exp2(x - m), rounded to bf16 for the value product with v (B, H, T,
    D) bf16; the row sum l in fp32 from the unrounded P; O and l rescaled by
    exp2(m_old - m_new); O / l rounded to bf16 at the end. (The kernel folds
    x into one FMA, which can differ from this multiply-add in x's last
    bit.)"""
    b, h, t, d = v.shape
    log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
    scale_log2 = torch.tensor(scale, dtype=torch.float32) * log2e
    bias_log2 = bias.float()[:, None, None, :] * log2e
    m = torch.full((b, h, t, 1), -torch.inf)
    l = torch.zeros((b, h, t, 1))
    o = torch.zeros((b, h, t, d))
    for t0 in range(0, t, bn):
        x = tile_scores(t0) * scale_log2 + bias_log2[..., t0:t0 + bn]
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + p.to(torch.bfloat16).float() @ v[..., t0:t0 + bn, :].float()
        m = m_new
    return (o / l).to(torch.bfloat16)


def _sm90_tile_walk(q, k, v, bias, bn=128):
    """K3/K5's arithmetic (``_tile_walk``) on (B, H, T, 64) bf16 q, k, v."""
    return _tile_walk(
        lambda t0: q.float() @ k[..., t0:t0 + bn, :].float().transpose(-1, -2), v, bias,
        q.shape[-1] ** -0.5, bn)


@pytest.mark.parametrize("t_len", [128, 384, 1024])
def test_sm90_tile_walk_matches_plain(t_len):
    """The Hopper kernel's tile order, exp2 with the folded scale and the
    per-tile bf16 rounding of the unnormalised P, emulated on the CPU,
    against ``flash_self_attention_plain`` within chip_smoke.py's limit
    |got - want| <= 2^-7 |want| + 2^-7 P|v| + 1e-5 (P|v|: the plain version
    on |v|). Rows: a general finite bias, a single valid key, valid keys only
    in the last tile, logits x8 (the running max moves), every key masked
    (the plain result is the mean of v over all keys: no tile may be
    skipped). T = 384 is 3 tiles."""
    rng = np.random.default_rng(70 + t_len)
    q, k, v = (rng.standard_normal((5, 2, t_len, 64)).astype(np.float32) for _ in range(3))
    q[3] *= 8
    bias = np.zeros((5, t_len), np.float32)
    bias[0] = rng.standard_normal(t_len) * 2
    bias[1, 1:] = -1.0e10
    bias[2, :t_len - 91] = -1.0e10
    bias[4] = -1.0e10
    q, k, v = (t(x, torch.bfloat16) for x in (q, k, v))
    got = _sm90_tile_walk(q, k, v, t(bias)).float()
    want = p_fa.flash_self_attention_plain(q, k, v, t(bias)).float()
    p_abs_v = p_fa.flash_self_attention_plain(q, k, v.abs(), t(bias)).float()
    limit = 2.0 ** -7 * (want.abs() + p_abs_v) + 1e-5
    assert bool(((got - want).abs() <= limit).all())
    # the masked row: the plain version's uniform mean, within the output's rounding
    mean_v = v[4].float().mean(dim=-2, keepdim=True).expand(2, t_len, 64)
    assert bool(((got[4] - mean_v).abs() <= 2.0 ** -8 * mean_v.abs() + 1e-6).all())


@pytest.mark.parametrize("layout", ["fused_aligned", "fused_unaligned", "unfused"])
def test_unet_attn_dispatch_matches_jax(layout):
    """The UNet's attention on the three weight layouts, against the JAX
    package's ``_attn`` (fp32, Pallas in interpret mode): fused with an
    inner width of 256 takes K3 on both sides, fused with 3 heads of 64
    (192) takes K5 on both. Unfused to_q/to_k/to_v weights take K5 in the
    port; the JAX dispatch sends them to its packed branch, which raises
    KeyError on the missing ``to_qkv``, so they are held against the JAX
    dense path (``use_flash=False``) and against the fused K3 result of the
    same weights."""
    from chatterbox_tpu.models.s3gen import unet as ju
    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.models.s3gen import unet as pu

    heads = 3 if layout == "fused_unaligned" else 4
    c, inner = 64, heads * 64
    rng = np.random.default_rng(11)
    jp = {"to_qkv": {"w": (rng.standard_normal((c, 3 * inner)) / 8).astype(np.float32)},
          "to_out": {"w": (rng.standard_normal((inner, c)) / 16).astype(np.float32),
                     "b": rng.standard_normal(c).astype(np.float32)}}
    x = rng.standard_normal((2, 50, c)).astype(np.float32)
    key_bias = np.where(np.arange(50)[None] < np.array([50, 37])[:, None], 0.0,
                        -1.0e10).astype(np.float32)
    pp = weights.from_jax_tree(jp)
    want = np.asarray(ju._attn(jax.tree.map(j, jp), j(x), heads, j(key_bias)))
    reset_launch_counts()
    if layout == "unfused":
        w = np.split(jp["to_qkv"]["w"], 3, axis=1)
        jp_split = {"to_q": {"w": w[0]}, "to_k": {"w": w[1]}, "to_v": {"w": w[2]},
                    "to_out": jp["to_out"]}
        with pytest.raises(KeyError):
            ju._attn(jax.tree.map(j, jp_split), j(x), heads, j(key_bias))
        dense = np.asarray(ju._attn(jax.tree.map(j, jp_split), j(x), heads, j(key_bias),
                                    use_flash=False))
        pp = weights.split_unet_qkv(pp)
        assert set(pp) == {"to_q", "to_k", "to_v", "to_out"}
        got = pu._attn(pp, t(x), heads, t(key_bias))
        assert_close(got, dense, 2e-5, 1e-5)
    else:
        got = pu._attn(pp, t(x), heads, t(key_bias))
    assert_close(got, want, 2e-5, 1e-5)
    assert launch_counts() == {name: 0 for name in kernels()}  # CPU: the plain versions


def _relpos_case(seed, b=2, t_len=128, h=4, d=32, c=128):
    rng = np.random.default_rng(seed)
    q_u, k, v = (rng.standard_normal((b, t_len, h * d)).astype(np.float32) * 0.5
                 for _ in range(3))
    q_hat = (rng.standard_normal((b, t_len, h * c)) * 0.1).astype(np.float32)
    s_hat = rng.standard_normal((1, t_len, c)).astype(np.float32)
    valid = np.arange(t_len)[None] < np.asarray([t_len, t_len - 29])[:, None]
    bias = np.where(valid, 0.0, -1.0e9).astype(np.float32)
    return q_u, q_hat, k, s_hat, v, bias


@pytest.mark.parametrize("t_len", [128, 256])
def test_flash_relpos_plain_matches_pallas(t_len):
    q_u, q_hat, k, s_hat, v, bias = _relpos_case(t_len, t_len=t_len)
    scale = 1.0 / np.sqrt(32)
    want = j_fa.flash_relpos_attention(j(q_u), j(q_hat), j(k), j(s_hat), j(v), j(bias),
                                       n_heads=4, scale=scale, interpret=True, heads_per_cell=4)
    got = p_fa.flash_relpos_attention(t(q_u), t(q_hat), t(k), t(s_hat), t(v), t(bias), 4, scale)
    assert_close(got, np.asarray(want), TOL, TOL)


def _relpos_sm90_walk(q_u, q_hat, k, s_hat, v, bias, n_heads, scale, bn=128):
    """K4's arithmetic on the Hopper body: per key tile, S = q_u.k^T and then
    q-hat.s-hat^T in 64-wide depth chunks, accumulated in fp32 in the
    kernel's chunk order, then ``_tile_walk``'s softmax and P.V. Operands
    as ``flash_relpos_attention`` takes them (bf16), output (B, T, H*64)."""
    from chatterbox_tpu_torch.core.layers import merge_heads, split_heads

    t, c = q_u.shape[1], q_hat.shape[-1] // n_heads
    qu, kk, vv, qh = (split_heads(x, n_heads) for x in (q_u, k, v, q_hat))
    sh = s_hat.reshape(t, c).to(torch.bfloat16).float()

    def scores(t0):
        s = qu.float() @ kk[..., t0:t0 + bn, :].float().transpose(-1, -2)
        for c0 in range(0, c, 64):
            s = s + qh[..., c0:c0 + 64].float() @ sh[t0:t0 + bn, c0:c0 + 64].t()
        return s

    return merge_heads(_tile_walk(scores, vv, bias, scale, bn))


@pytest.mark.parametrize("t_len", [128, 384, 1024])
def test_relpos_sm90_walk_matches_plain(t_len):
    """K4's depth-chunked S, the exp2 fold and the per-tile bf16 P, emulated
    on the CPU, against ``flash_relpos_attention_plain`` within
    chip_smoke.py's limit |got - want| <= 2^-7 |want| + 2^-7 P|v| + 1e-5.
    Rows: all keys valid; the last 29 keys padded at -1e9 (the conformer's
    pad bias); a single valid key. T = 384 is 3 key tiles."""
    rng = np.random.default_rng(200 + t_len)
    heads, c = 2, 256
    q_u, k, v = (rng.standard_normal((3, t_len, heads * 64)).astype(np.float32) * 0.5
                 for _ in range(3))
    q_hat = (rng.standard_normal((3, t_len, heads * c)) * 0.1).astype(np.float32)
    s_hat = rng.standard_normal((1, t_len, c)).astype(np.float32)
    bias = np.zeros((3, t_len), np.float32)
    bias[1, t_len - 29:] = -1.0e9
    bias[2, 1:] = -1.0e9
    q_u, q_hat, k, v = (t(x, torch.bfloat16) for x in (q_u, q_hat, k, v))
    args = (q_u, q_hat, k, t(s_hat), v, t(bias), heads, 0.125)
    got = _relpos_sm90_walk(*args).float()
    want = p_fa.flash_relpos_attention_plain(*args).float()
    p_abs_v = p_fa.flash_relpos_attention_plain(q_u, q_hat, k, t(s_hat), v.abs(), t(bias), heads,
                                                0.125).float()
    assert got.shape == want.shape == (3, t_len, heads * 64)
    limit = 2.0 ** -7 * (want.abs() + p_abs_v) + 1e-5
    assert bool(((got - want).abs() <= limit).all())


@pytest.mark.parametrize("t_len", [40, 128])
def test_relpos_attention_matches_jax_flash_and_dense_espnet(t_len, monkeypatch):
    """The port's rel-pos attention (K4 on the rope/sinusoid decomposition)
    equals the JAX main path (``rel_pos_attention_flash``, which zeroes
    pad-query rows) on every row, and the JAX dense ESPnet path -- (T, 2T-1)
    table and rel-shift, which leaves pad-query rows attending -- on every
    valid query row."""
    from chatterbox_tpu.models.s3gen import conformer as jc
    from chatterbox_tpu_torch.models.s3gen import conformer as pc
    from torch_parity import s3gen_params

    jp, pp = s3gen_params()
    jattn = jp["flow"]["encoder"]["encoders"][0]["attn"]
    pattn = pp["flow"]["encoder"]["encoders"][0]["attn"]
    rng = np.random.default_rng(t_len)
    x = rng.standard_normal((2, t_len, 128)).astype(np.float32)
    lens = np.asarray([t_len, t_len - 11])
    mask = np.arange(t_len)[None] < lens[:, None]
    got = pc.rel_pos_attention(pattn, t(x), 4, key_mask=t(mask))
    flash = jc.rel_pos_attention_flash(jattn, j(x), 4, key_mask=j(mask))
    assert_close(got, np.asarray(flash), 2e-5, 1e-5)
    monkeypatch.setattr(jc, "FLASH_ATTENTION", False)
    _, pos = jc.rel_pos_encoding(j(x), 128)
    dense = np.asarray(jc.rel_pos_attention(jattn, j(x), pos, 4, key_mask=j(mask)))
    for row, n in enumerate(lens):
        assert_close(got[row, :n], dense[row, :n], 2e-5, 1e-5)


def test_cpu_calls_do_not_count_launches():
    cache, q, kn, vn = _decode_case(0)
    reset_launch_counts()
    p_fd.flash_decode_layer_attention(t(cache), 0, 10, t(np.full(4, 10, np.int32)), 10,
                                      t(q), t(kn), t(vn))
    assert launch_counts() == {name: 0 for name in kernels()}
