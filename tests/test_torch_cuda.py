"""Each CUDA kernel of the PyTorch port against its plain PyTorch version,
on the card, in its working dtype. Every test here needs an NVIDIA GPU and
skips without one.

This file imports neither JAX nor the JAX package, so it runs on the machine
with the card, without the repo's conftest (which sets up JAX):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

``chip_smoke.py`` makes the same comparisons at the main path's full-width
shapes and times them."""

import numpy as np
import pytest
import torch

from chatterbox_tpu_torch.ops import flash_attention as fa
from chatterbox_tpu_torch.ops import flash_decode as fd
from chatterbox_tpu_torch.ops import probes
from chatterbox_tpu_torch.probes import cache_write, int8_cache, ops

# bf16 (8 significant bits) limits, element by element, as in chip_smoke.py:
#     |got - want| <= 2^-7 |want| + 2^-7 (P|v|) + 1e-5
# One bf16 ulp (<= 2^-7 |want|) for the output, which both sides round once
# from fp32. K3 and K4 round the probabilities to bf16 before the value
# product (the kernel the unnormalised ones, the plain version the
# normalised ones), each by at most 2^-8 of itself: at most 2^-7 P|v| apart,
# with P|v| the plain version run on |v|. K1 keeps fp32 probabilities on
# both sides, so its limit has no such term. 1e-5 covers fp32 summation
# order.
OUT_RTOL = 2.0 ** -7
P_ROUND = 2.0 ** -7
FP32_ATOL = 1e-5


def _assert_within(got, want, p_abs_v=None):
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    limit = OUT_RTOL * want.abs() + FP32_ATOL
    if p_abs_v is not None:
        limit = limit + P_ROUND * p_abs_v.float()
    share = float(((got - want).abs() / limit).max())
    assert share <= 1.0, f"an element exceeds its limit by {share:.3f}x"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return torch.device("cuda")


def _randn(dev, *shape, seed, scale=1.0, dtype=torch.bfloat16):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(x).to(dev, dtype).contiguous()


def _max_err(got, want):
    torch.cuda.synchronize()
    return float((got.float() - want.float()).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_matches_plain(cuda, dtype):
    """16 rows x 16 heads of 64 over a 512-slot cache with a text-padding
    gap and a length that is not a multiple of the 128-slot tile. In fp32
    only the summation order differs (1e-5)."""
    cache = _randn(cuda, 4, 2, 16, 16, 512, 64, seed=0, dtype=dtype)
    q, kn, vn = (_randn(cuda, 16, 16, 64, seed=s, dtype=dtype) for s in (1, 2, 3))
    rp = torch.tensor([50 + 3 * i for i in range(16)], dtype=torch.int32, device=cuda)
    args = (cache, 2, 301, rp, 98, q, kn, vn)
    before = fd.flash_decode_layer_attention.launches
    got = fd.flash_decode_layer_attention(*args)
    assert fd.flash_decode_layer_attention.launches == before + 1
    want = fd.flash_decode_layer_attention_plain(*args)
    if dtype == torch.float32:
        assert _max_err(got, want) <= 1e-5
    else:
        _assert_within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_stats_matches_plain(cuda, dtype):
    """K1b: the output as K1a's. m is one scaled fp32 dot product of 64
    terms (1e-5 relative, 1e-5 absolute near 0); l sums ~250 positive fp32
    terms in another order, each off by m's error (n * 2^-24 = 1.5e-5
    relative, doubled and rounded up: 1e-4)."""
    cache = _randn(cuda, 4, 2, 16, 16, 512, 64, seed=20, dtype=dtype)
    q, kn, vn = (_randn(cuda, 16, 16, 64, seed=s, dtype=dtype) for s in (21, 22, 23))
    rp = torch.tensor([50 + 3 * i for i in range(16)], dtype=torch.int32, device=cuda)
    args = (cache, 1, 301, rp, 98, q, kn, vn)
    before = fd.flash_decode_layer_attention_stats.launches
    out, m, l = fd.flash_decode_layer_attention_stats(*args)
    assert fd.flash_decode_layer_attention_stats.launches == before + 1
    want_out, want_m, want_l = fd.flash_decode_layer_attention_stats_plain(*args)
    if dtype == torch.float32:
        assert _max_err(out, want_out) <= 1e-5
    else:
        _assert_within(out, want_out)
    assert float(((m - want_m).abs() / (1e-5 * want_m.abs() + 1e-5)).max()) <= 1.0
    assert float(((l - want_l).abs() / (1e-4 * want_l)).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cur_len", [301, 296])
def test_flash_decode_int8_matches_plain(cuda, dtype, cur_len):
    """K1c+d over a quantized cache with a gap, a tail of 5 slots or none,
    and poison in the int8 cache from merge_base on (never read)."""
    kv = _randn(cuda, 4, 2, 16, 16, 512, 64, seed=24, dtype=torch.float32)
    cache8, scales = fd.quantize_kv(kv)
    mb = cur_len // fd.TAIL_W * fd.TAIL_W
    tail = kv[:, :, :, :, mb:mb + fd.TAIL_W].to(dtype).contiguous()
    cache8[..., mb:, :], scales[..., mb:] = 127, 1e4
    q, kn, vn = (_randn(cuda, 16, 16, 64, seed=s, dtype=dtype) for s in (25, 26, 27))
    rp = torch.tensor([50 + 3 * i for i in range(16)], dtype=torch.int32, device=cuda)
    args = (cache8, scales, tail, mb, 2, cur_len, rp, 98, q, kn, vn)
    before = fd.flash_decode_layer_attention_int8.launches
    got = fd.flash_decode_layer_attention_int8(*args)
    assert fd.flash_decode_layer_attention_int8.launches == before + 1
    want = fd.flash_decode_layer_attention_int8_plain(*args)
    if dtype == torch.float32:
        assert _max_err(got, want) <= 1e-5
    else:
        _assert_within(got, want)


# K1's split-S edges (64-slot chunks) on a 512-slot cache, 16 rows x 16
# heads: (cur_len, gap_end, row_prefix of the 16 rows); every row_prefix is
# at most gap_end, as in T3
_SPLIT_CASES = {
    "chunk_in_gap": (301, 150, [10 + i for i in range(16)]),  # [64, 128) all gap
    "boundary_at_prefix_and_gap_end": (256, 128, [64] * 16),
    "below_one_chunk": (37, 37, [1 + 2 * i for i in range(16)]),
    "cur_len_at_s": (512, 100, [40 + 3 * i for i in range(16)]),
    "row_prefix_0": (200, 70, [0, 64] * 8),
}


def _split_inputs(dev, dtype, seed, cur_len, row_prefix):
    cache = _randn(dev, 3, 2, 16, 16, 512, 64, seed=seed, dtype=dtype)
    q, kn, vn = (_randn(dev, 16, 16, 64, seed=seed + i, dtype=dtype) for i in (1, 2, 3))
    rp = torch.tensor(row_prefix, dtype=torch.int32, device=dev)
    return cache, q, kn, vn, rp


def _assert_decode_close(got, want, dtype):
    if dtype == torch.float32:
        assert _max_err(got, want) <= 1e-5
    else:
        _assert_within(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", list(_SPLIT_CASES))
def test_flash_decode_split_edges_match_plain(cuda, dtype, case):
    """K1a and K1b where the 64-slot chunks meet the validity rule: a chunk
    wholly inside the text-padding gap, chunk boundaries at row_prefix and
    at gap_end, cur_len below one chunk and at S, rows with row_prefix 0."""
    cur_len, gap_end, row_prefix = _SPLIT_CASES[case]
    cache, q, kn, vn, rp = _split_inputs(cuda, dtype, 80, cur_len, row_prefix)
    args = (cache, 1, cur_len, rp, gap_end, q, kn, vn)
    _assert_decode_close(fd.flash_decode_layer_attention(*args),
                         fd.flash_decode_layer_attention_plain(*args), dtype)
    out, m, l = fd.flash_decode_layer_attention_stats(*args)
    want_out, want_m, want_l = fd.flash_decode_layer_attention_stats_plain(*args)
    _assert_decode_close(out, want_out, dtype)
    assert float(((m - want_m).abs() / (1e-5 * want_m.abs() + 1e-5)).max()) <= 1.0
    assert float(((l - want_l).abs() / (1e-4 * want_l)).max()) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cur_len,gap_end", [(128, 100), (135, 100), (511, 128), (71, 71)])
def test_flash_decode_int8_split_edges_match_plain(cuda, dtype, cur_len, gap_end):
    """K1c+d with merge_base on a chunk boundary (128: a tail of 0 and of 7
    slots), a tail of 7 in the last chunk of S, and a tail of 7 past one
    chunk; the int8 cache holds poison from merge_base on."""
    kv = _randn(cuda, 3, 2, 16, 16, 512, 64, seed=90, dtype=torch.float32)
    cache8, scales = fd.quantize_kv(kv)
    mb = cur_len // fd.TAIL_W * fd.TAIL_W
    tail = kv[:, :, :, :, mb:mb + fd.TAIL_W].to(dtype).contiguous()
    cache8[..., mb:, :], scales[..., mb:] = 127, 1e4
    q, kn, vn = (_randn(cuda, 16, 16, 64, seed=s, dtype=dtype) for s in (91, 92, 93))
    rp = torch.tensor([min(gap_end, 64 * (i % 3)) for i in range(16)], dtype=torch.int32,
                      device=cuda)
    args = (cache8, scales, tail, mb, 2, cur_len, rp, gap_end, q, kn, vn)
    _assert_decode_close(fd.flash_decode_layer_attention_int8(*args),
                         fd.flash_decode_layer_attention_int8_plain(*args), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["a", "b", "int8"])
def test_flash_decode_repeats_bit_identical_and_resets_tickets(cuda, variant):
    """The combine folds the chunks in order: two calls on the same inputs
    agree bit for bit. Calls on other inputs in between (another length,
    another layer) each match the plain version, which they would not if a
    launch left its tickets other than 0."""
    cache, q, kn, vn, rp = _split_inputs(cuda, torch.bfloat16, 95, 301, [50] * 16)
    kv = cache.float()
    cache8, scales = fd.quantize_kv(kv)

    def run(cur_len, layer, plain=False):
        if variant == "int8":
            mb = cur_len // fd.TAIL_W * fd.TAIL_W
            tail = cache[:, :, :, :, mb:mb + fd.TAIL_W].contiguous()
            fn = fd.flash_decode_layer_attention_int8_plain if plain else \
                fd.flash_decode_layer_attention_int8
            return fn(cache8, scales, tail, mb, layer, cur_len, rp, 98, q, kn, vn)
        fn = {"a": (fd.flash_decode_layer_attention, fd.flash_decode_layer_attention_plain),
              "b": (fd.flash_decode_layer_attention_stats,
                    fd.flash_decode_layer_attention_stats_plain)}[variant][plain]
        out = fn(cache, layer, cur_len, rp, 98, q, kn, vn)
        return out[0] if variant == "b" else out

    first = run(301, 1)
    for cur_len, layer in ((497, 2), (64, 0), (301, 1)):
        got = run(cur_len, layer)
        _assert_within(got, run(cur_len, layer, plain=True))
    torch.cuda.synchronize()
    assert torch.equal(first, got)


@pytest.mark.cuda
def test_flash_decode_graph_outlives_other_caches(cuda):
    """K1's workspace belongs to the cache it reads: a CUDA graph captured
    on one cache replays right after launches on a longer cache (a larger
    workspace, then freed) and on an int8 cache, and after allocations
    that could take freed memory."""
    cache, q, kn, vn, rp = _split_inputs(cuda, torch.bfloat16, 100, 301, [50] * 16)
    args = (cache, 1, fd.device_position(301, cuda), rp, 98, q, kn, vn)  # no upload captured
    first = fd.flash_decode_layer_attention(*args)  # outside the capture: makes the workspace
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fd.flash_decode_layer_attention(*args)
    longer = _randn(cuda, 2, 2, 16, 16, 4096, 64, seed=101)
    long_args = (longer, 1, 3000, rp, 98, q, kn, vn)
    _assert_within(fd.flash_decode_layer_attention(*long_args),
                   fd.flash_decode_layer_attention_plain(*long_args))
    cache8, scales = fd.quantize_kv(longer.float())
    tail = longer[:, :, :, :, 2000:2000 + fd.TAIL_W].contiguous()
    int8_args = (cache8, scales, tail, 2000, 0, 2005, rp, 98, q, kn, vn)
    _assert_within(fd.flash_decode_layer_attention_int8(*int8_args),
                   fd.flash_decode_layer_attention_int8_plain(*int8_args))
    del longer, cache8, scales, tail, long_args, int8_args
    # tensors of the graph's workspace sizes, which would take its memory
    # were it freed: the replay leaves them as they were
    n_parts, pairs = 16 * 16 * (512 // 64) * (64 + 2), 16 * 16
    junk = [torch.full((n,), 7, dtype=dt, device=cuda)
            for n, dt in ((n_parts, torch.float32), (pairs, torch.int32)) for _ in range(16)]
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, first)
    _assert_within(out, fd.flash_decode_layer_attention_plain(*args))
    assert all(bool((j == 7).all()) for j in junk)


@pytest.mark.cuda
def test_flash_decode_on_two_streams_at_once(cuda):
    """Two caches, each launched on its own stream with no order between
    the streams: each has its own workspace and tickets, so each matches
    its plain version."""
    runs = []
    for seed in (110, 120):
        cache, q, kn, vn, rp = _split_inputs(cuda, torch.bfloat16, seed, 480, [30] * 16)
        runs.append((cache, 2, 480, rp, 60, q, kn, vn))
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream() for _ in runs]
    outs = [[] for _ in runs]
    for _ in range(20):
        for args, stream, got in zip(runs, streams, outs):
            with torch.cuda.stream(stream):
                got.append(fd.flash_decode_layer_attention(*args))
    torch.cuda.synchronize()
    for args, got in zip(runs, outs):
        want = fd.flash_decode_layer_attention_plain(*args)
        for g in got:
            _assert_within(g, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,n,pos", [((4, 2, 16, 16), 8, 303), ((4, 2, 16, 16), 101, 100),
                                        ((3, 2, 5, 3), 1, 301), ((3, 2, 5, 3), 8, 23),
                                        ((3, 2, 5, 3), 100, 199), ((3, 2, 5, 3), 8, 13)])
def test_kv_cache_quantize_write_matches_plain(cuda, dtype, rows, n, pos):
    """K2b, bit for bit, ``pos`` the write slot of the last token: the
    8-token merge and a prefill of 101 tokens, with an all-zero (padding)
    token; n = 1, 8 and 100 over 90 rows (a token count that is no multiple
    of a warp's 16), n = 1 and 100 at slots that start off a multiple of 8;
    and a slot that closes no tail, which writes nothing."""
    src = _randn(cuda, *rows, n, 64, seed=28, scale=3.0, dtype=dtype)
    src[:, :, :, :, n // 2] = 0
    cache8 = torch.zeros(rows + (512, 64), dtype=torch.int8, device=cuda)
    scales = torch.ones(rows + (512,), device=cuda)
    a = (cache8.clone(), scales.clone())
    fd.kv_cache_quantize_write(*a, src, pos)
    b = fd.kv_cache_quantize_write_plain(cache8.clone(), scales.clone(), src, pos)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    if (pos + 1) % n:
        assert torch.equal(a[0], cache8) and torch.equal(a[1], scales)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,pos", [(8, 607), (100, 99)])
def test_kv_cache_quantize_write_full_width(cuda, dtype, n, pos):
    """K2b, bit for bit, at the main path's width (30 layers, 16 CFG rows,
    16 heads, S = 1152): a decode merge of the full 8-token tail, and the
    prefill of a 100-token prefix."""
    src = _randn(cuda, 30, 2, 16, 16, n, 64, seed=29, scale=2.0, dtype=dtype)
    cache8 = torch.zeros((30, 2, 16, 16, 1152, 64), dtype=torch.int8, device=cuda)
    scales = torch.ones((30, 2, 16, 16, 1152), device=cuda)
    a = (cache8.clone(), scales.clone())
    fd.kv_cache_quantize_write(*a, src, pos)
    b = fd.kv_cache_quantize_write_plain(cache8, scales, src, pos)
    torch.cuda.synchronize()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
def test_kv_cache_append_matches_plain(cuda):
    cache = _randn(cuda, 4, 2, 16, 16, 256, 64, seed=4)
    new = _randn(cuda, 4, 2, 16, 16, 64, seed=5)
    a, b = cache.clone(), cache.clone()
    fd.kv_cache_append(a, new, 130)
    fd.kv_cache_append_plain(b, new, 130)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_self_attention_packed_matches_plain(cuda):
    qkv = _randn(cuda, 4, 256, 3 * 8 * 64, seed=6)
    lens = torch.tensor([256, 200, 129, 3], device=cuda)
    bias = torch.where(torch.arange(256, device=cuda)[None] < lens[:, None], 0.0, -1.0e10)
    bias = bias.float().contiguous()
    got = fa.flash_self_attention_packed(qkv, bias, 8)
    qkv_abs_v = torch.cat([qkv[..., :1024], qkv[..., 1024:].abs()], dim=-1)
    _assert_within(got, fa.flash_self_attention_packed_plain(qkv, bias, 8),
                   fa.flash_self_attention_packed_plain(qkv_abs_v, bias, 8))


@pytest.mark.cuda
def test_flash_self_attention_matches_plain(cuda):
    """K5 on (B, H, T, D) operands with pad keys, as the UNet gives them."""
    q, k, v = (_randn(cuda, 4, 8, 256, 64, seed=s) for s in (15, 16, 17))
    lens = torch.tensor([256, 200, 129, 3], device=cuda)
    bias = torch.where(torch.arange(256, device=cuda)[None] < lens[:, None], 0.0, -1.0e10)
    bias = bias.float().contiguous()
    before = fa.flash_self_attention.launches
    got = fa.flash_self_attention(q, k, v, bias)
    assert fa.flash_self_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == torch.bfloat16
    _assert_within(got, fa.flash_self_attention_plain(q, k, v, bias),
                   fa.flash_self_attention_plain(q, k, v.abs(), bias))


def _self_attention_rows(dev, t, seed):
    """q, k, v (5, 8, t, 64) bf16 and the (5, t) f32 key bias of the K3/K5
    cases: row 0 a general finite bias, row 1 a single valid key, row 2
    valid keys only in the last 128-key tile, row 3 logits scaled x8 (its q
    x8: the running max moves and rescales O), row 4 every key masked (its
    plain result is the mean of v over all keys, so no tile may be
    skipped)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((5, 8, t, 64)).astype(np.float32) for _ in range(3))
    q[3] *= 8
    bias = np.zeros((5, t), np.float32)
    bias[0] = rng.standard_normal(t) * 2
    bias[1, 1:] = -1.0e10
    bias[2, :t - 91] = -1.0e10
    bias[4] = -1.0e10
    q, k, v = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in (q, k, v))
    return q, k, v, torch.from_numpy(bias).to(dev)


def _packed(q, k, v):
    """(B, H, T, D) q, k, v -> the (B, T, 3*H*D) to_qkv layout of K3."""
    return torch.cat([x.transpose(1, 2).flatten(2) for x in (q, k, v)], dim=-1).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 384, 1024, 2560])
def test_flash_self_attention_packed_rows_match_plain(cuda, t):
    """K3 on the rows of ``_self_attention_rows``; T = 384 is 3 key tiles,
    not a multiple of the 2- or 3-stage ring."""
    q, k, v, bias = _self_attention_rows(cuda, t, seed=40 + t)
    qkv = _packed(q, k, v)
    before = fa.flash_self_attention_packed.launches
    got = fa.flash_self_attention_packed(qkv, bias, 8)
    assert fa.flash_self_attention_packed.launches == before + 1
    assert got.shape == (5, t, 512) and got.dtype == torch.bfloat16
    _assert_within(got, fa.flash_self_attention_packed_plain(qkv, bias, 8),
                   fa.flash_self_attention_packed_plain(_packed(q, k, v.abs()), bias, 8))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 384, 1024, 2560])
def test_flash_self_attention_rows_match_plain(cuda, t):
    """K5 on the rows of ``_self_attention_rows``."""
    q, k, v, bias = _self_attention_rows(cuda, t, seed=50 + t)
    before = fa.flash_self_attention.launches
    got = fa.flash_self_attention(q, k, v, bias)
    assert fa.flash_self_attention.launches == before + 1
    _assert_within(got, fa.flash_self_attention_plain(q, k, v, bias),
                   fa.flash_self_attention_plain(q, k, v.abs(), bias))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 384, 1024, 2560])
def test_packed_and_heads_layouts_agree_bit_for_bit(cuda, t):
    """K3 and K5 run one kernel body: on the same q, k, v (packed against
    split) their outputs are equal."""
    q, k, v, bias = _self_attention_rows(cuda, t, seed=60 + t)
    packed = fa.flash_self_attention_packed(_packed(q, k, v), bias, 8)
    heads = fa.flash_self_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(heads.transpose(1, 2).flatten(2), packed)


@pytest.mark.cuda
def test_flash_relpos_matches_plain(cuda):
    q_u, k, v = (_randn(cuda, 2, 256, 8 * 64, seed=s, scale=0.5) for s in (7, 8, 9))
    q_hat = _randn(cuda, 2, 256, 8 * 512, seed=10, scale=0.1)
    s_hat = _randn(cuda, 1, 256, 512, seed=11, dtype=torch.float32)
    bias = torch.zeros((2, 256), device=cuda)
    bias[1, 200:] = -1.0e9
    args = (q_u, q_hat, k, s_hat, v, bias, 8, 0.125)
    got = fa.flash_relpos_attention(*args)
    _assert_within(got, fa.flash_relpos_attention_plain(*args),
                   fa.flash_relpos_attention_plain(q_u, q_hat, k, s_hat, v.abs(), bias, 8, 0.125))


def _relpos_rows(dev, t, seed, heads=8, c=512):
    """K4's operands at the conformer's widths (8 heads of 64, C = 512) on 4
    rows: row 0 all keys valid, row 1 the last 37 keys padded (bias -1e9, as
    the conformer pads), row 2 one valid key, row 3 logits x8 (the running
    max moves)."""
    rng = np.random.default_rng(seed)
    q_u, k, v = (rng.standard_normal((4, t, heads * 64)).astype(np.float32) * 0.5
                 for _ in range(3))
    q_u[3] *= 8
    q_hat = (rng.standard_normal((4, t, heads * c)) * 0.1).astype(np.float32)
    s_hat = rng.standard_normal((1, t, c)).astype(np.float32)
    bias = np.zeros((4, t), np.float32)
    bias[1, t - 37:] = -1.0e9
    bias[2, 1:] = -1.0e9
    bf = (torch.from_numpy(x).to(dev, torch.bfloat16) for x in (q_u, q_hat, k, v))
    q_u, q_hat, k, v = bf
    return q_u, q_hat, k, torch.from_numpy(s_hat).to(dev), v, torch.from_numpy(bias).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [128, 384, 1024, 2560])
def test_flash_relpos_rows_match_plain(cuda, t):
    """K4 on the rows of ``_relpos_rows``; T = 384 is 3 key tiles."""
    q_u, q_hat, k, s_hat, v, bias = _relpos_rows(cuda, t, seed=100 + t)
    args = (q_u, q_hat, k, s_hat, v, bias, 8, 0.125)
    before = fa.flash_relpos_attention.launches
    got = fa.flash_relpos_attention(*args)
    assert fa.flash_relpos_attention.launches == before + 1
    assert got.shape == (4, t, 512) and got.dtype == torch.bfloat16
    _assert_within(got, fa.flash_relpos_attention_plain(*args),
                   fa.flash_relpos_attention_plain(q_u, q_hat, k, s_hat, v.abs(), bias, 8, 0.125))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    qkv = _randn(cuda, 1, 100, 3 * 8 * 64, seed=12)  # T not a multiple of 64
    with pytest.raises(ValueError):
        fa.flash_self_attention_packed(qkv, torch.zeros((1, 100), device=cuda), 8)
    # K3 and K5 take 128-row tiles: a multiple of 64 that is not one of 128
    qkv = _randn(cuda, 1, 192, 3 * 8 * 64, seed=19)
    with pytest.raises(ValueError):
        fa.flash_self_attention_packed(qkv, torch.zeros((1, 192), device=cuda), 8)
    q = _randn(cuda, 1, 2, 192, 64, seed=20)
    with pytest.raises(ValueError):
        fa.flash_self_attention(q, q, q)
    q = _randn(cuda, 1, 2, 128, 32, seed=18)  # head dim 32
    with pytest.raises(ValueError):
        fa.flash_self_attention(q, q, q)
    # K4 takes 128-row tiles too
    q_u = _randn(cuda, 1, 192, 2 * 64, seed=21)
    q_hat = _randn(cuda, 1, 192, 2 * 128, seed=22)
    s_hat = _randn(cuda, 192, 128, seed=23)
    with pytest.raises(ValueError):
        fa.flash_relpos_attention(q_u, q_hat, q_u, s_hat, q_u, torch.zeros((1, 192), device=cuda),
                                  2, 0.125)
    cache = _randn(cuda, 1, 2, 2, 2, 128, 64, seed=13).transpose(-1, -2)  # not contiguous
    q = _randn(cuda, 2, 2, 64, seed=14)
    rp = torch.full((2,), 10, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        fd.flash_decode_layer_attention(cache, 0, 10, rp, 10, q, q, q)
    # K1 reads q, k_new and v_new in 16-byte vectors: a contiguous view at an
    # offset of one element is refused, for each of them and the int8 path too
    cache = cache.contiguous()
    odd = _randn(cuda, 2 * 2 * 64 + 1, seed=15)[1:].view(2, 2, 64)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    cache8, scales = fd.quantize_kv(cache.float())
    tail = cache[:, :, :, :, 8:8 + fd.TAIL_W].contiguous()
    for qkv in ((odd, q, q), (q, odd, q), (q, q, odd)):
        with pytest.raises(ValueError):
            fd.flash_decode_layer_attention(cache, 0, 10, rp, 10, *qkv)
        with pytest.raises(ValueError):
            fd.flash_decode_layer_attention_int8(cache8, scales, tail, 8, 0, 10, rp, 10, *qkv)
    # K2b reads src in 16-byte vectors: src at an offset of one element is
    # refused, and so is a head dim other than 64
    src = _randn(cuda, 1 * 2 * 2 * 2 * 8 * 64 + 1, seed=16)[1:].view(1, 2, 2, 2, 8, 64)
    assert src.is_contiguous() and src.data_ptr() % 16 != 0
    with pytest.raises(ValueError):
        fd.kv_cache_quantize_write(cache8, scales, src, 16)
    cache8_32 = torch.zeros((1, 2, 2, 2, 128, 32), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        fd.kv_cache_quantize_write(cache8_32, scales, _randn(cuda, 1, 2, 2, 2, 8, 32, seed=17), 16)
    # P4 reads k8, sc, q and t8 in 16-byte vectors: a contiguous k8 view at an
    # offset of one element is refused
    ins = int8_cache.inputs(cuda)
    odd8 = torch.zeros(64 * 128 + 1, dtype=torch.int8, device=cuda)[1:].view(64, 128)
    odd8.copy_(ins[0])
    assert odd8.is_contiguous() and odd8.data_ptr() % 16 != 0
    for case in probes.INT8_CASES:
        with pytest.raises(ValueError):
            probes.int8_probe(case, odd8, *ins[1:])


@pytest.mark.cuda
def test_noop_copy_matches_plain(cuda):
    """P1 bit for bit on the probe's (16, 16, 64), one 16-byte vector and
    two shapes that leave the last block part full, its counter moving by
    one a call; then ordered after what writes q (a kernel, a memcpy), eager
    and in a captured and replayed CUDA graph with two copies back to back:
    the kernel is launched with programmatic dependent launch, and must
    still see every earlier write."""
    for i, shape in enumerate(((16, 16, 64), (8,), (3, 5, 8), (3, 5, 72))):
        q = _randn(cuda, *shape, seed=30 + i)
        before = probes.noop_copy.launches
        got = probes.noop_copy(q)
        assert probes.noop_copy.launches == before + 1
        torch.cuda.synchronize()
        assert torch.equal(got, q) and got.data_ptr() != q.data_ptr(), shape
    src = _randn(cuda, 16, 16, 64, seed=34)
    q = src.clone()
    q.mul_(2)
    got = probes.noop_copy(q)
    torch.cuda.synchronize()
    assert torch.equal(got, src * 2)
    graph = torch.cuda.CUDAGraph()
    before = probes.noop_copy.launches
    with torch.cuda.graph(graph):
        q.copy_(src)
        q.mul_(2)
        a = probes.noop_copy(q)
        b = probes.noop_copy(a)
    assert probes.noop_copy.launches == before + 2
    for _ in range(3):
        src.add_(1)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, src * 2) and torch.equal(b, src * 2)


# the probes' widths with fewer layers; 1440 lines, which leave the last
# block of 256 threads part idle (B 16, so that every variant's b_blk divides
# it, makes every line count a multiple of 32)
VARIANT_SHAPES = ((3, 2, 16, 16, 64, 384), (3, 2, 16, 3, 5, 128))


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(cache_write.VARIANTS), ids=" ".join)
def test_cache_writes_match_plain(cuda, key):
    """P2/P3: every variant bit for bit against the slice assignment on each
    of ``VARIANT_SHAPES``, at slots 0, 7 (not 8-aligned), 263 where S allows
    and S - 1, with ``new`` aligned and one value past an aligned start, and
    its wrapper's launch counter moving by one a call."""
    variant = cache_write.VARIANTS[key]
    wrapper = probes.cache_column_write if variant["kind"] == "col" else probes.cache_block_rmw
    for i, shape in enumerate(VARIANT_SHAPES):
        s = shape[-1]
        cache = _randn(cuda, *shape, seed=31 + i)
        n = cache[..., 0].numel()
        for new in (_randn(cuda, *shape[:5], 1, seed=41 + i),
                    _randn(cuda, n + 1, seed=51 + i)[1:].view(*shape[:5], 1)):
            for pos in (p for p in (0, 7, 263, s - 1) if p < s):
                want = probes.cache_column_write_plain(cache.clone(), new, pos)
                before = wrapper.launches
                got = cache_write.write(cache.clone(), new, pos, variant)
                assert wrapper.launches == before + 1
                torch.cuda.synchronize()
                assert torch.equal(got, want), (shape, new.data_ptr() % 16, pos)


@pytest.mark.cuda
def test_int8_and_softmax_probes_match_plain(cuda):
    """P4 (the store and the convert exact, the sums within (n + 2) 2^-24
    sum|terms|) on the probe's inputs and on ``int8_cache.wide_inputs`` (the
    whole int8 range, signed scales: the store truncates on both signs);
    P5 (within the limit of ``probes.ops.limit``) on the probes' inputs."""
    for ins in (int8_cache.inputs(cuda), int8_cache.wide_inputs(cuda)):
        for case in probes.INT8_CASES:
            got, want = probes.int8_probe(case, *ins), probes.int8_probe_plain(case, *ins)
            torch.cuda.synchronize()
            lim, _ = int8_cache.limit(case, ins)
            assert torch.equal(got, want) if lim is None else \
                bool(((got - want).abs() <= lim).all()), case
    x, v = ops.inputs(cuda)
    scr0 = torch.zeros((1, 64), device=cuda)
    for case in probes.SOFTMAX_CASES:
        got, want = probes.softmax_probe(case, x, v, scr0), probes.softmax_probe_plain(case, x, v,
                                                                                      scr0)
        torch.cuda.synchronize()
        lim, _ = ops.limit(case, x, v, scr0)
        assert bool(((got - want).abs() <= lim).all()), case


@pytest.mark.cuda
@pytest.mark.parametrize("case", probes.INT8_CASES)
def test_int8_probe_graph_after_writes(cuda, case):
    """P4 launches with programmatic dependent launch: captured in a CUDA
    graph after a memcpy and a kernel that write k8 and sc, then replayed on
    new values, it must see both writes (the convert and the store bit for
    bit, the sums within ``int8_cache.limit``); its counter moves by one a
    call, eager and in the capture."""
    ins = int8_cache.inputs(cuda)
    k8, sc, q, t8 = (x.clone() for x in ins)
    before = probes.int8_probe.launches
    probes.int8_probe(case, k8, sc, q, t8)
    assert probes.int8_probe.launches == before + 1
    k8_src, sc_src = ins[0].clone(), ins[1].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        k8.copy_(k8_src)
        sc.copy_(sc_src)
        k8.neg_()
        sc.mul_(-2.0)
        got = probes.int8_probe(case, k8, sc, q, t8)
    assert probes.int8_probe.launches == before + 2
    for step in range(3):
        k8_src.copy_(torch.roll(ins[0], step, 1))
        sc_src.copy_(torch.roll(ins[1], step, 1))
        graph.replay()
        torch.cuda.synchronize()
        want = probes.int8_probe_plain(case, -k8_src, sc_src * -2.0, q, t8)
        lim, _ = int8_cache.limit(case, (-k8_src, sc_src * -2.0, q, t8))
        assert torch.equal(got, want) if lim is None else \
            bool(((got - want).abs() <= lim).all()), (case, step)


@pytest.mark.cuda
@pytest.mark.parametrize("case", probes.SOFTMAX_CASES)
def test_softmax_probe_scratches_and_graph(cuda, case):
    """P5 within ``probes.ops.limit`` from a seeded random scratch and, for
    H, from one holding a NaN, which must propagate as in the plain version
    (the kernel applies H's update twice: only these scratches check that on
    the card; the random one is on the scale of H's largest score, ~15.6, so
    that H's result depends on it); its counter moves by one a call. Then
    the same call captured in a CUDA graph after a memcpy and a kernel that
    write x, replayed."""
    x, v = ops.inputs(cuda)
    scr = _randn(cuda, 1, 64, seed=36, scale=16.0, dtype=torch.float32)
    scrs = [scr]
    if case.startswith("H"):
        nan = scr.clone()
        nan[0, 5] = float("nan")
        scrs.append(nan)
    for scr0 in scrs:
        before = probes.softmax_probe.launches
        got = probes.softmax_probe(case, x, v, scr0)
        assert probes.softmax_probe.launches == before + 1
        want = probes.softmax_probe_plain(case, x, v, scr0)
        lim, _ = ops.limit(case, x, v, scr0)
        torch.cuda.synchronize()
        nan_want = want.isnan()
        assert torch.equal(got.isnan(), nan_want), case
        assert bool(((got - want).abs() <= lim)[~nan_want].all()), case
    x0 = x.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        x.copy_(x0)
        x.mul_(2)
        got = probes.softmax_probe(case, x, v, scr)
    graph.replay()
    torch.cuda.synchronize()
    want = probes.softmax_probe_plain(case, x, v, scr)
    lim, _ = ops.limit(case, x, v, scr)
    assert torch.equal(x, x0 * 2)
    assert bool(((got - want).abs() <= lim).all()), case


@pytest.mark.cuda
def test_wmat_int8_on_the_card_matches_the_cpu(cuda):
    """_wmat with int8 weights on the card against the CPU. In fp32 (TF32
    off) within 1e-5 A, A = sum |terms| of each output (fp32 round-off of a
    1024-term sum in another order: 1024 * 2^-24 = 6e-5 at worst, ~1e-6 in
    practice). In bf16 within 2^-7 |want| + 2^-8 A: the input's rounding to
    bf16 moves a sum by at most 2^-9 A, and the product's output, the
    scale and the scaled output each round once to bf16 (2^-9 |want|
    each)."""
    from chatterbox_tpu_torch.models.t3 import llama

    w = _randn(cuda, 2, 3072, 1024, seed=33, scale=0.02, dtype=torch.float32)
    wq = llama.quantize_llama_weights({"layers": {"qkv": {"w": w}}})["layers"]["qkv"]
    wp = {k: v[1] for k, v in wq.items()}
    y = _randn(cuda, 16, 1, 1024, seed=34, dtype=torch.float32)
    wp_cpu = {k: v.cpu() for k, v in wp.items()}
    want = llama._wmat(y.cpu(), wp_cpu)
    a = llama._wmat(y.cpu().abs(), {"w8": wp_cpu["w8"].abs(), "scale": wp_cpu["scale"]})
    got = llama._wmat(y, wp).cpu()
    assert bool(((got - want).abs() <= 1e-5 * a).all())
    got16 = llama._wmat(y.to(torch.bfloat16), wp).float().cpu()
    assert bool(((got16 - want).abs() <= 2.0 ** -7 * want.abs() + 2.0 ** -8 * a).all())


@pytest.mark.cuda
def test_kaiser_resample_and_ve_embed_from_wavs_on_the_card_match_the_cpu(cuda):
    """resample(quality="kaiser_fast") 44.1 kHz -> 16 kHz and
    ve_embed_from_wavs of a 24 kHz voice (full-width VoiceEncoderConfig,
    random weights) on the card against the CPU, in fp32 with TF32 off:
    the resample within 1e-5 (fp32 sums of 2 * 16 * 44100 / 16000 ~ 88
    terms in another order) and the embeddings within 1e-4, the bound of the
    conditioning path's card-against-CPU checks."""
    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.core.resample import resample
    from chatterbox_tpu_torch.device import full_fp32
    from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig, ve_embed_from_wavs
    from chatterbox_tpu_torch.pipeline.audio import synthetic_voice

    wav = torch.from_numpy(synthetic_voice(0, 3.0, 44100))
    want = resample(wav, 44100, 16000, quality="kaiser_fast")
    with full_fp32():
        got = resample(wav.to(cuda), 44100, 16000, quality="kaiser_fast").cpu()
    assert float((got - want).abs().max()) <= 1e-5
    cfg = VoiceEncoderConfig()
    p_cpu = weights.init_voice_encoder(cfg, seed=5)
    voice = synthetic_voice(1, 3.0, 24000)
    want = ve_embed_from_wavs(p_cpu, cfg, voice, 24000)
    got = ve_embed_from_wavs(weights.tree_to(p_cpu, cuda), cfg, voice, 24000)
    assert got.device.type == "cuda" and tuple(got.shape) == (1, 256)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
