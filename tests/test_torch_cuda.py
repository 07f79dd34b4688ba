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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,pos", [(8, 296), (101, 0)])
def test_kv_cache_quantize_write_matches_plain(cuda, dtype, n, pos):
    """K2b, bit for bit: the 8-token merge and a prefill of 101 tokens,
    with an all-zero (padding) token."""
    src = _randn(cuda, 4, 2, 16, 16, n, 64, seed=28, scale=3.0, dtype=dtype)
    src[:, :, :, :, n // 2] = 0
    cache8 = torch.zeros((4, 2, 16, 16, 512, 64), dtype=torch.int8, device=cuda)
    scales = torch.ones((4, 2, 16, 16, 512), device=cuda)
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


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    qkv = _randn(cuda, 1, 100, 3 * 8 * 64, seed=12)  # T not a multiple of 64
    with pytest.raises(ValueError):
        fa.flash_self_attention_packed(qkv, torch.zeros((1, 100), device=cuda), 8)
    q = _randn(cuda, 1, 2, 128, 32, seed=18)  # head dim 32
    with pytest.raises(ValueError):
        fa.flash_self_attention(q, q, q)
    cache = _randn(cuda, 1, 2, 2, 2, 128, 64, seed=13).transpose(-1, -2)  # not contiguous
    q = _randn(cuda, 2, 2, 64, seed=14)
    with pytest.raises(ValueError):
        fd.flash_decode_layer_attention(cache, 0, 10, torch.full((2,), 10, dtype=torch.int32,
                                                                 device=cuda), 10, q, q, q)


@pytest.mark.cuda
def test_noop_copy_matches_plain(cuda):
    q = _randn(cuda, 16, 16, 64, seed=30)
    before = probes.noop_copy.launches
    got = probes.noop_copy(q)
    assert probes.noop_copy.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, q) and got.data_ptr() != q.data_ptr()


@pytest.mark.cuda
@pytest.mark.parametrize("key", list(cache_write.VARIANTS), ids=" ".join)
def test_cache_writes_match_plain(cuda, key):
    """P2/P3: every variant bit for bit against the slice assignment, at the
    probes' widths with fewer layers and a slot inside the third segment."""
    cache = _randn(cuda, 3, 2, 16, 16, 64, 384, seed=31)
    new = _randn(cuda, 3, 2, 16, 16, 64, 1, seed=32)
    want = probes.cache_column_write_plain(cache.clone(), new, 263)
    got = cache_write.write(cache.clone(), new, 263, cache_write.VARIANTS[key])
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_int8_and_softmax_probes_match_plain(cuda):
    """P4 (the store and the convert exact, the sums within (n + 2) 2^-24
    sum|terms|) and P5 (within the limit of ``probes.ops.limit``) on the
    probes' inputs."""
    ins = int8_cache.inputs(cuda)
    for case in probes.INT8_CASES:
        got, want = probes.int8_probe(case, *ins), probes.int8_probe_plain(case, *ins)
        torch.cuda.synchronize()
        lim, _ = int8_cache.limit(case, ins)
        assert torch.equal(got, want) if lim is None else bool(((got - want).abs() <= lim).all())
    x, v = ops.inputs(cuda)
    scr0 = torch.zeros((1, 64), device=cuda)
    for case in probes.SOFTMAX_CASES:
        got, want = probes.softmax_probe(case, x, v, scr0), probes.softmax_probe_plain(case, x, v,
                                                                                      scr0)
        torch.cuda.synchronize()
        lim, _ = ops.limit(case, x, v, scr0)
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
