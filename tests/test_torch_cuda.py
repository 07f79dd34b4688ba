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
