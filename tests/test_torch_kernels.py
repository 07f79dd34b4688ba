"""The port's four kernels of the main path (K1-K4), held against the JAX
package's Pallas kernels (interpret mode on the CPU).

On the CPU each wrapper takes its plain PyTorch version, so these tests hold
the kernels' arithmetic; the CUDA kernels themselves are held against the
plain versions by ``test_torch_cuda.py`` (skips without a card) and by
``chip_smoke.py`` on the card. Everything runs in fp32 here, so the
tolerance is fp32 round-off over sums of a few hundred terms: 1e-5.
"""

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
