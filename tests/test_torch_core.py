"""The port's core ops (layers, sampling chain, STFT/iSTFT, watermark),
held against ``chatterbox_tpu/core`` on the same inputs (CPU, fp32)."""

import numpy as np
import pytest

from torch_parity import assert_close, j, t

from chatterbox_tpu.core import dsp as jd
from chatterbox_tpu.core import layers as jl
from chatterbox_tpu.core import sampling as js
from chatterbox_tpu_torch.core import dsp as pd
from chatterbox_tpu_torch.core import layers as pl
from chatterbox_tpu_torch.core import sampling as ps

RNG = np.random.default_rng(0)


def _r(*shape, scale=1.0):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _conv_params(w, cin, cout):
    """JAX conv params (W, Cin, Cout) and the port's (Cout, Cin, W)."""
    wj, b = _r(w, cin, cout, scale=0.3), _r(cout)
    return {"w": j(wj), "b": j(b)}, {"w": t(wj.transpose(2, 1, 0)), "b": t(b)}


def test_linear_embedding_norms():
    x = _r(2, 5, 8)
    w, b = _r(8, 6), _r(6)
    assert_close(pl.linear({"w": t(w.T), "b": t(b)}, t(x)),
                 jl.linear({"w": j(w), "b": j(b)}, j(x)), 1e-6, 1e-6)
    table, ids = _r(11, 4), np.array([[0, 3, 10], [5, 5, 1]])
    assert_close(pl.embedding({"w": t(table)}, t(ids)), jl.embedding({"w": j(table)}, j(ids)), 0)
    norm = {"scale": _r(8), "bias": _r(8)}
    tn, jn = {k: t(v) for k, v in norm.items()}, {k: j(v) for k, v in norm.items()}
    assert_close(pl.layer_norm(tn, t(x)), jl.layer_norm(jn, j(x)), 1e-5, 1e-5)
    assert_close(pl.layer_norm(tn, t(x), 1e-12), jl.layer_norm(jn, j(x), 1e-12), 1e-5, 1e-5)
    assert_close(pl.rms_norm({"scale": t(norm["scale"])}, t(x)),
                 jl.rms_norm({"scale": j(norm["scale"])}, j(x)), 1e-6, 1e-5)
    assert_close(pl.group_norm(tn, t(x), 2), jl.group_norm(jn, j(x), 2), 1e-5, 1e-5)


@pytest.mark.parametrize("kw", [
    dict(padding=1), dict(padding=(0, 3)), dict(padding=(2, 0), dilation=3),
    dict(stride=2, padding=1), dict(padding=0),
])
def test_conv1d(kw):
    x = _r(2, 17, 6)
    jp, pp = _conv_params(3, 6, 5)
    assert_close(pl.conv1d(pp, t(x), **kw), jl.conv1d(jp, j(x), **kw), 1e-5, 1e-5)


def test_causal_and_transposed_conv():
    x = _r(2, 9, 4)
    jp, pp = _conv_params(3, 4, 4)
    assert_close(pl.causal_conv1d(pp, t(x)), jl.causal_conv1d(jp, j(x)), 1e-5, 1e-5)
    wj, b = _r(7, 4, 3, scale=0.3), _r(3)  # (W, Cin, Cout)
    jt = {"w": j(wj), "b": j(b)}
    pt = {"w": t(wj.transpose(1, 2, 0)), "b": t(b)}  # (Cin, Cout, W)
    for stride, pad in ((3, 2), (5, 0)):
        assert_close(pl.conv_transpose1d(pt, t(x), stride, pad),
                     jl.conv_transpose1d(jt, j(x), stride, pad), 1e-5, 1e-5)


def test_activations():
    x = _r(2, 50, 6, scale=4.0)
    alpha = np.abs(_r(6)) + 0.2
    assert_close(pl.snake({"alpha": t(alpha)}, t(x)), jl.snake({"alpha": j(alpha)}, j(x)), 1e-5, 1e-5)
    assert_close(pl.snake_fast({"alpha": t(alpha)}, t(x)),
                 jl.snake_fast({"alpha": j(alpha)}, j(x)), 1e-5, 1e-5)
    # the polynomial is a 133 dB approximation of the exact form
    assert_close(pl.snake_fast({"alpha": t(alpha)}, t(x)), pl.snake({"alpha": t(alpha)}, t(x)), 1e-4)
    assert_close(pl.mish(t(x)), jl.mish(j(x)), 1e-5, 1e-5)
    assert_close(pl.leaky_relu(t(x), 0.01), jl.leaky_relu(j(x), 0.01), 0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _logits_case(seed, b=4, v=300):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    seen = rng.random((b, v)) < 0.1
    return logits, seen


@pytest.mark.parametrize("cfg", [
    js.SamplingConfig(),
    js.SamplingConfig(temperature=1.3, top_p=0.9, min_p=0.0, repetition_penalty=1.5),
    js.SamplingConfig(temperature=0.6, top_p=0.5, min_p=0.2, repetition_penalty=1.0),
    js.SamplingConfig(temperature=1.0, top_p=1.0, min_p=0.0, repetition_penalty=1.0),
])
def test_process_logits_and_sample(cfg):
    logits, seen = _logits_case(hash(cfg) % 1000)
    pcfg = ps.SamplingConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
    want = np.asarray(js.process_logits(j(logits), j(seen), cfg))
    got = ps.process_logits(t(logits), t(seen), pcfg)
    np.testing.assert_array_equal(got.numpy() == np.finfo(np.float32).min,
                                  want == np.finfo(np.float32).min)
    assert_close(got, want, 1e-5, 1e-6)
    u = np.random.default_rng(1).random(4).astype(np.float32)
    np.testing.assert_array_equal(ps.sample_from_logits(got, t(u)).numpy(),
                                  np.asarray(js.sample_from_logits(j(want), j(u))))


def test_sample_from_logits_edges():
    """u scales by the cumsum total: u -> 1 still lands on the last kept
    token and a small u on the first kept token."""
    logits = np.full((3, 10), np.finfo(np.float32).min, np.float32)
    logits[:, [2, 5, 7]] = [[0.0, 1.0, 2.0]] * 3
    u = np.array([1e-7, 0.5, 1.0 - 1e-7], np.float32)
    got = ps.sample_from_logits(t(logits), t(u)).numpy()
    np.testing.assert_array_equal(got, np.asarray(js.sample_from_logits(j(logits), j(u))))
    assert got[0] == 2 and got[2] == 7


def test_cfg_combine():
    a, b = _r(2, 30), _r(2, 30)
    assert_close(ps.cfg_combine(t(a), t(b), 0.5), js.cfg_combine(j(a), j(b), 0.5), 1e-6)


# ---------------------------------------------------------------------------
# dsp and the watermark
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_fft,hop,n", [(16, 4, 480), (512, 128, 3840)])
def test_stft_istft(n_fft, hop, n):
    x = _r(2, n, scale=0.3)
    win = jd.hann_window(n_fft)
    np.testing.assert_array_equal(pd.hann_window(n_fft), win)
    pr, pi = pd.stft(t(x), n_fft, hop, win)
    jr, ji = jd.stft(j(x), n_fft, hop, win)
    assert_close(pr, jr, 2e-5, 1e-5)
    assert_close(pi, ji, 2e-5, 1e-5)
    y_p = pd.istft(pr, pi, n_fft, hop, win)
    y_j = jd.istft(jr, ji, n_fft, hop, win)
    assert_close(y_p, y_j, 2e-5, 1e-5)
    assert_close(y_p, x, 1e-4)  # perfect reconstruction


def test_spread_spectrum_watermark_matches_jax():
    from chatterbox_tpu.models.watermark import SpreadSpectrumWatermarker as JW
    from chatterbox_tpu_torch.models.watermark import SpreadSpectrumWatermarker as PW

    wav = _r(2, 24000 - 37, scale=0.2)
    jw, pw = JW(), PW()
    np.testing.assert_array_equal(pw.band_pattern(), jw.band_pattern())
    want = jw.apply_in_graph(j(wav), j(jw.band_pattern()))
    got = pw.apply(t(wav))
    assert got.shape == wav.shape
    assert_close(got, want, 2e-5, 1e-5)
    payload = np.random.default_rng(3).integers(0, 2, 16)
    marked = pw.apply_watermark(wav[0], payload)
    assert_close(marked, jw.apply_watermark(wav[0], payload), 2e-5, 1e-5)
    np.testing.assert_array_equal(pw.get_payload(marked), jw.get_payload(marked))
