"""The capabilities the port took over from the JAX package's public
surface, each held against its JAX function on the same numpy inputs (CPU,
fp32): the Kaiser resampling designs, voice embeddings from wavs at any
rate, the converters that find their own prefix and config, ``load_params``,
``EnTokenizer.text_to_tokens`` and the helper parameters of ``core/dsp``,
``core/layers``, the conformer's positional encoding and ``quantize_kv``."""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_checkpoint import assert_same_tree
from torch_parity import J_VE, P_VE, assert_close, cond_params, j, t

from chatterbox_tpu.checkpoint import pytree_io as j_io
from chatterbox_tpu.core import dsp as jd
from chatterbox_tpu.core import layers as jl
from chatterbox_tpu.core import resample as j_rs
from chatterbox_tpu.models import s3tokenizer as j_s3tok
from chatterbox_tpu.models import voice_encoder as j_ve
from chatterbox_tpu.models import watermark as j_wm
from chatterbox_tpu.models.s3gen import conformer as j_conf
from chatterbox_tpu.models.t3 import llama as j_llama
from chatterbox_tpu_torch.checkpoint import pytree_io as p_io
from chatterbox_tpu_torch.core import dsp as pd
from chatterbox_tpu_torch.core import layers as pl
from chatterbox_tpu_torch.core import resample as p_rs
from chatterbox_tpu_torch.models import s3tokenizer as p_s3tok
from chatterbox_tpu_torch.models import voice_encoder as p_ve
from chatterbox_tpu_torch.models import watermark as p_wm
from chatterbox_tpu_torch.models.s3gen import conformer as p_conf
from chatterbox_tpu_torch.ops import flash_decode as p_fd
from chatterbox_tpu_torch.pipeline.audio import synthetic_voice

QUALITIES = ("hann", "kaiser_fast", "kaiser_best")
RATES = ((24000, 16000), (44100, 16000), (22050, 16000), (16000, 24000))
_KAISER = {"kaiser_fast": (16, 0.85, 8.555504641634386),
           "kaiser_best": (64, 0.9475, 14.769656459379492)}


# ---------------------------------------------------------------------------
# resample
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rates", RATES, ids=lambda r: f"{r[0]}to{r[1]}")
@pytest.mark.parametrize("quality", QUALITIES)
def test_resample_matches_jax(quality, rates):
    orig, new = rates
    rng = np.random.default_rng(11)
    n = orig // 8
    noise = rng.uniform(-1.0, 1.0, (2, n)).astype(np.float32)
    tone = np.sin(2 * np.pi * 440.0 * np.arange(n) / orig).astype(np.float32)
    for x in (noise, tone):
        got = p_rs.resample(t(x), orig, new, quality)
        want = np.asarray(j_rs.resample(j(x), orig, new, quality))
        assert got.shape == want.shape and got.dtype == torch.float32
        assert_close(got, want, 1e-5, msg=f"{quality} {orig}->{new}")


@pytest.mark.parametrize("rates", ((24000, 16000), (16000, 24000)),
                         ids=lambda r: f"{r[0]}to{r[1]}")
@pytest.mark.parametrize("quality", ("kaiser_fast", "kaiser_best"))
def test_kaiser_taps_match_the_resampy_formula(quality, rates):
    """y[n] = sum_k x[k] s sinc(t) kaiser(t / (N r)), t = (k/orig - n/new)
    min(orig, new) r, s = min(orig, new) r / orig, zero where |t| >= N r:
    resampy's continuous filter (num_zeros N, rolloff r, beta), evaluated
    in float64 tap by tap. Where |t| == N r exactly (decided here in
    integers), the window is not zero and the kernel's float64 t falls on
    either side of the edge, so those taps bound the difference too."""
    orig, new = rates
    n_zeros, roll, beta = _KAISER[quality]
    rng = np.random.default_rng(3)
    x = rng.standard_normal(240)
    n_out = int(np.ceil(len(x) * new / orig))
    k, n = np.arange(len(x))[None, :], np.arange(n_out)[:, None]
    tt = (k / orig - n / new) * min(orig, new) * roll
    reach = np.abs(k * new - n * orig) * min(orig, new)  # |t| (orig new) / r, exactly
    limit = n_zeros * orig * new
    win = np.i0(beta * np.sqrt(np.maximum(1.0 - (tt / (n_zeros * roll)) ** 2, 0.0))) / np.i0(beta)
    taps = np.sinc(tt) * win * min(orig, new) * roll / orig
    want = np.where(reach < limit, taps, 0.0) @ x
    edge = np.abs(np.where(reach == limit, taps, 0.0)) @ np.abs(x)
    got = p_rs.resample(t(x.astype(np.float32)), orig, new, quality).numpy()
    excess = np.abs(got - want) - (2e-5 + edge)
    assert excess.max() <= 0, f"{excess.max()} over 2e-5 and the edge taps"


def test_resample_rejects_an_unknown_quality():
    x = np.zeros(100, np.float32)
    with pytest.raises(ValueError, match="unknown resample quality"):
        j_rs.resample(j(x), 24000, 16000, "soxr_hq")
    with pytest.raises(ValueError, match="unknown resample quality"):
        p_rs.resample(t(x), 24000, 16000, "soxr_hq")


# ---------------------------------------------------------------------------
# voice embeddings from wavs
# ---------------------------------------------------------------------------


def _ve_params():
    jp, pp = cond_params()
    return jp["ve"], pp["ve"]


@pytest.mark.parametrize("trim", (20.0, 0), ids=("trim", "whole"))
@pytest.mark.parametrize("sr", (16000, 24000, 44100))
def test_ve_embed_from_wavs_matches_jax(sr, trim):
    jp, pp = _ve_params()
    wav = synthetic_voice(4, 1.2, sr)  # 0.2 s of near-silence at each end
    got = p_ve.ve_embed_from_wavs(pp, P_VE, wav, sr, trim_top_db=trim)
    want = np.asarray(j_ve.ve_embed_from_wavs(jp, J_VE, wav, sr, trim_top_db=trim))
    assert tuple(got.shape) == (1, P_VE.speaker_embed_size) and got.device == pp["proj"]["w"].device
    assert_close(got, want, 1e-4)


def test_ve_embed_from_wavs_list_matches_jax():
    jp, pp = _ve_params()
    wavs = [synthetic_voice(5, 1.2, 24000), synthetic_voice(6, 0.9, 24000)]
    got = p_ve.ve_embed_from_wavs(pp, P_VE, wavs, 24000)
    want = np.asarray(j_ve.ve_embed_from_wavs(jp, J_VE, wavs, 24000))
    assert_close(got, want, 1e-4)
    one = p_ve.ve_embed_from_wavs(pp, P_VE, wavs[0], 24000)
    np.testing.assert_array_equal(one.numpy(), got[:1].numpy())


def test_ve_embed_utterance_matches_jax():
    jp, pp = _ve_params()
    wav = np.stack([synthetic_voice(7, 1.0, 16000), synthetic_voice(8, 1.0, 16000)])
    assert_close(p_ve.ve_embed_utterance(pp, P_VE, t(wav)),
                 j_ve.ve_embed_utterance(jp, J_VE, j(wav)), 1e-4)


# ---------------------------------------------------------------------------
# converters
# ---------------------------------------------------------------------------


def _s3tok_sd(seed=2):
    from torch_s3tok_ref import S3TokenizerV2Ref

    torch.manual_seed(seed)
    m = S3TokenizerV2Ref(n_mels=16, n_state=64, n_head=4, n_layer=2, kernel_size=7)
    return dict(m.eval().state_dict())


@pytest.mark.parametrize("prefix", ("", "tokenizer."), ids=("bare", "nested"))
def test_convert_s3tokenizer_finds_prefix_and_config(prefix):
    sd = {prefix + k: v for k, v in _s3tok_sd().items()}
    if prefix:
        sd["flow.input_embedding.weight"] = torch.zeros(3, 4)  # the rest of an s3gen dict
    assert p_s3tok.detect_s3tok_prefix(sd) == j_s3tok.detect_s3tok_prefix(sd) == prefix
    pcfg = p_s3tok.s3tok_config_from_sd(sd)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(j_s3tok.s3tok_config_from_sd(sd))
    assert p_s3tok.s3tok_config_from_sd(sd, n_head=4).n_head == 4
    (pp, pc), (jp, jc) = p_s3tok.convert_s3tokenizer(sd), j_s3tok.convert_s3tokenizer(sd)
    assert dataclasses.asdict(pc) == dataclasses.asdict(jc) == dataclasses.asdict(pcfg)
    assert_same_tree(pp, jp)
    # an explicit config still returns the tree alone, as in the JAX package
    assert_same_tree(p_s3tok.convert_s3tokenizer(sd, pcfg, prefix), jp)


def test_s3tokenizer_converters_raise_on_two_anchors():
    sd = _s3tok_sd()
    two = {**sd, **{"tokenizer." + k: v for k, v in sd.items()}}
    for m in (p_s3tok, j_s3tok):
        with pytest.raises(KeyError, match="exactly one"):
            m.detect_s3tok_prefix(two)
        with pytest.raises(KeyError, match="exactly one"):
            m.convert_s3tokenizer(two)


def test_s3tokenizer_unread_key_strict_and_not(caplog):
    sd = {**_s3tok_sd(), "encoder.blocks.0.attn.mystery.weight": torch.zeros(4, 4)}
    for m in (p_s3tok, j_s3tok):
        with pytest.raises(ValueError, match="NOT consumed"):
            m.convert_s3tokenizer(sd)
    with caplog.at_level(logging.WARNING):
        pp, pc = p_s3tok.convert_s3tokenizer(sd, strict=False)
    assert any("NOT consumed" in r.getMessage() and r.name == p_s3tok.__name__
               for r in caplog.records)
    jp, jc = j_s3tok.convert_s3tokenizer(sd, strict=False)
    assert_same_tree(pp, jp)


def test_convert_perth_strict_and_not():
    from torch_perth_ref import PerthNetImplicitRef

    torch.manual_seed(1)
    net = PerthNetImplicitRef(n_bins=129, hidden=32, n_layers=3).eval()
    sd = {"model": {**{"module." + k: v for k, v in net.state_dict().items()},
                    "mystery.running_stat": torch.zeros(4), "aaa.extra": torch.ones(2)}}
    for m in (p_wm, j_wm):
        with pytest.raises(ValueError, match="NOT consumed"):
            m.convert_perth(sd)
    (pp, pmeta), (jp, jmeta) = p_wm.convert_perth(sd, strict=False), j_wm.convert_perth(sd, False)
    assert pmeta == jmeta and pmeta["unconsumed"] == ["aaa.extra", "mystery.running_stat"]
    assert_same_tree(pp, jp)


# ---------------------------------------------------------------------------
# load_params
# ---------------------------------------------------------------------------


def _tree(rng):
    return {
        "emb": {"w": rng.standard_normal((5, 3)).astype(np.float32)},
        "layers": [{"w": rng.standard_normal((2, 4)).astype(np.float32),
                    "n": rng.integers(-9, 9, (3,)).astype(np.int32)} for _ in range(2)],
        "maybe": None,
        "step": np.asarray([7], np.int64),
    }


def test_load_params_reads_the_jax_packages_file(tmp_path):
    tree = _tree(np.random.default_rng(0))
    path = tmp_path / "jax.jax.safetensors"
    j_io.save_params(tree, path)
    want = j_io.load_params(path, device_put=False)
    assert_same_tree(p_io.load_params(path, device_put=False), want)
    got = p_io.load_params(path, device="cpu")
    assert_same_tree(got, tree)
    assert got["maybe"] is None and got["emb"]["w"].device.type == "cpu"


def test_load_params_reads_the_ports_file_with_bf16(tmp_path):
    tree = _tree(np.random.default_rng(1))
    tree["emb"]["w"] = torch.from_numpy(tree["emb"]["w"]).to(torch.bfloat16)
    path = tmp_path / "port.jax.safetensors"
    p_io.save_params(tree, path)
    got = p_io.load_params(path, device="cpu")
    assert got["emb"]["w"].dtype == torch.bfloat16
    assert torch.equal(got["emb"]["w"].view(torch.int16), tree["emb"]["w"].view(torch.int16))
    tree_np = {**tree, "emb": {"w": tree["emb"]["w"].float().numpy()}}
    assert_same_tree(got["layers"], tree["layers"])
    host = p_io.load_params(path, device_put=False)
    assert_same_tree(host, j_io.load_params(path, device_put=False))
    assert_same_tree(host, tree_np)


def test_load_params_never_drops_to_the_cpu_on_its_own(tmp_path, monkeypatch):
    path = tmp_path / "p.jax.safetensors"
    p_io.save_params({"w": np.zeros(2, np.float32)}, path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        p_io.load_params(path)


# ---------------------------------------------------------------------------
# text_to_tokens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ("native", "python"))
def test_text_to_tokens_matches_jax(tmp_path, backend):
    import json

    from test_tokenizer_fuzz import _fuzz_texts, build_spec

    from chatterbox_tpu.models.tokenizer import EnTokenizer as JTok
    from chatterbox_tpu_torch.models.tokenizer import EnTokenizer as PTok

    path = tmp_path / "tokenizer.json"
    path.write_text(json.dumps(build_spec()))
    port, ref = PTok(str(path), backend=backend), JTok(str(path), backend="python")
    assert port.backend == backend
    for text in _fuzz_texts(n=60, seed=3):
        got, want = port.text_to_tokens(text), np.asarray(ref.text_to_tokens(text))
        assert got.dtype == torch.int32 and got.device.type == "cpu", text
        assert tuple(got.shape) == want.shape == (1, len(port.encode(text))), text
        np.testing.assert_array_equal(got.numpy(), want, err_msg=repr(text))


# ---------------------------------------------------------------------------
# the helper parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("periodic", (True, False))
def test_hann_window_matches_jax(periodic):
    for n in (16, 400, 1920):
        np.testing.assert_array_equal(pd.hann_window(n, periodic), jd.hann_window(n, periodic))


def test_stft_pad_mode_and_istft_center_match_jax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 600)).astype(np.float32)
    win = jd.hann_window(64)
    pr, pi = pd.stft(t(x), 64, 16, win, True, "reflect")
    jr, ji = jd.stft(j(x), 64, 16, win, True, "reflect")
    assert_close(pr, jr, 2e-5)
    assert_close(pi, ji, 2e-5)
    with pytest.raises(ValueError, match="reflect"):
        pd.stft(t(x), 64, 16, win, True, "constant")
    ur, ui = pd.stft(t(x), 64, 16, win, False, "constant")  # no padding, nothing to raise
    vr, vi = jd.stft(j(x), 64, 16, win, False, "constant")
    assert_close(ur, vr, 2e-5)
    for center in (True, False):
        assert_close(pd.istft(pr, pi, 64, 16, win, center),
                     jd.istft(jr, ji, 64, 16, win, center), 2e-5, msg=f"center={center}")


@pytest.mark.parametrize("dilation", (1, 2, 3))
def test_causal_conv1d_dilation_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 13, 4)).astype(np.float32)
    wj, b = (rng.standard_normal((3, 4, 5)) * 0.3).astype(np.float32), rng.standard_normal(5)
    b = b.astype(np.float32)
    got = pl.causal_conv1d({"w": t(wj.transpose(2, 1, 0)), "b": t(b)}, t(x), dilation)
    want = jl.causal_conv1d({"w": j(wj), "b": j(b)}, j(x), dilation)
    assert_close(got, want, 1e-5, 1e-5)


def test_sdpa_mask_and_scale_match_jax():
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((2, 3, 5, 8)).astype(np.float32) for _ in range(3))
    keep = rng.random((2, 1, 5, 5)) > 0.3
    keep[..., 0] = True
    bias = (rng.standard_normal((2, 3, 5, 5)) * 2).astype(np.float32)
    for mask in (None, keep, bias):
        for scale in (None, 0.3):
            got = pl.sdpa(t(q), t(k), t(v), None if mask is None else t(mask), scale)
            want = jl.sdpa(j(q), j(k), j(v), None if mask is None else j(mask), scale)
            assert_close(got, want, 1e-5, 1e-5, msg=f"scale={scale}")


def test_rel_pos_encoding_matches_jax():
    x = np.random.default_rng(2).standard_normal((2, 9, 32)).astype(np.float32)
    gx, gpos = p_conf.rel_pos_encoding(t(x), 32)
    wx, wpos = j_conf.rel_pos_encoding(j(x), 32)
    assert_close(gx, wx, 1e-6, 1e-6)
    np.testing.assert_array_equal(gpos.numpy(), np.asarray(wpos))


@pytest.mark.parametrize("axis", (-1, 1))
def test_quantize_kv_axis_matches_jax(axis):
    kv = np.random.default_rng(4).standard_normal((2, 6, 3, 8)).astype(np.float32)
    kv[0, 2] = 0.0  # all-zero (padding) tokens stay zero
    q8, sc = p_fd.quantize_kv(t(kv), axis)
    wq, ws = jax.jit(j_llama.quantize_kv, static_argnums=1)(j(kv), axis)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(ws))
