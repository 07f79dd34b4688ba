"""The port's S3Gen synthesis half (conformer encoder, causal UNet, CFM flow,
HiFT vocoder, trim-fade), held against ``chatterbox_tpu/models/s3gen`` on
the same weights and the same injected noise (CPU, fp32)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import J_S3GEN, P_S3GEN, assert_close, j, ref_inputs, s3gen_params, t

from chatterbox_tpu.models.s3gen import conformer as jc
from chatterbox_tpu.models.s3gen import flow as jf
from chatterbox_tpu.models.s3gen import hifigan as jh
from chatterbox_tpu.models.s3gen import s3gen as js
from chatterbox_tpu.models.s3gen import unet as ju
from chatterbox_tpu_torch.models.s3gen import conformer as pc
from chatterbox_tpu_torch.models.s3gen import flow as pf
from chatterbox_tpu_torch.models.s3gen import hifigan as ph
from chatterbox_tpu_torch.models.s3gen import s3gen as ps
from chatterbox_tpu_torch.models.s3gen import unet as pu


@pytest.fixture(scope="module")
def params():
    jp, pp = s3gen_params()
    return jax.tree.map(jnp.asarray, jp), pp


def test_upsample_conformer_encoder(params):
    jp, pp = params
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 30, 128)) * 0.1).astype(np.float32)
    mask = np.arange(30)[None] < np.array([[30], [21]])
    want = jc.upsample_conformer_encoder(jp["flow"]["encoder"], j(x), J_S3GEN.flow.encoder,
                                         key_mask=j(mask))
    got = pc.upsample_conformer_encoder(pp["flow"]["encoder"], t(x), P_S3GEN.flow.encoder,
                                        key_mask=t(mask))
    assert tuple(got.shape) == (2, 60, 128)
    assert_close(got, np.asarray(want), 1e-4, 1e-4)


def test_unet_forward(params):
    jp, pp = params
    rng = np.random.default_rng(1)
    x, mu, cond = (rng.standard_normal((2, 50, 80)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((2, 80)).astype(np.float32)
    tt = np.array([0.3, 0.71], np.float32)
    mask = np.arange(50)[None] < np.array([[50], [33]])
    want = ju.unet_forward(jp["flow"]["estimator"], J_S3GEN.flow.estimator, j(x), j(mu), j(spks),
                           j(cond), j(tt), j(mask))
    got = pu.unet_forward(pp["flow"]["estimator"], P_S3GEN.flow.estimator, t(x), t(mu), t(spks),
                          t(cond), t(tt), t(mask))
    assert_close(got, np.asarray(want), 1e-4, 1e-4)


def test_cosine_t_span():
    np.testing.assert_array_equal(pf.cosine_t_span(10), jf.cosine_t_span(10))


def _flow_inputs(seed=2, b=2, t_len=12):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 6561, (b, t_len)).astype(np.int32)
    lens = np.array([t_len, t_len - 5])[:b].astype(np.int32)
    ref = ref_inputs(seed + 1, b=b)
    noise = rng.standard_normal((b, 2 * (ref[0].shape[1] + t_len) + 10, 80)).astype(np.float32)
    return tokens, lens, ref, noise


def test_flow_inference_mel(params):
    """Same tokens, reference and CFM noise: the mel agrees to 1e-4 (fp32
    round-off through 10 Euler steps of the UNet)."""
    jp, pp = params
    tokens, lens, ref, noise = _flow_inputs()
    want, want_mask = jf.flow_inference(jp["flow"], J_S3GEN.flow, j(tokens), j(lens),
                                        *(j(r) for r in ref[:3]), j(ref[3]), j(noise))
    got, got_mask = pf.flow_inference(pp["flow"], P_S3GEN.flow, t(tokens), t(lens),
                                      *(t(r) for r in ref), t(noise))
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert_close(got, np.asarray(want), 1e-4, 1e-4)


def _hift_noise(seed, b, t_mel):
    rng = np.random.default_rng(seed)
    h = J_S3GEN.hift.nb_harmonics + 1
    phase = rng.uniform(-np.pi, np.pi, (b, h)).astype(np.float32)
    add = rng.standard_normal((b, h, t_mel * 480)).astype(np.float32)
    return phase, add


def test_hift_generate_with_injected_noise(params):
    jp, pp = params
    rng = np.random.default_rng(4)
    mel = (rng.standard_normal((2, 24, 80)) * 0.5 - 4.0).astype(np.float32)
    n_valid = np.array([24, 17], np.int32)
    phase, add = _hift_noise(5, 2, 24)
    want_wav, want_src = jh.hift_generate(jp["hift"], J_S3GEN.hift, j(mel), phase_noise=j(phase),
                                          additive_noise=j(add), n_valid=j(n_valid))
    got_wav, got_src = ph.hift_generate(pp["hift"], P_S3GEN.hift, t(mel), phase_noise=t(phase),
                                        additive_noise=t(add), n_valid=t(n_valid))
    assert_close(got_src, np.asarray(want_src), 1e-4, 1e-4)
    assert_close(got_wav, np.asarray(want_wav), 2e-3)
    # the deterministic decode alone, at test_hifigan.py's decode tolerance
    src = np.asarray(want_src)
    assert_close(ph.hift_decode(pp["hift"], P_S3GEN.hift, t(mel), t(src)),
                 np.asarray(jh.hift_decode(jp["hift"], J_S3GEN.hift, j(mel), j(src))), 2e-3)


def test_s3gen_wav_zero_vocoder_noise(params):
    """Tokens -> trim-faded wav with the same CFM noise and zeroed vocoder
    noise, at test_hifigan.py's full-inference tolerance (5e-3)."""
    jp, pp = params
    tokens, lens, ref, noise = _flow_inputs(6)
    b, t_mel = tokens.shape[0], 2 * tokens.shape[1]
    h = J_S3GEN.hift.nb_harmonics + 1
    zp, za = np.zeros((b, h), np.float32), np.zeros((b, h, t_mel * 480), np.float32)
    want_wav, want_lens, _ = js.s3gen_wav(jp, J_S3GEN, j(tokens), j(lens), js.RefDict(*map(j, ref)),
                                          j(noise), phase_noise=j(zp), additive_noise=j(za))
    got_wav, got_lens, _ = ps.s3gen_wav(pp, P_S3GEN, t(tokens), t(lens), ps.RefDict(*map(t, ref)),
                                        t(noise), phase_noise=t(zp), additive_noise=t(za))
    np.testing.assert_array_equal(got_lens.numpy(), np.asarray(want_lens))
    assert_close(got_wav, np.asarray(want_wav), 5e-3)
    assert float(got_wav[:, :480].abs().max()) == 0.0  # the first 20 ms are faded to 0


def test_hift_draws_from_a_generator_by_default(params):
    _, pp = params
    mel = t((np.random.default_rng(7).standard_normal((1, 6, 80)) - 4).astype(np.float32))
    a, _ = ph.hift_generate(pp["hift"], P_S3GEN.hift, mel, generator=torch.Generator().manual_seed(0))
    b, _ = ph.hift_generate(pp["hift"], P_S3GEN.hift, mel, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())
