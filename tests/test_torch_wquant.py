"""The port's runtime T3 weight layouts -- q/k/v fused into one projection and
int8 weights with per-output-channel scales -- and ``apply_tts_precision``,
held against ``chatterbox_tpu/models/t3/llama.py`` and
``chatterbox_tpu/runtime/precision.py`` on the same weights (CPU, fp32 unless
a test says otherwise). Mirrors ``tests/test_weight_quant.py``.

The JAX package always quantizes under ``jax.jit``, where XLA turns the
division of the absmax by 127 into a multiply by its fp32 reciprocal; the
port follows that compiled form, so int8 values and scales are held bit for
bit against ``jax.jit(quantize_llama_weights)``."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (J_T3, P_T3, _fill, assert_close, eos_boosted_t3_params, gen_inputs, j,
                          jax_uniforms, np_tree, s3gen_with_conditioning, t, t3_params)

from chatterbox_tpu.core.sampling import SamplingConfig as JSampling
from chatterbox_tpu.models.t3 import llama as jl
from chatterbox_tpu.models.t3 import t3 as jt
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.core.sampling import SamplingConfig as PSampling
from chatterbox_tpu_torch.models.t3 import llama as pl
from chatterbox_tpu_torch.models.t3 import t3 as pt
from chatterbox_tpu_torch.runtime import precision as pp


def _jax_runtime(llama, quant=True):
    """The JAX runtime layout of a Llama tree, compiled as the JAX package
    runs it (precision.py:56-58)."""
    out = jax.jit(jl.fuse_qkv_params)(jax.tree.map(jnp.asarray, llama))
    return np_tree(jax.jit(jl.quantize_llama_weights)(out) if quant else out)


def _port_runtime(llama, quant=True):
    out = pl.fuse_qkv_params(llama)
    return pl.quantize_llama_weights(out) if quant else out


def _assert_tree_equal(got, want):
    """A port tree, bridged back to the JAX layouts, equals a JAX tree bit
    for bit (same keys, dtypes and values). A Llama tree goes in under its
    ``llama`` key, which tells the bridge its layout."""
    g, w = jax.tree_util.tree_flatten_with_path(weights.to_jax_tree(got)), \
        jax.tree_util.tree_flatten_with_path(np_tree(want))
    assert [p for p, _ in g[0]] == [p for p, _ in w[0]]
    for (path, a), (_, b) in zip(g[0], w[0]):
        b = np.asarray(b, np.float32) if b.dtype.name == "bfloat16" else np.asarray(b)
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=str(path))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_jax_jit_bit_for_bit(dtype):
    """w8 and scale of the fused tree, from fp32 and from bf16 weights."""
    jp, ppar = t3_params()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    jllama = jax.tree.map(lambda x: jnp.asarray(x, jdt), jp["llama"])
    got = _port_runtime(weights.tree_to(ppar["llama"], dtype=dtype))
    want = _jax_runtime(jllama)
    assert got["layers"]["qkv"]["w8"].dtype == torch.int8
    assert got["layers"]["qkv"]["scale"].dtype == torch.float32
    assert "w" not in got["layers"]["o"] and "scale" in got["layers"]["input_ln"]
    for name in ("qkv", "o", "gate_up", "down"):
        for leaf in ("w8", "scale"):
            w = np.asarray(want["layers"][name][leaf])
            g = got["layers"][name][leaf]
            g = g.transpose(-1, -2) if leaf == "w8" else g  # (L, Cout, Cin) -> JAX (L, Cin, Cout)
            np.testing.assert_array_equal(g.numpy(), w, err_msg=f"{name}.{leaf}")


def test_quantize_roundtrip_error_bound():
    """As test_weight_quant.py: dequantized weights within the symmetric
    int8 grid, |w - deq(w)| <= channel absmax / 254, elementwise."""
    _, ppar = t3_params()
    fused = pl.fuse_qkv_params(ppar["llama"])
    deq = pl.dequantize_llama_weights(pl.quantize_llama_weights(fused), dtype=torch.float32)
    w = fused["layers"]["qkv"]["w"]
    absmax = w.abs().amax(dim=-1, keepdim=True)
    assert bool(((deq["layers"]["qkv"]["w"] - w).abs() <= absmax / 254 + 1e-9).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_and_canonicalize_match_jax(dtype):
    """dequantize_llama_weights and canonicalize_llama_params exactly as the
    JAX package's, and unfuse_qkv_params the inverse of fuse_qkv_params."""
    jp, ppar = t3_params()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q_port, q_jax = _port_runtime(ppar["llama"]), _jax_runtime(jp["llama"])
    _assert_tree_equal({"llama": pl.dequantize_llama_weights(q_port, dtype)},
                       {"llama": jl.dequantize_llama_weights(jax.tree.map(jnp.asarray, q_jax),
                                                             jdt)})
    canon = pl.canonicalize_llama_params(q_port, P_T3.llama, dtype)
    assert "qkv" not in canon["layers"] and "w" in canon["layers"]["q"]
    _assert_tree_equal({"llama": canon}, {"llama": jl.canonicalize_llama_params(
        jax.tree.map(jnp.asarray, q_jax), J_T3.llama, jdt)})
    fused = pl.fuse_qkv_params(ppar["llama"])
    assert pl.fuse_qkv_params(fused) is fused
    back = pl.unfuse_qkv_params(fused, P_T3.llama)
    for n in ("q", "k", "v"):
        assert torch.equal(back["layers"][n]["w"], ppar["llama"]["layers"][n]["w"])


@pytest.mark.parametrize("quant", [False, True])
def test_prefill_logits_match_jax(quant):
    """The fused, and the fused int8, prefill: speech logits within 1e-5 of
    the JAX package's (fp32; the products differ in round-off only)."""
    jp, ppar = t3_params()
    rng = np.random.default_rng(2)
    b, s0, c = 3, 21, 64
    x = (rng.standard_normal((b, s0, c)) * 0.5).astype(np.float32)
    lens = np.array([s0, s0 - 7, s0 - 3])
    valid = np.arange(s0)[None] < lens[:, None]
    pos = np.where(valid, np.cumsum(valid, 1) - 1, 0).astype(np.int32)
    jh, _ = jl.llama_prefill(jax.tree.map(jnp.asarray, _jax_runtime(jp["llama"], quant)),
                             J_T3.llama, j(x), j(pos), j(valid), 128)
    want = np.asarray(jh) @ jp["speech_head"]["w"]  # JAX linear weights are (Cin, Cout)
    ph, _ = pl.llama_prefill(_port_runtime(ppar["llama"], quant), P_T3.llama, t(x), t(pos),
                             t(valid), 128)
    got = torch.nn.functional.linear(ph, ppar["speech_head"]["w"])
    assert_close(got, want, 1e-5, 1e-5)


@pytest.mark.parametrize("quant,greedy,cache_quant", [
    (False, True, False),  # fused q/k/v alone
    (True, True, False), (True, False, False), (True, True, True), (True, False, True),
])
def test_t3_generate_runtime_layouts_tokens_exact(quant, greedy, cache_quant):
    """Tokens, lengths and steps exactly as the JAX package's on the same
    fused (and int8) weights, greedy and under the JAX key chain's
    uniforms, on the working-dtype and the int8 KV cache."""
    jp, ppar = eos_boosted_t3_params()
    jp = {**jp, "llama": _jax_runtime(jp["llama"], quant)}
    ppar = {**ppar, "llama": _port_runtime(ppar["llama"], quant)}
    text, lens, spk, prompt, emo = gen_inputs()
    samp, max_new, seed = dict(greedy=greedy, cfg_weight=0.5), 24, 11
    want = jt.t3_generate(jax.tree.map(jnp.asarray, jp), J_T3, j(text), j(lens), j(spk),
                          j(prompt), j(emo), jax.random.PRNGKey(seed), JSampling(**samp),
                          max_new, cache_quant=cache_quant)
    uniforms = None if greedy else t(jax_uniforms(seed, max_new, len(lens)))
    got = pt.t3_generate(ppar, P_T3, t(text), t(lens), t(spk), t(prompt), t(emo),
                         PSampling(**samp), max_new, uniforms=uniforms, cache_quant=cache_quant)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    np.testing.assert_array_equal(got.lengths.numpy(), np.asarray(want.lengths))
    assert got.steps == int(want.steps)


def _precision_pair():
    """A JAX and a port stand-in of ``ChatterboxTTS`` with the same T3 and
    S3Gen weights (flow, HiFT, CAMPPlus, S3 tokenizer)."""
    jp, ppar = t3_params()
    js3, ps3 = s3gen_with_conditioning()
    jtts = SimpleNamespace(t3_params=jax.tree.map(jnp.asarray, jp),
                           s3gen_params=jax.tree.map(jnp.asarray, js3), mesh=None)
    ptts = SimpleNamespace(t3_params=ppar, s3gen_params=ps3)
    return jtts, ptts


@pytest.mark.parametrize("setting", ["on", "off", "env_on", "env_unset"])
def test_apply_tts_precision_matches_jax(setting, monkeypatch):
    """T3 bf16 and fused (and int8 when asked, or when CHATTERBOX_W_QUANT=1
    and the argument is None), the flow and the tokenizer bf16, HiFT and
    CAMPPlus fp32: every leaf as the JAX package's, bit for bit."""
    from chatterbox_tpu.runtime.precision import apply_tts_precision

    monkeypatch.delenv("CHATTERBOX_W_QUANT", raising=False)
    if setting == "env_on":
        monkeypatch.setenv("CHATTERBOX_W_QUANT", "1")
    wq = {"on": True, "off": False}.get(setting)
    jtts, ptts = _precision_pair()
    apply_tts_precision(jtts, weight_quant=wq)
    assert pp.apply_tts_precision(ptts, weight_quant=wq) is ptts
    layers = ptts.t3_params["llama"]["layers"]
    assert ("w8" in layers["qkv"]) == (setting in ("on", "env_on"))
    assert layers["input_ln"]["scale"].dtype == torch.bfloat16
    _assert_tree_equal(ptts.t3_params, jtts.t3_params)
    for name in ("flow", "tokenizer", "hift", "campplus"):
        _assert_tree_equal(ptts.s3gen_params[name], jtts.s3gen_params[name])
    assert ptts.s3gen_params["flow"]["estimator"]["time_mlp1"]["w"].dtype == torch.bfloat16
    assert ptts.s3gen_params["hift"]["conv_pre"]["w"].dtype == torch.float32


def test_bridge_round_trips_quantized_fused_tree():
    """A fused int8 T3 tree with every leaf away from 0 and 1 crosses the
    bridge and back bit for bit; each w8 is transposed to (L, Cout, Cin),
    the square ``o`` (64 x 64 here, 1024 x 1024 at full width) included,
    and each scale passes through."""
    shapes = jax.eval_shape(lambda: jt.init_t3(jax.random.PRNGKey(0), J_T3))
    jtree = {**_fill(shapes, np.random.default_rng(3))}
    jtree["llama"] = _jax_runtime(jtree["llama"])
    port = weights.from_jax_tree(jtree)
    lay, jlay = port["llama"]["layers"], jtree["llama"]["layers"]
    o = np.asarray(jlay["o"]["w8"])
    assert o.shape[-1] == o.shape[-2] and not np.array_equal(o, o.swapaxes(-1, -2))
    for name in ("qkv", "o", "gate_up", "down"):
        np.testing.assert_array_equal(lay[name]["w8"].numpy(),
                                      np.asarray(jlay[name]["w8"]).swapaxes(-1, -2))
        np.testing.assert_array_equal(lay[name]["scale"].numpy(), np.asarray(jlay[name]["scale"]))
    scales = np.concatenate([np.asarray(jlay[n]["scale"]).ravel() for n in ("qkv", "o")])
    assert np.all((scales > 0) & (scales != 1.0))
    _assert_tree_equal(port, jtree)


def test_runtime_layout_helpers_match_jax():
    """``_runtime_llama_layout`` as the JAX package's on the canonical, the
    fused and the int8 trees; ``_unfuse_qkv`` restores the canonical layout
    in T3's working dtype, as ``canonicalize_llama_params`` gives it."""
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JTTS
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    jp, ppar = t3_params()
    for quant in (None, False, True):
        jl_ = jp["llama"] if quant is None else _jax_runtime(jp["llama"], quant)
        pl_ = ppar["llama"] if quant is None else _port_runtime(ppar["llama"], quant)
        assert ChatterboxTTS._runtime_llama_layout({"llama": pl_}) is \
            JTTS._runtime_llama_layout({"llama": jl_})
    tts = ChatterboxTTS({**ppar, "llama": _port_runtime(ppar["llama"])}, {}, "cpu", t3_cfg=P_T3)
    tts._unfuse_qkv()
    want = jl.canonicalize_llama_params(jax.tree.map(jnp.asarray, _jax_runtime(jp["llama"])),
                                        J_T3.llama, jnp.float32)
    _assert_tree_equal({"llama": tts.t3_params["llama"]}, {"llama": want})
    assert not ChatterboxTTS._runtime_llama_layout(tts.t3_params)
