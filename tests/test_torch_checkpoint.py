"""The port's reference-checkpoint path (converters, ``from_local``,
``from_pretrained``, ``conds.pt``, ``save_native``) and the neural Perth
watermarker, held against the JAX package on the CPU.

The reference set is written by ``torch_reference_format`` from the tiny
trees of ``torch_parity``; ``from_local`` of both packages builds its
configs at full width, so those names are patched with the tiny configs in
both packages' ``pipeline/tts.py`` (and ``pipeline/vc.py``) namespaces."""

import dataclasses
import json
import struct
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_reference_format as rf
from torch_parity import (J_S3GEN, J_T3, J_VE, P_S3GEN, P_T3, P_VE, _fill, jax_uniforms, np_tree,
                          ref_inputs, t, zero_vocoder_noise)
from torch_perth_ref import PerthNetImplicitRef

from chatterbox_tpu_torch import weights

TEXT = "Hello there, a checkpoint test."
MAX_NEW = 8
WAV_ATOL = 5e-3  # test_torch_pipeline.py's, int16 PCM on both sides
PERTH_ATOL = 1e-5  # test_watermark_perth.py's


@lru_cache(maxsize=None)
def _trees():
    """JAX-layout numpy trees of the tiny T3, S3Gen (flow, HiFT, CAMPPlus, S3
    tokenizer) and voice encoder: the trees of the JAX ``init_*``
    functions, filled from a numpy seed by ``torch_parity._fill`` (biases
    and norm scales away from 0 and 1, so that a misplaced leaf shows; the
    JAX init of the full-width HiFT alone compiles for 13 s)."""
    from chatterbox_tpu.models.s3gen.s3gen import init_s3gen
    from chatterbox_tpu.models.t3.t3 import init_t3
    from chatterbox_tpu.models.voice_encoder import init_voice_encoder

    key = jax.random.PRNGKey(0)
    shapes = {"t3": jax.eval_shape(lambda: init_t3(key, J_T3)),
              "s3gen": jax.eval_shape(lambda: init_s3gen(key, J_S3GEN)),
              "ve": jax.eval_shape(lambda: init_voice_encoder(key, J_VE))}
    trees = _fill(shapes, np.random.default_rng(0))
    return trees["t3"], trees["s3gen"], trees["ve"]


def _conds():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((1, 256)).astype(np.float32),
            rng.integers(0, 6561, (1, 150)).astype(np.int32),
            np.full((1,), 0.5, np.float32), *ref_inputs(10))


def assert_same_tree(got, want, path="", dtypes=True):
    """Same structure, every leaf equal bit for bit (strings equal), with
    equal dtypes unless ``dtypes`` is off. Dict order is not compared: JAX
    trees hold their keys sorted, and ``save_params`` writes sorted."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), (path, list(got), list(want))
        for k in want:
            assert_same_tree(got[k], want[k], f"{path}/{k}", dtypes)
    elif isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_tree(g, w, f"{path}/{i}", dtypes)
    elif want is None or isinstance(want, str):
        assert got == want, path
    else:
        g, w = np.asarray(got), np.asarray(want)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        assert not dtypes or g.dtype == w.dtype, (path, g.dtype, w.dtype)
        assert np.array_equal(g, w), path


# ---------------------------------------------------------------------------
# the converters, leaf for leaf against the JAX package's
# ---------------------------------------------------------------------------


def _float32_g(sd):
    """A state dict with the weight-norm magnitudes in float32, as a
    reference checkpoint holds them (the fold then rounds)."""
    return {k: v.astype(np.float32) if k.endswith(("weight_g", "original0")) else v
            for k, v in sd.items()}


def _leaf_sd(rng):
    """One state dict of each leaf rule's keys (torch layouts)."""
    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"lin.weight": r(6, 4), "lin.bias": r(6), "emb.weight": r(10, 4),
          "conv.weight": r(6, 4, 3), "conv.bias": r(6), "convt.weight": r(4, 6, 5),
          "conv2d.weight": r(6, 4, 3, 3), "ln.weight": r(4), "ln.bias": r(4),
          "bn.running_mean": r(4), "bn.running_var": r(4) ** 2, "bn.weight": r(4),
          "bn.bias": r(4), "bnx.running_mean": r(4), "bnx.running_var": r(4) ** 2}
    for i in range(2):
        sd.update({f"lstm.weight_ih_l{i}": r(16, 4), f"lstm.weight_hh_l{i}": r(16, 4),
                   f"lstm.bias_ih_l{i}": r(16), f"lstm.bias_hh_l{i}": r(16)})
    for name, w in (("wng", r(6, 4, 3)), ("wnp", r(6, 4, 3)), ("wnt", r(4, 6, 5))):
        g = np.linalg.norm(w.reshape(w.shape[0], -1), axis=1).reshape(-1, 1, 1) * 1.3
        keys = (("weight_g", "weight_v") if name == "wng" else
                ("parametrizations.weight.original0", "parametrizations.weight.original1"))
        sd[f"{name}.{keys[0]}"], sd[f"{name}.{keys[1]}"] = g.astype(np.float32), w
    return sd


def _perth_sd(wrapped):
    torch.manual_seed(3)
    sd = PerthNetImplicitRef(n_bins=129, hidden=32, n_layers=3).state_dict()
    return {"model": {"module." + k: v for k, v in sd.items()}} if wrapped else sd


def _cases():
    """name -> (the kind of state dict it reads, its call on one package's modules)."""
    leaf = {
        "fold_weight_norm/weight_g": lambda m, sd: m.fold_weight_norm(sd, "wng"),
        "fold_weight_norm/parametrizations": lambda m, sd: m.fold_weight_norm(sd, "wnp"),
        "fold_weight_norm/plain": lambda m, sd: m.fold_weight_norm(sd, "conv"),
        "linear": lambda m, sd: m.linear(sd, "lin"),
        "embedding": lambda m, sd: m.embedding(sd, "emb"),
        "conv1d": lambda m, sd: m.conv1d(sd, "conv"),
        "conv1d/weight_norm": lambda m, sd: m.conv1d(sd, "wng", weight_norm=True),
        "conv_transpose1d/weight_norm": lambda m, sd: m.conv_transpose1d(sd, "wnt", True),
        "conv2d": lambda m, sd: m.conv2d(sd, "conv2d"),
        "layer_norm": lambda m, sd: m.layer_norm(sd, "ln"),
        "rms_norm": lambda m, sd: m.rms_norm(sd, "ln"),
        "batch_norm": lambda m, sd: m.batch_norm(sd, "bn"),
        "batch_norm/no_affine": lambda m, sd: m.batch_norm(sd, "bnx"),
        "lstm": lambda m, sd: m.lstm(sd, "lstm", 2),
    }
    cases = {f"torch_convert.{k}": ("leaf", fn) for k, fn in leaf.items()}
    cases.update({
        "convert_llama": ("t3", lambda m, sd: m["llama"].convert_llama(sd, m["t3cfg"].llama)),
        "convert_cond_enc": ("t3", lambda m, sd: m["cond_enc"].convert_cond_enc(sd)),
        "convert_t3": ("t3", lambda m, sd: m["t3"].convert_t3(sd, m["t3cfg"])),
        "convert_voice_encoder": ("ve", lambda m, sd: m["ve"].convert_voice_encoder(
            sd, m["vecfg"])),
        "convert_upsample_conformer": ("s3gen", lambda m, sd: m[
            "conformer"].convert_upsample_conformer(sd, m["s3cfg"].flow.encoder, "flow.encoder.")),
        "convert_unet": ("s3gen", lambda m, sd: m["unet"].convert_unet(
            sd, m["s3cfg"].flow.estimator, "flow.decoder.estimator.")),
        "convert_flow": ("s3gen", lambda m, sd: m["flow"].convert_flow(sd, m["s3cfg"].flow)),
        "convert_hift/parametrizations": ("s3gen", lambda m, sd: m["hifigan"].convert_hift(
            sd, m["s3cfg"].hift, "mel2wav.")),
        "convert_hift/weight_g": ("s3gen_g", lambda m, sd: m["hifigan"].convert_hift(
            sd, m["s3cfg"].hift, "mel2wav.")),
        "convert_hift/float32_g": ("s3gen_f32g", lambda m, sd: m["hifigan"].convert_hift(
            sd, m["s3cfg"].hift, "mel2wav.")),
        "convert_campplus": ("s3gen", lambda m, sd: m["xvector"].convert_campplus(
            sd, m["s3cfg"].campplus)),
        "s3tok_config_from_sd": ("s3gen", lambda m, sd: dataclasses.asdict(
            m["s3tok"].s3tok_config_from_sd(sd, "tokenizer."))),
        "convert_s3tokenizer/bare": ("s3tok_bare", lambda m, sd: m["s3tok"].convert_s3tokenizer(
            sd, m["s3tok"].s3tok_config_from_sd(sd, ""), prefix="")),
        "convert_s3tokenizer/explicit": ("s3gen", lambda m, sd: m["s3tok"].convert_s3tokenizer(
            sd, m["s3tok"].s3tok_config_from_sd(sd, "tokenizer."), prefix="tokenizer.")),
        "convert_s3gen": ("s3gen", lambda m, sd: m["s3gen"].convert_s3gen(
            sd, m["s3gen"].infer_s3gen_config(sd, m["s3cfg"]))),
        "convert_s3gen/no_tokenizer": ("s3gen_notok", lambda m, sd: m["s3gen"].convert_s3gen(
            sd, m["s3cfg"])),
        "convert_perth": ("perth", lambda m, sd: m["watermark"].convert_perth(sd)),
        "convert_perth/model_module": ("perth_wrapped",
                                       lambda m, sd: m["watermark"].convert_perth(sd)),
    })
    return cases


def _modules(pkg):
    import importlib

    names = {"llama": "models.t3.llama", "cond_enc": "models.t3.cond_enc", "t3": "models.t3.t3",
             "ve": "models.voice_encoder", "conformer": "models.s3gen.conformer",
             "unet": "models.s3gen.unet", "flow": "models.s3gen.flow",
             "hifigan": "models.s3gen.hifigan", "xvector": "models.s3gen.xvector",
             "s3tok": "models.s3tokenizer", "s3gen": "models.s3gen.s3gen",
             "watermark": "models.watermark", "tc": "checkpoint.torch_convert"}
    m = {k: importlib.import_module(f"{pkg}.{v}") for k, v in names.items()}
    jax_side = pkg == "chatterbox_tpu"
    m.update(t3cfg=J_T3 if jax_side else P_T3, vecfg=J_VE if jax_side else P_VE,
             s3cfg=J_S3GEN if jax_side else P_S3GEN)
    return m


@pytest.fixture(scope="module")
def state_dicts():
    t3, s3gen, ve = _trees()
    s3 = rf.s3gen_state_dict(s3gen)
    return {
        "leaf": _leaf_sd(np.random.default_rng(0)),
        "t3": rf.t3_state_dict(t3),
        "ve": rf.ve_state_dict(ve),
        "s3gen": s3,
        "s3gen_g": rf.s3gen_state_dict(s3gen, weight_norm="weight_g"),
        "s3gen_f32g": _float32_g(s3),
        "s3gen_notok": {k: v for k, v in s3.items() if not k.startswith("tokenizer.")},
        "s3tok_bare": {k[len("tokenizer."):]: v for k, v in s3.items()
                       if k.startswith("tokenizer.")},
        "perth": _perth_sd(False),
        "perth_wrapped": _perth_sd(True),
    }


@pytest.mark.parametrize("case", sorted(_cases()))
def test_converter_matches_jax(case, state_dicts):
    """The port's converter gives the JAX package's tree on the same state
    dict: the same keys in the same order, every leaf equal bit for bit."""
    kind, fn = _cases()[case]
    sd = state_dicts[kind]
    mods = {pkg: _modules(pkg) for pkg in ("chatterbox_tpu", "chatterbox_tpu_torch")}
    if kind == "leaf":
        want, got = (fn(mods[pkg]["tc"], sd) for pkg in mods)
    else:
        want, got = (fn(mods[pkg], sd) for pkg in mods)
    assert_same_tree(got, np_tree(want))


@pytest.mark.parametrize("module,weight_norm", [("t3", None), ("ve", None),
                                                ("s3gen", "parametrizations"),
                                                ("s3gen", "weight_g")])
def test_reference_writer_inverts_the_jax_converters(module, weight_norm):
    """The writer's state dicts convert back, by the JAX package's own
    converters, to the trees they were written from, leaf for leaf: the
    exact (float64 g) weight-norm pairs included."""
    from chatterbox_tpu.models.s3gen.s3gen import convert_s3gen
    from chatterbox_tpu.models.t3.t3 import convert_t3
    from chatterbox_tpu.models.voice_encoder import convert_voice_encoder

    t3, s3gen, ve = _trees()
    if module == "t3":
        got = convert_t3(rf.t3_state_dict(t3), J_T3)
        want = t3
    elif module == "ve":
        got, want = convert_voice_encoder(rf.ve_state_dict(ve), J_VE), ve
    else:
        sd = rf.s3gen_state_dict(s3gen, weight_norm)
        h = s3gen["hift"]
        # conv_pre, conv_post, the ups, the f0 predictor and every resblock conv
        n_wn = 2 + len(h["ups"]) + len(h["f0_predictor"]["convs"]) + sum(
            len(r["convs1"]) + len(r["convs2"]) for r in h["resblocks"] + h["source_resblocks"])
        assert sum(k.endswith(("weight_g", "original0")) for k in sd) == n_wn
        got, want = convert_s3gen(sd, J_S3GEN), s3gen
    assert_same_tree(np_tree(got), want, dtypes=False)


def test_infer_s3gen_config_matches_jax(state_dicts):
    """The tokenizer's architecture read from the shapes: the port's config
    values equal JAX's, with and without ``tokenizer.*`` keys, and with
    ``n_audio_ctx`` from a shipped positional buffer."""
    from chatterbox_tpu.checkpoint.config_io import _to_dict
    from chatterbox_tpu.models.s3gen.s3gen import infer_s3gen_config as j_infer
    from chatterbox_tpu_torch.models.s3gen.s3gen import infer_s3gen_config as p_infer

    sd = dict(state_dicts["s3gen"])
    pos = "tokenizer.encoder.positional_embedding"
    sd[pos] = rf.sinusoids(700, sd[pos].shape[1])
    for case in (sd, state_dicts["s3gen_notok"]):
        got, want = p_infer(case, P_S3GEN), j_infer(case, J_S3GEN)
        assert _to_dict(got) == _to_dict(want)
    got = p_infer(sd, P_S3GEN).tokenizer
    assert (got.n_audio_ctx, got.n_state, got.n_head, got.n_layer) == (700, 64, 1, 2)
    assert p_infer(state_dicts["s3gen_notok"], P_S3GEN) == P_S3GEN


def test_s3tokenizer_converter_refuses_what_it_cannot_read(state_dicts):
    """A key left unread under the prefix raises, a positional buffer that
    is not the sinusoids raises, and a missing key raises KeyError, as in
    the JAX package."""
    from chatterbox_tpu_torch.models.s3tokenizer import convert_s3tokenizer, s3tok_config_from_sd

    sd = state_dicts["s3gen"]
    cfg = s3tok_config_from_sd(sd, "tokenizer.")
    with pytest.raises(ValueError, match="NOT consumed"):
        convert_s3tokenizer({**sd, "tokenizer.encoder.extra.weight": np.zeros(3, np.float32)},
                            cfg, "tokenizer.")
    pos = "tokenizer.encoder.positional_embedding"
    with pytest.raises(ValueError, match="sinusoids"):
        convert_s3tokenizer({**sd, pos: sd[pos] + 0.01}, cfg, "tokenizer.")
    with pytest.raises(KeyError):
        convert_s3tokenizer({k: v for k, v in sd.items() if not k.endswith("ln_post.bias")},
                            cfg, "tokenizer.")


def test_conditionals_load_torch_matches_jax(tmp_path):
    """A reference ``conds.pt`` (int64 tokens, emotion (1, 1, 1), None
    fields): values and dtypes equal to the JAX package's ``load_torch``."""
    from chatterbox_tpu.pipeline.conditionals import Conditionals as JConditionals
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    rf.write_conds_pt(tmp_path / "conds.pt", *_conds())
    got, want = Conditionals.load_torch(tmp_path / "conds.pt"), JConditionals.load_torch(
        tmp_path / "conds.pt")
    for g, w in zip((*got.t3, *got.gen), (*want.t3, *want.gen)):
        assert g.numpy().dtype == np.asarray(w).dtype and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got.t3.prompt_tokens.dtype == torch.int32 and tuple(got.t3.emotion_adv.shape) == (1,)


# ---------------------------------------------------------------------------
# from_local, save_native and the server, against the JAX package
# ---------------------------------------------------------------------------


def _patch_configs(mp):
    """The full-width config names of both packages' ``pipeline/tts.py`` and
    ``pipeline/vc.py`` -> the tiny configs."""
    from chatterbox_tpu.pipeline import tts as jt
    from chatterbox_tpu.pipeline import vc as jv
    from chatterbox_tpu_torch.pipeline import tts as pt
    from chatterbox_tpu_torch.pipeline import vc as pv

    for mods, cfgs in (((jt, jv), (J_T3, J_S3GEN, J_VE)), ((pt, pv), (P_T3, P_S3GEN, P_VE))):
        for mod in mods:
            for name, cfg in zip(("T3Config", "S3GenConfig", "VoiceEncoderConfig"), cfgs):
                if hasattr(mod, name):
                    mp.setattr(mod, name, lambda cfg=cfg: cfg)


@pytest.fixture(scope="module")
def ref_dir(tmp_path_factory):
    t3, s3gen, ve = _trees()
    return rf.write_reference_set(tmp_path_factory.mktemp("reference"), t3, s3gen, ve,
                                  conds=_conds(), t3_prefix="model.")


@pytest.fixture(scope="module")
def loaded(ref_dir):
    """(JAX from_local, port from_local(device="cpu")) of the reference set,
    the full-width config names patched with the tiny ones."""
    from chatterbox_tpu.pipeline import tts as jt
    from chatterbox_tpu_torch.pipeline import tts as pt

    with pytest.MonkeyPatch.context() as mp:
        _patch_configs(mp)
        return jt.ChatterboxTTS.from_local(ref_dir), pt.ChatterboxTTS.from_local(ref_dir,
                                                                                device="cpu")


def test_from_local_matches_jax(loaded):
    """Parameters bit for bit (the port's through ``to_jax_tree``), configs,
    tokenizer ids and conditionals equal; the ``model.`` prefix was
    dropped and the tokenizer's config read from the shapes."""
    from chatterbox_tpu.checkpoint.config_io import _to_dict

    jtts, ptts = loaded
    for name in ("t3_params", "s3gen_params", "ve_params"):
        assert_same_tree(weights.to_jax_tree(getattr(ptts, name)), np_tree(getattr(jtts, name)))
    for name in ("t3_cfg", "s3gen_cfg", "ve_cfg"):
        assert _to_dict(getattr(ptts, name)) == _to_dict(getattr(jtts, name)), name
    assert ptts.s3gen_cfg.tokenizer.n_head == 1 and ptts.t3_params["llama"]["layers"]["q"][
        "w"].dtype == torch.float32
    for text in (TEXT, "Numbers 0123 and (brackets): done!", "aaaa bbbb"):
        assert ptts.tokenizer.encode(text) == jtts.tokenizer.encode(text)
    for g, w in zip((*ptts.conds.t3, *ptts.conds.gen), (*jtts.conds.t3, *jtts.conds.gen)):
        assert g.numpy().dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_generate(jtts, greedy):
    """The JAX pipeline's wav and compacted tokens of one ``generate`` (the
    vocoder noise zeroed)."""
    from chatterbox_tpu.models.s3gen import s3gen as js

    real_fn, real_hift, got = jtts._get_t3_fn, js.hift_generate, {}

    def get_t3_fn(*a, **kw):
        fn = real_fn(*a, **kw)

        def run(*args):
            got["res"] = fn(*args)
            return got["res"]

        return run

    jtts._get_t3_fn = get_t3_fn
    js.hift_generate = zero_vocoder_noise(real_hift, jnp.zeros)
    try:
        wav = jtts.generate(TEXT, seed=5, max_new_tokens=MAX_NEW, greedy=greedy)
    finally:
        del jtts._get_t3_fn
        js.hift_generate = real_hift
    tokens, n = np.asarray(got["res"].tokens)[0], int(np.asarray(got["res"].lengths)[0])
    return np.asarray(wav), tokens[:n][tokens[:n] < 6561]


@pytest.mark.parametrize("greedy", [True, False])
def test_from_local_generate_matches_jax(loaded, greedy, monkeypatch):
    """One ``generate`` on the loaded models: the tokens exact, greedy and
    under the JAX key chain's uniforms fed to the port's decode; the wav
    within the pipeline tolerance."""
    from chatterbox_tpu_torch.models.s3gen import s3gen as ps
    from chatterbox_tpu_torch.pipeline import tts as pt

    jtts, ptts = loaded
    want_wav, want_tokens = _jax_generate(jtts, greedy)
    real = pt.t3_generate

    def t3_generate(*a, **kw):
        kw.pop("generator")
        return real(*a, uniforms=t(jax_uniforms(5, MAX_NEW, 1)), **kw)

    monkeypatch.setattr(pt, "t3_generate", t3_generate)
    monkeypatch.setattr(ps, "hift_generate", zero_vocoder_noise(ps.hift_generate, torch.zeros))
    wav = ptts.generate(TEXT, seed=5, max_new_tokens=MAX_NEW, greedy=greedy)
    np.testing.assert_array_equal(ptts.last_speech_tokens[0], want_tokens)
    assert wav.shape == want_wav.shape and np.abs(want_wav).max() > 0.01
    np.testing.assert_allclose(wav, want_wav, atol=WAV_ATOL)


def _read_header(path):
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        return json.loads(f.read(n))


def test_save_native_is_the_jax_format(loaded, tmp_path):
    """The port's ``save_native`` writes the files of the JAX package's
    ``save_native`` of the same parameters byte for byte (key set, dtypes,
    shapes, bytes); the JAX ``load_configs`` and ``from_native`` read them
    back to the same configs and values."""
    from chatterbox_tpu.checkpoint.config_io import _to_dict, load_configs
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS as JTTS

    jtts, ptts = loaded
    ptts.save_native(tmp_path / "port")
    jtts.save_native(tmp_path / "jax")
    for name in ("t3.jax.safetensors", "s3gen.jax.safetensors", "ve.jax.safetensors",
                 "conds.safetensors"):
        got, want = tmp_path / "port" / name, tmp_path / "jax" / name
        assert _read_header(got) == _read_header(want), name
        assert got.read_bytes() == want.read_bytes(), name
    assert "tokenizer/@none" not in _read_header(tmp_path / "port" / "s3gen.jax.safetensors")
    cfgs = load_configs(tmp_path / "port" / "config.json")
    for got, name in zip(cfgs, ("t3_cfg", "s3gen_cfg", "ve_cfg")):
        assert _to_dict(got) == _to_dict(getattr(jtts, name))
    back = JTTS.from_native(tmp_path / "port")
    for name in ("t3_params", "s3gen_params", "ve_params"):
        assert_same_tree(np_tree(getattr(back, name)), np_tree(getattr(jtts, name)))


def test_save_native_writes_bf16_bit_for_bit(loaded, tmp_path):
    """bf16 leaves (T3 and the flow on the card) are written as their
    16-bit patterns tagged BF16, not widened: the port reads them back bit
    for bit, the JAX reader to the same values in float32. A runtime T3
    layout (fused q/k/v) is saved canonical from a copy, the live layout
    kept; a tokenizer-less S3Gen writes its None leaf."""
    from chatterbox_tpu.checkpoint.pytree_io import load_params
    from chatterbox_tpu_torch.models.t3.llama import fuse_qkv_params
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    _, ptts = loaded
    t3 = weights.tree_to(ptts.t3_params, "cpu", torch.bfloat16)
    tts = ChatterboxTTS({**t3, "llama": fuse_qkv_params(t3["llama"])},
                        {**ptts.s3gen_params, "tokenizer": None}, "cpu", t3_cfg=ptts.t3_cfg,
                        s3gen_cfg=ptts.s3gen_cfg, ve_params=ptts.ve_params, ve_cfg=ptts.ve_cfg)
    tts.save_native(tmp_path)
    assert "qkv" in tts.t3_params["llama"]["layers"]
    header = _read_header(tmp_path / "t3.jax.safetensors")
    assert header["llama/layers/q/w"]["dtype"] == "BF16" and "llama/layers/qkv/w" not in header
    assert "tokenizer/@none" in _read_header(tmp_path / "s3gen.jax.safetensors")
    back, want_leaves = dict(_leaves(weights.load_native(tmp_path / "t3.jax.safetensors"))), dict(
        _leaves(t3))
    assert back.keys() == want_leaves.keys()
    for path, got in back.items():
        want = want_leaves[path]
        assert got.dtype == want.dtype == torch.bfloat16, path
        assert torch.equal(got.view(torch.int16), want.contiguous().view(torch.int16)), path
    j = np_tree(load_params(tmp_path / "t3.jax.safetensors", device_put=False))
    assert_same_tree(j, weights.to_jax_tree(t3))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def test_from_pretrained_and_vc_from_local(ref_dir, loaded, monkeypatch, tmp_path):
    """``from_pretrained`` with no directory raises (no download), with one
    is ``from_local``; ``ChatterboxVC.from_local`` gives the same S3Gen as
    the JAX package's and the ``conds.pt`` voice on its device; a
    ``conds.safetensors`` serves when there is no ``conds.pt``."""
    from chatterbox_tpu.pipeline import vc as jv
    from chatterbox_tpu_torch.pipeline import tts as pt
    from chatterbox_tpu_torch.pipeline import vc as pv

    with pytest.raises(ValueError, match="No network egress"):
        pt.ChatterboxTTS.from_pretrained()
    _patch_configs(monkeypatch)
    got = pt.ChatterboxTTS.from_pretrained(ref_dir, device="cpu")
    assert_same_tree(weights.to_jax_tree(got.t3_params), weights.to_jax_tree(loaded[1].t3_params))
    jvc, pvc = jv.ChatterboxVC.from_local(ref_dir), pv.ChatterboxVC.from_local(ref_dir,
                                                                              device="cpu")
    assert_same_tree(weights.to_jax_tree(pvc.s3gen_params), np_tree(jvc.s3gen_params))
    for g, w in zip(pvc.ref_dict, jvc.ref_dict):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    d = tmp_path / "safetensors_conds"
    d.mkdir()
    for f in ref_dir.iterdir():
        if f.name != "conds.pt":
            (d / f.name).symlink_to(f)
    loaded[1].conds.save(d / "conds.safetensors")
    got = pt.ChatterboxTTS.from_local(d, device="cpu")
    np.testing.assert_array_equal(got.conds.gen.prompt_feat.numpy(),
                                  loaded[1].conds.gen.prompt_feat.numpy())


def test_load_model_reads_a_reference_set(ref_dir, loaded, monkeypatch):
    """The server's ``load_model`` loads a reference-format ``model_dir``
    through ``from_local`` (no native ``t3.jax.safetensors`` there)."""
    from chatterbox_tpu_torch.serve import service
    from chatterbox_tpu_torch.serve.config import ServerConfig

    _patch_configs(monkeypatch)
    got = service.load_model(ServerConfig(model_dir=str(ref_dir), device="cpu"))
    assert_same_tree(weights.to_jax_tree(got.s3gen_params),
                     weights.to_jax_tree(loaded[1].s3gen_params))


# ---------------------------------------------------------------------------
# the neural Perth watermarker
# ---------------------------------------------------------------------------


def _speech_like(n, seed=0, level=0.2):
    """test_watermark_perth.py's harmonic + noise signal."""
    rng = np.random.default_rng(seed)
    tt = np.arange(n) / 24000.0
    f0 = 120 + 30 * np.sin(2 * np.pi * 2.3 * tt)
    x = sum(np.sin(2 * np.pi * k * np.cumsum(f0) / 24000.0) / k for k in range(1, 9))
    x = x + 0.15 * rng.standard_normal(n)
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 3.1 * tt) ** 2
    return (level * env * x / np.abs(x).max()).astype(np.float32)


@pytest.fixture(scope="module")
def perth_ckpt(tmp_path_factory):
    path = tmp_path_factory.mktemp("perth") / "perth.pth"
    torch.save({"model": _perth_sd(False)}, path)
    return path


def test_perth_matches_jax(perth_ckpt):
    """``apply_watermark`` and ``presence_logit`` of the port's
    ``PerthNetImplicit`` within test_watermark_perth.py's 1e-5 of JAX's on
    the same checkpoint, a batch and a single row; presence agrees."""
    from chatterbox_tpu.models.watermark import PerthNetImplicit as JPerth
    from chatterbox_tpu_torch.models.watermark import PerthNetImplicit

    jw, pw = JPerth.from_checkpoint(str(perth_ckpt)), PerthNetImplicit.from_checkpoint(perth_ckpt)
    assert (pw.n_fft, pw.hop) == (jw.n_fft, jw.hop) == (256, 64)
    batch = np.stack([_speech_like(8000, seed=s) for s in (1, 2)])
    for x in (batch, batch[0, :7001]):
        got, want = pw.apply_watermark(x), jw.apply_watermark(x)
        assert got.shape == x.shape
        np.testing.assert_allclose(got, want, atol=PERTH_ATOL)
        np.testing.assert_allclose(pw.presence_logit(x), jw.presence_logit(x), atol=PERTH_ATOL)
    marked = pw.apply_watermark(batch[0])
    assert pw.get_watermark(marked) == jw.get_watermark(marked)
    assert 0 < np.abs(marked - batch[0]).max() < 0.1


def test_perth_converter_refuses_leftover_keys():
    from chatterbox_tpu_torch.models.watermark import convert_perth

    sd = _perth_sd(True)
    with pytest.raises(ValueError, match="NOT consumed"):
        convert_perth({"model": {**sd["model"], "mystery.running_stat": torch.zeros(4)}})
    params, meta = convert_perth(sd)
    assert len(params["encoder"]) == len(params["decoder"]) == 3 and meta["n_fft"] == 256


def test_perth_factory_order(perth_ckpt, tmp_path, monkeypatch):
    """The factory's order, as the JAX package's: the ``checkpoint``
    argument, then ``$CHATTERBOX_PERTH_CKPT``, then ``perth.pth`` beside the
    package's modules, else spread-spectrum."""
    from chatterbox_tpu_torch.models import watermark as wm

    other = tmp_path / "other.pth"
    torch.save(PerthNetImplicitRef(n_bins=65, hidden=8, n_layers=2).state_dict(), other)
    monkeypatch.setattr(wm, "__file__", str(tmp_path / "pkg" / "models" / "watermark.py"))
    monkeypatch.delenv("CHATTERBOX_PERTH_CKPT", raising=False)
    assert isinstance(wm.PerthImplicitWatermarker(), wm.SpreadSpectrumWatermarker)
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "perth.pth").write_bytes(other.read_bytes())
    assert wm.PerthImplicitWatermarker().n_fft == 128  # the default file
    monkeypatch.setenv("CHATTERBOX_PERTH_CKPT", str(perth_ckpt))
    assert wm.PerthImplicitWatermarker().n_fft == 256  # the environment over the file
    assert wm.PerthImplicitWatermarker(checkpoint=str(other)).n_fft == 128  # the argument first


def test_pipeline_runs_the_neural_engine_on_the_device_batch(loaded, perth_ckpt, monkeypatch):
    """With ``$CHATTERBOX_PERTH_CKPT`` set, a pipeline built after it holds
    the neural engine, and ``generate`` watermarks inside ``synthesize``
    on the device batch: the JAX pipeline's neural-engine wav within the
    pipeline tolerance, the tokens the spread-spectrum call's. The
    tolerance separates the engines: the JAX spread-spectrum wav and the
    unwatermarked batch lie over four times as far from the port's wav."""
    from chatterbox_tpu.models.s3gen import s3gen as js
    from chatterbox_tpu.models.watermark import PerthNetImplicit as JPerth
    from chatterbox_tpu_torch.models.s3gen import s3gen as ps
    from chatterbox_tpu_torch.models.watermark import PerthNetImplicit
    from chatterbox_tpu_torch.pipeline import tts as pt
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    jtts, ptts = loaded
    monkeypatch.setenv("CHATTERBOX_PERTH_CKPT", str(perth_ckpt))
    tts = ChatterboxTTS(ptts.t3_params, ptts.s3gen_params, "cpu", tokenizer=ptts.tokenizer,
                        t3_cfg=ptts.t3_cfg, s3gen_cfg=ptts.s3gen_cfg, conds=ptts.conds)
    assert isinstance(tts.watermarker, PerthNetImplicit)
    seen = []
    real_apply = tts.watermarker.apply
    monkeypatch.setattr(tts.watermarker, "apply", lambda wav: seen.append(wav) or real_apply(wav))
    monkeypatch.setattr(ps, "hift_generate", zero_vocoder_noise(ps.hift_generate, torch.zeros))
    wav = tts.generate(TEXT, max_new_tokens=MAX_NEW, greedy=True)
    assert len(seen) == 1 and seen[0].shape[0] == 1
    neural_tokens = tts.last_speech_tokens
    ptts.generate(TEXT, max_new_tokens=MAX_NEW, greedy=True)
    np.testing.assert_array_equal(neural_tokens[0], ptts.last_speech_tokens[0])

    saved, real_hift = jtts.watermarker, js.hift_generate
    js.hift_generate = zero_vocoder_noise(real_hift, jnp.zeros)
    try:
        want_spread = np.asarray(jtts.generate(TEXT, max_new_tokens=MAX_NEW, greedy=True))
        jtts.watermarker = JPerth.from_checkpoint(str(perth_ckpt))
        want = np.asarray(jtts.generate(TEXT, max_new_tokens=MAX_NEW, greedy=True))
    finally:
        jtts.watermarker, js.hift_generate = saved, real_hift
    assert wav.shape == want.shape == want_spread.shape and np.abs(want).max() > 0.01
    np.testing.assert_allclose(wav, want, atol=WAV_ATOL)
    # the batch watermarked (padded past the wav), as the int16 PCM rounds it
    unmarked = (torch.round(torch.clamp(seen[0][:, : wav.shape[-1]], -1.0, 1.0) * 32767.0)
                .numpy() / 32767.0)
    for other in (want_spread, unmarked):
        assert np.abs(wav - other).max() > 4 * WAV_ATOL


def test_stream_runs_the_neural_engine_on_the_device(loaded, perth_ckpt, monkeypatch):
    """A stream watermarks each emitted chunk with its pipeline's engine on
    a tensor on the pipeline's device. With ``$CHATTERBOX_PERTH_CKPT`` set:
    every chunk is the neural engine applied to that chunk's unwatermarked
    audio, the unwatermarked chunks are the spread-spectrum stream's (the
    watermark comes last), and the two streams' chunks lie over four times
    the pipeline tolerance apart."""
    from chatterbox_tpu_torch.models.watermark import PerthNetImplicit, SpreadSpectrumWatermarker
    from chatterbox_tpu_torch.pipeline.streaming import StreamConfig, stream_generate_batch
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    _, ptts = loaded

    def build():
        return ChatterboxTTS(ptts.t3_params, ptts.s3gen_params, "cpu", tokenizer=ptts.tokenizer,
                             t3_cfg=ptts.t3_cfg, s3gen_cfg=ptts.s3gen_cfg, conds=ptts.conds)

    monkeypatch.delenv("CHATTERBOX_PERTH_CKPT", raising=False)
    spread = build()
    monkeypatch.setenv("CHATTERBOX_PERTH_CKPT", str(perth_ckpt))
    neural = build()
    assert isinstance(spread.watermarker, SpreadSpectrumWatermarker)
    assert isinstance(neural.watermarker, PerthNetImplicit)
    stream = StreamConfig(chunk_tokens=4, first_chunk_tokens=2, max_new_tokens=MAX_NEW)
    runs = {}
    for name, tts in (("spread", spread), ("neural", neural)):
        seen, real_apply = [], tts.watermarker.apply
        monkeypatch.setattr(tts.watermarker, "apply",
                            lambda wav, seen=seen, real=real_apply: seen.append(wav) or real(wav))
        chunks = [c for tick in stream_generate_batch(tts, [TEXT, "Another, shorter one."],
                                                      stream=stream, seed=3)
                  for c in tick if c is not None]
        assert len(chunks) == len(seen) > 2
        assert all(x.device == tts.device and x.shape == (1, len(c)) for x, c in zip(seen, chunks))
        runs[name] = seen, chunks, real_apply
    (s_seen, s_chunks, _), (n_seen, n_chunks, engine) = runs["spread"], runs["neural"]
    for x, c in zip(n_seen, n_chunks):
        np.testing.assert_array_equal(c, engine(x)[0].numpy())
    assert all(torch.equal(a, b) for a, b in zip(s_seen, n_seen))
    assert max(np.abs(a - b).max() for a, b in zip(s_chunks, n_chunks)) > 4 * WAV_ATOL
