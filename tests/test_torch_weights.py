"""The port's weight bridge, checkpoint reader and import guards, held
against the JAX package (CPU only)."""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from torch_parity import (
    J_S3GEN, J_T3, P_S3GEN, P_T3, P_VE, cond_params, np_tree, ref_inputs, s3gen_params, t3_params,
)

from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.checkpoint.safetensors_io import load_safetensors, save_safetensors

REPO = Path(__file__).resolve().parent.parent


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("which", ["t3", "s3gen", "ve", "campplus", "tokenizer"])
def test_from_jax_tree_round_trips_bit_for_bit(which):
    if which in ("t3", "s3gen"):
        jp, _ = t3_params() if which == "t3" else s3gen_params()
    else:
        jp = cond_params()[0][which]
    want = dict(_leaves(np_tree(jp)))
    got = dict(_leaves(weights.to_jax_tree(weights.from_jax_tree(np_tree(jp)))))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        np.testing.assert_array_equal(got[k], w, err_msg=str(k))


def test_bridge_layouts():
    """Linear (Cin, Cout) -> (Cout, Cin); the stacked T3 layers keep L in
    front; conv (W, Cin, Cout) -> (Cout, Cin, W); the HiFT ups (W, Cin,
    Cout) -> (Cin, Cout, W); embeddings stay (N, C)."""
    jt, pt = t3_params()
    js, ps = s3gen_params()
    assert tuple(pt["llama"]["layers"]["q"]["w"].shape) == (2, 64, 64)
    assert tuple(pt["llama"]["layers"]["gate_up"]["w"].shape) == (2, 256, 64)
    assert tuple(pt["speech_head"]["w"].shape) == (8194, 64)
    assert tuple(pt["speech_emb"]["w"].shape) == (8194, 64)
    w = np.asarray(js["flow"]["estimator"]["down_conv"]["w"])  # (3, 64, 64)
    np.testing.assert_array_equal(
        ps["flow"]["estimator"]["down_conv"]["w"].numpy(), w.transpose(2, 1, 0))
    up = np.asarray(js["hift"]["ups"][0]["w"])  # (W, Cin, Cout)
    np.testing.assert_array_equal(ps["hift"]["ups"][0]["w"].numpy(), up.transpose(1, 2, 0))


def test_bridge_layouts_of_the_conditioning_modules():
    """conv2d (KH, KW, Cin, Cout) -> (Cout, Cin, KH, KW); the FSMN's
    depthwise conv (W, 1, C) -> (C, 1, W); the LSTM's w_ih/w_hh stay in the
    JAX layout; batch-norm statistics pass through."""
    jc, pc = cond_params()
    w = jc["campplus"]["head"]["layer1"][0]["conv1"]["w"]  # (3, 3, 8, 8)
    np.testing.assert_array_equal(pc["campplus"]["head"]["layer1"][0]["conv1"]["w"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    assert tuple(pc["campplus"]["head"]["conv1"]["w"].shape) == (8, 1, 3, 3)
    assert tuple(pc["tokenizer"]["blocks"][0]["fsmn"]["w"].shape) == (64, 1, 11)
    for name in ("w_ih", "w_hh", "b"):
        np.testing.assert_array_equal(pc["ve"]["lstm"][1][name].numpy(), jc["ve"]["lstm"][1][name])
    assert tuple(pc["ve"]["proj"]["w"].shape) == (256, 32)
    bn = jc["campplus"]["dense"]["bn"]
    assert set(bn) == {"mean", "var"}
    np.testing.assert_array_equal(pc["campplus"]["dense"]["bn"]["var"].numpy(), bn["var"])


@pytest.fixture(scope="module")
def jax_tts():
    """The JAX pipeline over the tiny T3 and the synthesis half of S3Gen
    (no voice encoder, CAMPPlus or S3 tokenizer: this slice has none)."""
    from chatterbox_tpu.models.s3gen.s3gen import RefDict
    from chatterbox_tpu.pipeline.conditionals import Conditionals, T3CondData
    from chatterbox_tpu.pipeline.tts import ChatterboxTTS

    rng = np.random.default_rng(5)
    conds = Conditionals(
        T3CondData(rng.standard_normal((1, 256)).astype(np.float32),
                   rng.integers(0, 6561, (1, 150)).astype(np.int32),
                   np.full((1,), 0.5, np.float32)),
        RefDict(*ref_inputs(6)),
    )
    return ChatterboxTTS(t3_params=t3_params()[0], s3gen_params=s3gen_params()[0], ve_params={},
                         tokenizer=None, t3_cfg=J_T3, s3gen_cfg=J_S3GEN, conds=conds)


@pytest.fixture(scope="module")
def native_dir(jax_tts, tmp_path_factory):
    out = tmp_path_factory.mktemp("native")
    jax_tts.save_native(out)
    return out


def test_load_native_matches_save_native(native_dir):
    """load_native on the JAX package's save_native output gives the
    tensors from_jax_tree gives for the same params."""
    from chatterbox_tpu.checkpoint.pytree_io import load_params

    for name in ("t3", "s3gen"):
        jtree = np_tree(load_params(native_dir / f"{name}.jax.safetensors", device_put=False))
        want = dict(_leaves(weights.from_jax_tree(jtree)))
        got = dict(_leaves(weights.load_native(native_dir / f"{name}.jax.safetensors")))
        assert got.keys() == want.keys(), name
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            assert torch.equal(got[k], w), k


def test_load_native_tree_keys(tmp_path):
    """'#i' segments are list indices and '@none' a None leaf, as the JAX
    package's save_params writes them."""
    from chatterbox_tpu.checkpoint.pytree_io import save_params

    tree = {"xs": [{"scale": np.ones(4, np.float32)}, {"scale": np.zeros(4, np.float32)}],
            "none": None, "ids": np.arange(6, dtype=np.int32)}
    save_params(tree, tmp_path / "p.jax.safetensors")
    got = weights.load_native(tmp_path / "p.jax.safetensors")
    assert isinstance(got["xs"], list) and len(got["xs"]) == 2
    np.testing.assert_array_equal(got["xs"][1]["scale"].numpy(), np.zeros(4))
    assert got["none"] is None
    np.testing.assert_array_equal(got["ids"].numpy(), np.arange(6))


def test_load_native_bf16_is_bit_exact(tmp_path):
    """A BF16 payload is read as uint16 and viewed as bfloat16: no float
    round trip, and the linear layout change still applies."""
    import json
    import struct

    bits = np.random.default_rng(0).integers(0, 2**16, (3, 5)).astype(np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0  # no inf/nan patterns
    header = json.dumps({"a/w": {"dtype": "BF16", "shape": [3, 5],
                                 "data_offsets": [0, bits.nbytes]}}).encode()
    with open(tmp_path / "b.jax.safetensors", "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header + bits.tobytes())
    got = weights.load_native(tmp_path / "b.jax.safetensors")["a"]["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (5, 3)
    np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), bits.T)


def test_safetensors_round_trip(tmp_path):
    rng = np.random.default_rng(1)
    tensors = {"f": rng.standard_normal((2, 3)).astype(np.float32),
               "i": rng.integers(0, 9, (4,)).astype(np.int32)}
    save_safetensors(tensors, tmp_path / "x.safetensors", metadata={"k": 1})
    got, bf16 = load_safetensors(tmp_path / "x.safetensors")
    assert not bf16
    for k, v in tensors.items():
        np.testing.assert_array_equal(got[k], v)


def test_conditionals_load_jax_save(jax_tts, native_dir):
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    c = Conditionals.load(native_dir / "conds.safetensors")
    j = jax_tts.conds
    np.testing.assert_array_equal(c.t3.speaker_emb.numpy(), np.asarray(j.t3.speaker_emb))
    np.testing.assert_array_equal(c.t3.prompt_tokens.numpy(), np.asarray(j.t3.prompt_tokens))
    np.testing.assert_array_equal(c.gen.prompt_feat.numpy(), np.asarray(j.gen.prompt_feat))
    assert c.gen.prompt_token.dtype == torch.int32


def test_conditionals_save_loads_in_jax(native_dir, tmp_path):
    """The port's Conditionals.save writes what the JAX package's
    Conditionals.load reads back bit for bit, with the same dtypes."""
    from chatterbox_tpu.pipeline.conditionals import Conditionals as JConditionals
    from chatterbox_tpu_torch.pipeline.conditionals import Conditionals

    c = Conditionals.load(native_dir / "conds.safetensors")
    c.save(tmp_path / "conds.safetensors")
    back = JConditionals.load(tmp_path / "conds.safetensors")
    for mine, theirs in ((c.t3, back.t3), (c.gen, back.gen)):
        for a, b in zip(mine, theirs):
            assert a.numpy().dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_load_configs_reads_jax_config(native_dir):
    from chatterbox_tpu_torch.checkpoint.config_io import load_configs

    t3_cfg, s3_cfg, ve_cfg = load_configs(native_dir / "config.json")
    assert t3_cfg == P_T3
    assert s3_cfg == P_S3GEN
    assert ve_cfg == type(P_VE)()


def test_port_init_shapes_match_jax_init():
    """The port's own seeded inits build the same tree of shapes as the JAX
    init_* functions give after the bridge (the conditioning modules' trees
    are the JAX inits' own, filled from numpy: torch_parity.cond_params)."""
    _, pt = t3_params()
    _, ps = s3gen_params()
    _, pc = cond_params()
    mine_t3 = weights.init_t3(P_T3, seed=0)
    mine_s3 = {"flow": weights.init_flow(P_S3GEN.flow, 1), "hift": weights.init_hift(P_S3GEN.hift, 2)}
    mine_c = {"campplus": weights.init_campplus(P_S3GEN.campplus, 3),
              "tokenizer": weights.init_s3tokenizer(P_S3GEN.tokenizer, 4),
              "ve": weights.init_voice_encoder(P_VE, 5)}
    for mine, ref in ((mine_t3, pt), (mine_s3, ps), (mine_c, pc)):
        a = {k: tuple(v.shape) for k, v in _leaves(mine)}
        b = {k: tuple(v.shape) for k, v in _leaves(ref)}
        assert a == b


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------


def _port_sources():
    """The port, chip_smoke.py and the test helpers chip_smoke.py imports."""
    return sorted((REPO / "chatterbox_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_reference_format.py",
        REPO / "tests" / "torch_perth_ref.py"]


def test_port_sources_import_no_jax():
    """No module of the port (serve/ and pipeline/streaming.py included) and
    no line of chip_smoke.py imports JAX, the JAX package, bench.py, or
    pydantic and fastapi, which the card's machine does not have."""
    bad = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|import\s+chatterbox_tpu\b(?!_torch)"
                     r"|from\s+chatterbox_tpu\b(?!_torch)|import\s+chatterbox_tpu\.|from\s+chatterbox_tpu\."
                     r"|(import|from)\s+(pydantic|fastapi|bench)\b)",
                     re.M)
    sources = _port_sources()
    assert REPO / "chatterbox_tpu_torch" / "pipeline" / "streaming.py" in sources
    assert REPO / "chatterbox_tpu_torch" / "serve" / "server.py" in sources
    for mod in ("train/losses.py", "train/train_step.py", "train/trainer.py",
                "runtime/profiling.py"):
        assert REPO / "chatterbox_tpu_torch" / mod in sources, mod
    hits = [f"{p}: {m.group(0).strip()}" for p in sources
            for m in bad.finditer(p.read_text())]
    assert not hits, hits


def test_port_runs_without_jax_in_a_fresh_process():
    code = """
import sys, torch
from chatterbox_tpu_torch import ChatterboxTTS, ChatterboxVC
from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict, S3GenConfig
from chatterbox_tpu_torch.models.s3gen.xvector import CAMPPlusConfig
from chatterbox_tpu_torch.models.s3tokenizer import S3TokenizerConfig
from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig
from chatterbox_tpu_torch.pipeline.audio import synthetic_voice
from chatterbox_tpu_torch.models.s3gen.flow import FlowConfig
from chatterbox_tpu_torch.models.s3gen.hifigan import HiFTConfig
from chatterbox_tpu_torch.models.s3gen.conformer import ConformerConfig
from chatterbox_tpu_torch.models.s3gen.unet import UNetConfig
from chatterbox_tpu_torch.models.t3.t3 import T3Config
from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData
t3 = T3Config(llama=LlamaConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                num_attention_heads=2, num_key_value_heads=2, head_dim=16))
s3 = S3GenConfig(flow=FlowConfig(input_size=64, encoder=ConformerConfig(
    input_size=64, output_size=64, attention_heads=2, linear_units=64, num_blocks=1,
    num_up_blocks=1), estimator=UNetConfig(channels=32, n_blocks=1, num_mid_blocks=1,
    num_heads=2), n_timesteps=2), hift=HiFTConfig(base_channels=32, f0_cond_channels=32),
    campplus=CAMPPlusConfig(growth_rate=8, bn_size=2, init_channels=16, m_channels=8,
                            block_layers=(1, 1, 1)),
    tokenizer=S3TokenizerConfig(n_state=32, n_head=2, n_layer=1))
tts = ChatterboxTTS.from_random(seed=0, t3_cfg=t3, s3gen_cfg=s3, device="cpu",
                                ve_cfg=VoiceEncoderConfig(hidden_size=16, num_layers=1))
g = torch.Generator().manual_seed(0)
conds = Conditionals(
    T3CondData(torch.randn(1, 256, generator=g), torch.zeros(1, 150, dtype=torch.int32),
               torch.full((1,), 0.5)),
    RefDict(torch.zeros(1, 4, dtype=torch.int32), torch.tensor([4], dtype=torch.int32),
            torch.zeros(1, 8, 80), torch.randn(1, 192, generator=g)))
w = tts.generate("Hi.", conds=conds, max_new_tokens=4)
assert w.shape[0] == 1 and w.shape[1] % 960 == 0, w.shape
c = tts.prepare_conditionals(synthetic_voice(0, 1.0, 24000))
assert tuple(c.t3.prompt_tokens.shape) == (1, 25) and tuple(c.gen.prompt_feat.shape) == (1, 50, 80)
vc = ChatterboxVC(tts.s3gen_params, "cpu", s3)
v = vc.generate(synthetic_voice(1, 0.5, 16000), target_voice_path=None if vc.set_target_voice(
    synthetic_voice(2, 0.8, 24000)) is None else None)
assert v.shape == (1, 13 * 960), v.shape
import chatterbox_tpu_torch.serve.server
import chatterbox_tpu_torch.train.trainer, chatterbox_tpu_torch.train.losses
import chatterbox_tpu_torch.runtime.profiling
import tempfile
sys.path.insert(0, "tests")
import torch_reference_format as rf
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.pipeline import tts as tts_mod
trees = [weights.to_jax_tree(p) for p in (tts.t3_params, tts.s3gen_params, tts.ve_params)]
tts_mod.T3Config, tts_mod.S3GenConfig = (lambda: t3), (lambda: s3)
tts_mod.VoiceEncoderConfig = lambda: tts.ve_cfg
with tempfile.TemporaryDirectory() as d:
    rf.write_reference_set(d, *trees, conds=[x.numpy() for x in (*conds.t3, *conds.gen)])
    back = ChatterboxTTS.from_local(d, device="cpu")
def leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in leaves(v)]
    return [tree]
for name in ("t3_params", "s3gen_params", "ve_params"):
    got, want = leaves(getattr(back, name)), leaves(getattr(tts, name))
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)), name
from chatterbox_tpu_torch.pipeline.streaming import StreamConfig, stream_generate
chunks = list(stream_generate(tts, "Two ticks.", conds=conds, min_new_tokens=7,
                              stream=StreamConfig(chunk_tokens=4, first_chunk_tokens=0,
                                                  max_new_tokens=8)))
assert len(chunks) == 2 and all(0 < len(c) <= 4 * 960 and len(c) % 960 == 0
                                for c in chunks), [len(c) for c in chunks]
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "chatterbox_tpu" or m.startswith("chatterbox_tpu.")
             or m.split(".")[0] in ("pydantic", "fastapi", "bench"))
assert not bad, bad
print("OK")
"""
    env = {**os.environ, "OMP_NUM_THREADS": "1"}  # one of 6 test workers: see torch_parity
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("OK"), out.stderr[-3000:]


@pytest.mark.parametrize("entry", ["from_random", "from_native", "from_local", "from_pretrained",
                                   "vc_from_random", "vc_from_native", "vc_from_local",
                                   "tts_service", "t3_trainer"])
def test_entry_points_raise_without_a_gpu_and_no_device(entry, native_dir, monkeypatch,
                                                        tmp_path):
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC
    from chatterbox_tpu_torch.serve.config import ServerConfig
    from chatterbox_tpu_torch.serve.service import TTSService
    from chatterbox_tpu_torch.train.trainer import T3Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if entry == "from_random":
            ChatterboxTTS.from_random(seed=0, t3_cfg=P_T3, s3gen_cfg=P_S3GEN)
        elif entry == "from_native":
            ChatterboxTTS.from_native(native_dir)
        elif entry == "from_local":  # the device is resolved before any file is read
            ChatterboxTTS.from_local(tmp_path)
        elif entry == "from_pretrained":
            ChatterboxTTS.from_pretrained(tmp_path)
        elif entry == "vc_from_random":
            ChatterboxVC.from_random(seed=0, s3gen_cfg=P_S3GEN)
        elif entry == "vc_from_native":
            ChatterboxVC.from_native(native_dir)
        elif entry == "vc_from_local":
            ChatterboxVC.from_local(tmp_path)
        elif entry == "t3_trainer":
            T3Trainer(P_T3, weights.init_t3(P_T3, seed=0))
        else:  # the server's "auto" device is the card, never the CPU
            TTSService(ServerConfig(device="auto", voice_storage_path=str(tmp_path / "v"),
                                    config_storage_path=str(tmp_path / "c"),
                                    cache_path=str(tmp_path / "k"),
                                    output_path=str(tmp_path / "o")))


def test_vc_runs_where_asked(native_dir):
    """Given a device, ChatterboxVC builds there; the native directory's
    config gives its S3Gen config."""
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    vc = ChatterboxVC.from_native(native_dir, device="cpu")
    assert vc.device == torch.device("cpu") and vc.s3gen_cfg == P_S3GEN
    assert ChatterboxVC.from_random(seed=0, s3gen_cfg=P_S3GEN, device="cpu").ref_dict is None


def test_kernel_wrappers_raise_on_cuda_without_a_build(monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises; with no
    nvcc the build raises instead of falling back to the plain version."""
    from chatterbox_tpu_torch.ops import _build

    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build(("flash_decode",), force=True)
