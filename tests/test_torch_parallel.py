"""The port's data and tensor parallelism (``chatterbox_tpu_torch/parallel``,
``with_mesh``, the sharded train step) on the CPU: four ``gloo`` processes
(``torch_parallel_worker.py``, which imports no JAX), started once for the
module; every reference is computed here, the JAX side on the 8 virtual
CPU devices that ``conftest.py`` sets up.

- shards: each rank's ``shard_params`` piece on a (2, 2) mesh equals, in
  the JAX layout, the device shard of the JAX ``shard_params(params,
  make_mesh((4, 2)), t3_param_specs(params))`` at its "model" coordinate
  (``gate_up``: the JAX shards of its gate and up halves, side by side, as
  the port splits each half);
- tp=2 on (2, 2): T3 tokens equal to the JAX ``t3_generate`` on one device
  (the JAX key chain's uniforms injected), with and without the watchdog;
- the sharded train step (dp=2 x tp=2) against the port's one-device
  ``train_step`` on the same whole batch; a ``T3Trainer`` checkpoint saved
  over the mesh loads on one device;
- data-parallel TTS ``generate_batch`` and VC on (4, 1) against the port's
  single call: tokens exact, wavs at the JAX gate's ``atol=2e-3``
  (``tests/test_sharding.py``);
- ``dryrun_multichip(4)``.
"""

import dataclasses
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chatterbox_tpu.core.sampling import SamplingConfig as JSampling
from chatterbox_tpu.models.t3 import t3 as jt
from chatterbox_tpu.parallel.sharding import make_mesh as j_make_mesh
from chatterbox_tpu.parallel.sharding import shard_params as j_shard_params
from chatterbox_tpu.parallel.sharding import t3_param_specs as j_t3_param_specs
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.checkpoint.pytree_io import flatten, unflatten
from chatterbox_tpu_torch.pipeline.audio import synthetic_voice
from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData
from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS
from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC
from chatterbox_tpu_torch.models.s3gen.hifigan import HiFTConfig
from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict
from chatterbox_tpu_torch.train.trainer import T3Trainer
from chatterbox_tpu_torch.train.train_step import make_t3_train_step
from torch_parity import (J_T3, P_S3GEN, P_T3, eos_boosted_t3_params, jax_uniforms,
                          ref_inputs)

WORLD = 4
TIMEOUT_S = 420
MAX_NEW = 24
SEED = 11
LR = 1e-4
WAV_ATOL = 2e-3  # tests/test_sharding.py's gate
J_CFG = dataclasses.replace(J_T3, alignment_layer=1)
P_CFG = dataclasses.replace(P_T3, alignment_layer=1)
# a narrow vocoder: at HiFT's full width the single calls alone take ~45 s
S3_CFG = dataclasses.replace(P_S3GEN, hift=HiFTConfig(base_channels=32, f0_cond_channels=32))
TEXTS = [f"Sentence number {i}, {'and more ' * i}." for i in range(8)]
TTS_KW = dict(max_new_tokens=16, seed=2)


def gen_inputs():
    """4 rows of framed text ids (lengths 9, 5, 14, 7) and conditioning."""
    rng = np.random.default_rng(3)
    lens = np.array([9, 5, 14, 7], np.int32)
    text = np.zeros((4, 16), np.int32)
    for i, n in enumerate(lens):
        text[i, 0], text[i, n - 1] = J_T3.start_text_token, J_T3.stop_text_token
        text[i, 1:n - 1] = rng.integers(1, 700, n - 2)
    return (text, lens, rng.standard_normal((4, 256)).astype(np.float32),
            rng.integers(0, 6561, (4, 150)).astype(np.int32), np.full((4,), 0.5, np.float32))


def train_batch():
    rng = np.random.default_rng(5)
    return {
        "speaker_emb": torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32)),
        "prompt_tokens": torch.from_numpy(rng.integers(0, 8194, (4, 150)).astype(np.int32)),
        "emotion_adv": torch.from_numpy(rng.uniform(0.3, 0.7, (4,)).astype(np.float32)),
        "text_tokens": torch.from_numpy(rng.integers(0, 704, (4, 16)).astype(np.int32)),
        "text_lens": torch.tensor([16, 11, 7, 14], dtype=torch.int32),
        "speech_tokens": torch.from_numpy(rng.integers(0, 8194, (4, 24)).astype(np.int32)),
        "speech_lens": torch.tensor([24, 17, 9, 20], dtype=torch.int32),
    }


def conds_arrays():
    rng = np.random.default_rng(9)
    return (rng.standard_normal((1, 256)).astype(np.float32),
            rng.integers(0, 6561, (1, 150)).astype(np.int32), np.full((1,), 0.5, np.float32),
            *ref_inputs(10))


def conditionals(c):
    x = [torch.from_numpy(np.asarray(a)) for a in c]
    return Conditionals(T3CondData(*x[:3]), RefDict(*x[3:]))


def clone(tree):
    return unflatten({k: v.clone() for k, v in flatten(tree).items()})


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the four ranks, compute the references meanwhile, and return
    (inputs, references, the ranks' outputs)."""
    out_dir = tmp_path_factory.mktemp("parallel")
    jp, pp = eos_boosted_t3_params()
    gen = gen_inputs()
    rng = np.random.default_rng(12)
    inp = {
        "t3_params": pp, "t3_cfg": P_CFG, "s3gen_cfg": S3_CFG, "gen": gen,
        "uniforms": jax_uniforms(SEED, MAX_NEW, 4), "max_new": MAX_NEW,
        "batch": train_batch(), "texts": TEXTS, "conds": conds_arrays(), "tts_kw": TTS_KW,
        "sources": [synthetic_voice(30 + i, float(rng.uniform(0.4, 1.0)), 16000)
                    for i in range(8)],
        "target": synthetic_voice(40, 1.0, 24000),
    }
    torch.save(inp, out_dir / "inputs.pt")
    here = Path(__file__).resolve().parent
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(here.parent), str(here)])}
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(here / "torch_parallel_worker.py"), str(r),
                               str(WORLD), str(port), str(out_dir)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(WORLD)]
    try:
        ref = references(jp, pp, inp)
        logs = [p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    outs = [torch.load(out_dir / f"out_{r}.pt", weights_only=False) for r in range(WORLD)]
    return inp, ref, outs, out_dir


def references(jp, pp, inp):
    ref = {}
    jparams = jax.tree.map(jnp.asarray, jp)
    args = [jnp.asarray(x) for x in inp["gen"]]
    for align in (False, True):
        res = jt.t3_generate(jparams, J_CFG, *args, jax.random.PRNGKey(SEED), JSampling(),
                             MAX_NEW, alignment=align)
        ref[f"tokens_{align}"] = np.asarray(res.tokens)
    mesh = j_make_mesh((4, 2), jax.devices()[:8])
    ref["jax_mesh"] = mesh
    ref["jax_shards"] = j_shard_params(jp, mesh, j_t3_param_specs(jp))
    gu = jp["llama"]["layers"]["gate_up"]["w"]
    f = gu.shape[-1] // 2
    spec = j_t3_param_specs(jp)["llama"]["layers"]["gate_up"]["w"]
    ref["jax_gate_up"] = j_shard_params({"g": gu[..., :f], "u": gu[..., f:]}, mesh,
                                        {"g": spec, "u": spec})

    params = clone(pp)
    init_state, step = make_t3_train_step(P_CFG, LR)
    before = clone(params)
    params, _, metrics = step(params, init_state(params), inp["batch"])
    ref["train"] = (before, params, {k: float(v) for k, v in metrics.items()})

    tts = ChatterboxTTS.from_random(seed=0, t3_cfg=P_CFG, s3gen_cfg=S3_CFG, device="cpu")
    ref["tts_wavs"] = tts.generate_batch(TEXTS, conditionals(inp["conds"]), **TTS_KW)
    ref["tts_tokens"] = tts.last_speech_tokens
    vc = ChatterboxVC.from_random(seed=0, s3gen_cfg=S3_CFG, device="cpu")
    vc.set_target_voice(inp["target"])
    ref["vc_wavs"] = vc.generate_batch(inp["sources"], seed=4)
    return ref


def _device_shard(arr, device):
    return next(np.asarray(s.data) for s in arr.addressable_shards if s.device == device)


def test_shard_params_equal_jax_device_shards(run):
    _, ref, outs, _ = run
    mesh = ref["jax_mesh"]
    want_tree = jax.tree_util.tree_flatten_with_path(ref["jax_shards"])[0]
    for out in outs:
        d, m = out["coords"]
        dev = mesh.devices[0, m]  # the (4, 2) mesh's shard at this "model" coordinate
        got = flatten(weights.to_jax_tree(out["shards"]))
        assert len(got) == len(want_tree)
        for (path, arr), (key, g) in zip(want_tree, got.items()):
            if key == "llama/layers/gate_up/w":
                w = np.concatenate([_device_shard(ref["jax_gate_up"][h], dev) for h in "gu"], -1)
            else:
                w = _device_shard(arr, dev)
            assert g.shape == w.shape and np.array_equal(g, w), (key, m)
    heads = flatten(weights.to_jax_tree(outs[0]["shards"]))["speech_head/w"]
    assert heads.shape[-1] == 8194 // 2


@pytest.mark.parametrize("alignment", [False, True])
def test_tensor_parallel_t3_tokens_equal_jax(run, alignment):
    """tp=2 (one head of two a rank, the FFN and both vocabularies split) on
    (2, 2): every rank's gathered tokens equal the JAX one-device call's."""
    _, ref, outs, _ = run
    want = ref[f"tokens_{alignment}"]
    assert (want == J_T3.stop_speech_token).any()  # rows stop at different steps
    for out in outs:
        key = "tp_tokens_align" if alignment else "tp_tokens"
        np.testing.assert_array_equal(out[key].numpy(), want)


def test_sharded_train_step_matches_one_device(run):
    """dp=2 x tp=2 on the same whole batch: the token-weighted losses within
    1e-5, and the AdamW update within lr/20 on all but a 1e-3 share of the
    elements (Adam turns a rounding-noise gradient into an update of either
    sign, as path N of ``chip_smoke.py`` found), every element within 2.1 lr."""
    _, ref, outs, _ = run
    before, want, want_m = ref["train"]
    b = flatten(before)
    for out in outs:
        for k in ("loss", "loss_text", "loss_speech"):
            np.testing.assert_allclose(out["train_metrics"][k], want_m[k], rtol=1e-5)
        got = flatten(out["train_params"])
        over = total = 0
        for key, w in flatten(want).items():
            d = ((got[key] - b[key]) - (w - b[key])).abs()
            assert float(d.max()) <= 2.1 * LR, key
            over += int((d > LR / 20).sum())
            total += d.numel()
        assert over / total <= 1e-3, over / total


def test_mesh_trainer_checkpoint_loads_on_one_device(run):
    """A ``T3Trainer`` over the mesh saves the whole state (gathered, rank 0
    writing the JAX trainer's file); a one-device trainer loads it: its
    params are the mesh run's, bit for bit, after one step."""
    inp, _, outs, out_dir = run
    trainer = T3Trainer(P_CFG, clone(inp["t3_params"]), device="cpu")
    trainer.load(out_dir / "mesh_trainer.safetensors")
    assert trainer.step_num == 1 and int(trainer.opt_state.count) == 1
    got, want = flatten(trainer.params), flatten(outs[0]["train_params"])
    for key in want:
        assert torch.equal(got[key], want[key]), key


def _assert_wavs(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=WAV_ATOL)


def test_data_parallel_tts_matches_single_call(run):
    """(4, 1): two texts a rank, each rank's slice of the whole batch's
    sampling and vocoder draws; every rank returns all eight wavs."""
    _, ref, outs, _ = run
    for out in outs:
        assert len(out["tts_tokens"]) == len(ref["tts_tokens"]) == len(TEXTS)
        for g, w in zip(out["tts_tokens"], ref["tts_tokens"]):
            np.testing.assert_array_equal(g, w)
        _assert_wavs(out["tts_wavs"], ref["tts_wavs"])


def test_data_parallel_vc_matches_single_call(run):
    _, ref, outs, _ = run
    for out in outs:
        _assert_wavs(out["vc_wavs"], ref["vc_wavs"])


def test_dryrun_multichip_on_four_ranks(run):
    _, _, outs, _ = run
    lines = {out["dryrun"] for out in outs}
    assert len(lines) == 1
    line = lines.pop()
    assert line.startswith("dryrun_multichip OK: mesh={'data': 2, 'model': 2}") and "gen_wavs=4" in line
