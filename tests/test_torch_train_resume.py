"""The port's ``T3Trainer`` against the JAX package's, and checkpoints that
resume across both packages (CPU, fp32, the tiny T3 of ``torch_parity``).

One JAX run and one port run, each of 4 steps on 4 seeded batches with a
checkpoint after step 2, are shared by the tests:
- the port's 4 steps against JAX's: losses rtol 1e-5 (1.1e-7), params to
  lr/20 (3.1e-5), looser than lr/100 for a reason: Adam divides each
  gradient element by sqrt(nu) + 1e-8, so where an element is near 1e-8
  the two sides' rounding of it (1e-6 of its leaf's max, see
  ``test_torch_train.py``) moves that element's update by a share of lr;
  one step stays under lr/100 there, four do not;
- a JAX file resumed by the port and a port file loaded by the JAX
  ``T3Trainer.load``, each run 2 more steps: against JAX's 4 steps with the
  same tolerances (losses 1.1e-7 and 0, params 6.7e-7 and 3.1e-5), and the
  restored state equal to the saved one bit for bit;
- the port's own 2 + 2 resume against its 4 straight steps: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import J_T3, P_T3, assert_close, t3_params
from test_torch_train import LR, as_jax, jax_leaves, port_leaves, t3_batch

from chatterbox_tpu.train.trainer import T3Trainer as JTrainer
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
from chatterbox_tpu_torch.models.t3.t3 import T3Config
from chatterbox_tpu_torch.train.trainer import T3Trainer as PTrainer

BATCHES = [t3_batch(10 + i) for i in range(4)]


def jax_params():
    return jax.tree.map(jnp.asarray, t3_params(0)[0])


def port_params():
    return weights.from_jax_tree(t3_params(0)[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' 4-step runs, each saving after step 2."""
    d = tmp_path_factory.mktemp("train")
    jt = JTrainer(J_T3, jax_params(), learning_rate=LR)
    j_losses = [jt.step(as_jax(b)) for b in BATCHES[:2]]
    jt.save(d / "jax.safetensors")
    j_losses += [jt.step(as_jax(b)) for b in BATCHES[2:]]
    pt = PTrainer(P_T3, port_params(), learning_rate=LR, device="cpu")
    p_losses = [pt.step(b) for b in BATCHES[:2]]
    pt.save(d / "port.safetensors")
    p_losses += [pt.step(b) for b in BATCHES[2:]]
    return {"dir": d, "jax": (j_losses, jt), "port": (p_losses, pt)}


def assert_like_jax(losses, trainer, j_losses, j_trainer):
    assert [sorted(m) for m in losses] == [sorted(m) for m in j_losses]
    for m, w in zip(losses, j_losses):
        for k in w:
            assert_close(m[k], w[k], 0.0, 1e-5, k)
    got = list(port_leaves(trainer.params).values())
    for g, w in zip(got, jax_leaves(j_trainer.params)):
        assert_close(g, w, LR / 20)
    assert int(trainer.opt_state.count) == int(j_trainer.opt_state[0].count) == 4


def test_port_trainer_matches_jax_trainer(runs):
    (p_losses, pt), (j_losses, jt) = runs["port"], runs["jax"]
    assert pt.step_num == jt.step_num == 4
    assert all(isinstance(v, float) for m in p_losses for v in m.values())
    assert_like_jax(p_losses, pt, j_losses, jt)


def test_jax_checkpoint_resumes_in_the_port(runs):
    path = runs["dir"] / "jax.safetensors"
    pt = PTrainer.resume(path, P_T3, weights.init_t3(P_T3, seed=7), learning_rate=LR,
                         device="cpu")
    assert pt.step_num == 2 and int(pt.opt_state.count) == 2
    # the restored state is the file's, leaf for leaf
    from chatterbox_tpu.checkpoint.safetensors_io import load_safetensors

    saved = load_safetensors(path)
    for i, x in enumerate(pt._leaves()):
        assert np.array_equal(np.reshape(saved[f"leaf_{i:05d}"], x.shape), x), i
    losses = runs["jax"][0][:2] + [pt.step(b) for b in BATCHES[2:]]
    assert_like_jax(losses, pt, *runs["jax"])


def test_port_checkpoint_loads_in_the_jax_trainer(runs):
    path = runs["dir"] / "port.safetensors"
    jt = JTrainer(J_T3, jax_params(), learning_rate=LR)
    jt.load(path)
    assert jt.step_num == 2 and int(jt.opt_state[0].count) == 2
    from chatterbox_tpu_torch.checkpoint.safetensors_io import load_safetensors

    saved, _ = load_safetensors(path)
    for i, x in enumerate(jax.tree_util.tree_leaves((jt.params, jt.opt_state))):
        assert np.array_equal(np.asarray(x).reshape(-1), saved[f"leaf_{i:05d}"].reshape(-1)), i
    losses = runs["port"][0][:2] + [jt.step(as_jax(b)) for b in BATCHES[2:]]
    # the JAX trainer continues the port's run: hold it against JAX's own
    j_losses, j_trainer = runs["jax"]
    for m, w in zip(losses[2:], j_losses[2:]):
        for k in w:
            assert_close(m[k], w[k], 0.0, 1e-5, k)
    for g, w in zip(jax_leaves(jt.params), jax_leaves(j_trainer.params)):
        assert_close(g, w, LR / 20)


def test_port_resume_is_bit_identical(runs):
    p_losses, pt = runs["port"]
    rt = PTrainer.resume(runs["dir"] / "port.safetensors", P_T3, port_params(),
                         learning_rate=LR, device="cpu")
    resumed = [rt.step(b) for b in BATCHES[2:]]
    assert resumed == p_losses[2:]
    assert torch.equal(rt.opt_state.count, pt.opt_state.count)
    for a, b in zip((rt.params, rt.opt_state.mu, rt.opt_state.nu),
                    (pt.params, pt.opt_state.mu, pt.opt_state.nu)):
        for x, y in zip(port_leaves(a).values(), port_leaves(b).values()):
            assert np.array_equal(x, y)


def test_donate_false_leaves_the_callers_tensors():
    params = port_params()
    before = {k: v.copy() for k, v in port_leaves(params).items()}
    kept = PTrainer(P_T3, params, learning_rate=LR, donate=False, device="cpu")
    kept.step(BATCHES[0])
    assert all(np.array_equal(port_leaves(params)[k], v) for k, v in before.items())
    donated = PTrainer(P_T3, params, learning_rate=LR, device="cpu")
    donated.step(BATCHES[0])
    assert donated.params["llama"]["layers"]["q"]["w"] is params["llama"]["layers"]["q"]["w"]
    assert not np.array_equal(port_leaves(params)["llama/layers/q/w"],
                              before["llama/layers/q/w"])


def _deeper():
    cfg = T3Config(llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=3,
                                     num_attention_heads=2, num_key_value_heads=2, head_dim=32))
    return cfg, weights.init_t3(cfg, seed=0)


def _transposed():
    params = port_params()
    w = params["text_head"]["w"]
    params["text_head"]["w"] = w.t().contiguous()  # same size, another shape
    return P_T3, params


def _extra_leaf():
    params = port_params()
    params["text_head"]["b"] = torch.zeros(params["text_head"]["w"].shape[0])
    return P_T3, params


@pytest.mark.parametrize("case", ["deeper_config", "same_size_other_shape", "extra_leaf"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_load_rejects_a_mismatched_template(runs, case, writer):
    """The JAX ``load``'s two refusals (test_checkpoint.py:156-200), and a
    leaf count that differs, on either package's file."""
    cfg, params = {"deeper_config": _deeper, "same_size_other_shape": _transposed,
                   "extra_leaf": _extra_leaf}[case]()
    tr = PTrainer(cfg, params, learning_rate=LR, device="cpu")
    with pytest.raises(ValueError, match="leaves" if case == "extra_leaf" else "shape"):
        tr.load(runs["dir"] / f"{writer}.safetensors")
