"""The port's synthetic weights (``runtime/fast_init.py``) against the JAX
package's ``synthetic_init`` on the CPU, at the tiny configs of
``torch_parity.py``: the same leaves in the same order, shapes and dtypes,
and each leaf's elements equal on a share of at least 0.97 (measured: 1.0
on every leaf of T3, S3Gen and the voice encoder, with the native
library's libm sine; each 1-D leaf's salt and each 2-D leaf's fan-in are
the JAX package's, in its layouts)."""

import numpy as np
import pytest
import torch

import jax

from chatterbox_tpu.models import voice_encoder as j_ve_mod
from chatterbox_tpu.models.s3gen import s3gen as j_s3gen_mod
from chatterbox_tpu.runtime.fast_init import synthetic_init as j_synthetic_init
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS, random_s3gen
from chatterbox_tpu_torch.runtime import fast_init
from torch_parity import J_S3GEN, J_T3, P_S3GEN, P_T3, j_t3, p_ve

SHARE = 0.97  # each leaf's share of elements equal to the JAX package's
STD_RTOL = 0.02

_JAX = {
    "t3": lambda: j_synthetic_init(lambda k: j_t3.init_t3(k, J_T3)),
    "s3gen": lambda: j_synthetic_init(lambda k: j_s3gen_mod.init_s3gen(k, J_S3GEN)),
    "ve": lambda: j_synthetic_init(j_ve_mod.init_voice_encoder),
}
_PORT = {
    "t3": lambda d: weights.init_t3(P_T3, 0, d),
    "s3gen": lambda d: random_s3gen(P_S3GEN, 0, d),
    "ve": lambda d: weights.init_voice_encoder(p_ve.VoiceEncoderConfig(), 0, d),
}


def _jax_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return [(jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


def _port_leaves(tree):
    return [("".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path), x)
            for path, x in fast_init._leaves(weights.to_jax_tree(tree))]


@pytest.fixture(scope="module", params=sorted(_JAX))
def both(request):
    name = request.param
    return name, _jax_leaves(_JAX[name]()), _port_leaves(
        fast_init.synthetic_init(_PORT[name], device="cpu"))


def test_synthetic_init_matches_jax_leaf_by_leaf(both):
    name, want, got = both
    assert [p for p, _ in got] == [p for p, _ in want]
    shares = []
    for (path, g), (_, w) in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, path
        share = float((g == w).mean())
        shares.append(share)
        assert share >= SHARE, (path, share)
        if g.size > 1:
            np.testing.assert_allclose(g.std(), w.std(), rtol=STD_RTOL, err_msg=path)
    print(f"{name}: {len(shares)} leaves, share min {min(shares):.4f} mean {np.mean(shares):.4f}")


def test_salt_and_fan_in_are_taken_in_the_jax_layout():
    """A (L, Cout, Cin) T3 weight is scaled by 1 / sqrt(L * Cin) (its JAX
    layout's fan-in, not the port's L * Cout), and every leaf's salt is its
    index in the JAX order."""
    tree = fast_init.synthetic_init(_PORT["t3"], device="cpu")
    order = [p for p, _ in fast_init._leaves(weights.jax_layout(tree))]
    idx = order.index(("llama", "layers", "gate_up", "w"))
    w = weights.jax_layout(tree)["llama"]["layers"]["gate_up"]["w"]  # (L, C, 2F)
    std = 1.0 / np.sqrt(w.shape[0] * w.shape[1])
    want = fast_init._synth_leaf(tuple(w.shape), torch.float32, float(idx % 97), std, "cpu")
    assert torch.equal(w, want)
    assert w.abs().max() <= 1.7 * std


def test_without_the_native_sine_most_elements_still_agree(monkeypatch):
    """Without the library (and on the card) the sine is the correctly rounded
    one: on the CPU it meets XLA's libm sine on ~99% of a large leaf's
    elements; the whole tree must agree on the share."""
    monkeypatch.setattr(fast_init, "sinf", lambda x: None)
    want = _jax_leaves(_JAX["t3"]())
    got = _port_leaves(fast_init.synthetic_init(_PORT["t3"], device="cpu"))
    equal = sum(int((g == w).sum()) for (_, g), (_, w) in zip(got, want))
    total = sum(w.size for _, w in want)
    assert equal / total >= SHARE, equal / total


def test_from_random_synthetic_builds_the_synthetic_weights():
    """``from_random(seed, t3_cfg, s3gen_cfg, True)``, positionally as in the
    JAX package: every leaf the synthetic one, finite, T3 fp32 on the CPU."""
    tts = ChatterboxTTS.from_random(0, P_T3, P_S3GEN, True, device="cpu")
    want = fast_init.synthetic_init(_PORT["t3"], device="cpu")
    for (path, g), (_, w) in zip(fast_init._leaves(tts.t3_params), fast_init._leaves(want)):
        assert torch.equal(g, w), path
    s3 = fast_init.synthetic_init(_PORT["s3gen"], device="cpu")
    for (path, g), (_, w) in zip(fast_init._leaves(tts.s3gen_params), fast_init._leaves(s3)):
        assert torch.equal(g, w) and torch.isfinite(g).all(), path
    assert tts.t3_params["speech_emb"]["w"].dtype == torch.float32
