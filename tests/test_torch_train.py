"""The port's training pass (``t3_forward``, ``t3_loss``, the gradient, the
optax AdamW step), ``cfm_loss``, the attention switches that a gradient
needs, the kernel wrappers' refusal of autograd, and ``runtime/profiling``,
held against the JAX package on the CPU in fp32 with the tiny configs of
``torch_parity``. The trainer and its checkpoints are in
``test_torch_train_resume.py``.

Tolerances, with the worst reading on the CPU beside each:
- logits atol 1e-5 (3.0e-7); losses rtol 1e-5 (equal to the last bit);
- gradients leaf by leaf, |port - JAX| <= 1e-5 * max|JAX leaf| (9.1e-7 of
  the leaf max), except the perceiver's key bias: its gradient is 0 in
  exact arithmetic (a bias on every key shifts each query's logits by one
  constant, which the softmax cancels), so both sides hold rounding noise
  (1.6e-12) and it is held to 1e-9 absolute;
- the AdamW step on the same gradients: params, mu and nu to 2.5e-7
  absolute, two fp32 ulps at 1.0 (6.0e-8);
- one whole train step (lr 1e-3): metrics rtol 1e-5 (1.1e-7), mu and nu
  to 1e-7 (5.4e-9), params to lr/100 (1.8e-6);
- cfm_loss: rtol 1e-5 (6.3e-8) with the kernel switch on both sides and
  against the port's dense path, its gradients with the switch off to 1e-4
  of each leaf's max (2.5e-5), and exactly 0 where JAX's is 0 (the
  encoder and the embedding, which the loss does not reach);
- the UNet and the conformer with the switch off: atol and rtol 1e-4, as
  ``test_torch_s3gen.py`` holds them (3.2e-6 and 3.5e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import J_S3GEN, J_T3, P_S3GEN, P_T3, assert_close, flow_params, j, t, t3_params

from chatterbox_tpu.models.s3gen import unet as j_unet
from chatterbox_tpu.models.t3 import t3 as j_t3
from chatterbox_tpu.runtime import profiling as j_prof
from chatterbox_tpu.train import losses as j_losses
from chatterbox_tpu.train.train_step import make_t3_train_step as j_make_step
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.checkpoint.pytree_io import flatten
from chatterbox_tpu_torch.models.s3gen import conformer as p_conformer
from chatterbox_tpu_torch.models.s3gen import unet as p_unet
from chatterbox_tpu_torch.models.t3 import llama as p_llama
from chatterbox_tpu_torch.models.t3 import t3 as p_t3
from chatterbox_tpu_torch.ops import decode_glue as dg
from chatterbox_tpu_torch.ops import flash_attention as fa
from chatterbox_tpu_torch.ops import flash_decode as fd
from chatterbox_tpu_torch.ops import probes as pr
from chatterbox_tpu_torch.ops import ssm_decode as sd
from chatterbox_tpu_torch.runtime import profiling as p_prof
from chatterbox_tpu_torch.train import losses as p_losses
from chatterbox_tpu_torch.train import train_step as p_step

LR = 1e-3
# the perceiver's key bias: a zero gradient in exact arithmetic (see above)
ZERO_GRAD_LEAVES = ("cond_enc/perceiver/attn/to_k/b",)


def t3_batch(seed=0, b=2):
    """A seeded numpy batch with the JAX trainer's keys: right-padded text
    and speech of unequal lengths."""
    rng = np.random.default_rng(seed)
    return {
        "speaker_emb": rng.standard_normal((b, 256)).astype(np.float32),
        "prompt_tokens": rng.integers(0, 8194, (b, 150)).astype(np.int32),
        "emotion_adv": rng.uniform(0.3, 0.7, (b,)).astype(np.float32),
        "text_tokens": rng.integers(0, 704, (b, 16)).astype(np.int32),
        "text_lens": np.array([16, 11][:b], np.int32),
        "speech_tokens": rng.integers(0, 8194, (b, 24)).astype(np.int32),
        "speech_lens": np.array([24, 17][:b], np.int32),
    }


def as_jax(batch):
    return {k: j(v) for k, v in batch.items()}


def as_port(batch):
    return {k: t(v) for k, v in batch.items()}


def port_leaves(tree):
    """{path: numpy} of a port tree, in the JAX package's layout and order."""
    return flatten(weights.to_jax_tree(tree))


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(tree)]


@pytest.fixture(scope="module")
def t3():
    jp, _ = t3_params(0)
    return jp


# ---------------------------------------------------------------------------
# t3_forward, t3_loss, gradients
# ---------------------------------------------------------------------------


def test_t3_forward_matches_jax(t3):
    b = t3_batch(0)
    keys = ("speaker_emb", "prompt_tokens", "emotion_adv", "text_tokens", "text_lens",
            "speech_tokens", "speech_lens")
    want = jax.jit(lambda p, *a: j_t3.t3_forward(p, J_T3, *a))(t3, *(j(b[k]) for k in keys))
    got = p_t3.t3_forward(weights.from_jax_tree(t3), P_T3, *(t(b[k]) for k in keys))
    assert tuple(got[0].shape) == (2, 16, 704) and tuple(got[1].shape) == (2, 24, 8194)
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), 1e-5)


def test_t3_loss_matches_jax(t3):
    b = t3_batch(1)
    want = jax.jit(lambda p, bt: j_t3.t3_loss(p, J_T3, bt))(t3, as_jax(b))
    got = p_t3.t3_loss(weights.from_jax_tree(t3), P_T3, as_port(b))
    for g, w in zip(got, want):
        assert_close(g, np.asarray(w), 0.0, 1e-5)


def test_training_prefill_builds_no_cache(t3):
    """``cache_len=None`` gives the hidden states of the cached prefill and
    no cache."""
    pp = weights.from_jax_tree(t3)["llama"]
    rng = np.random.default_rng(2)
    x = t(rng.standard_normal((2, 12, 64)).astype(np.float32))
    pos = torch.arange(12)[None].repeat(2, 1)
    valid = torch.arange(12)[None] < torch.tensor([[12], [9]])
    h0, cache = p_llama.llama_prefill(pp, P_T3.llama, x, pos, valid, 16)
    h1, none = p_llama.llama_prefill(pp, P_T3.llama, x, pos, valid, None)
    assert none is None and tuple(cache.shape) == (2, 2, 2, 2, 16, 32)
    assert torch.equal(h0, h1)


def test_t3_grads_match_jax(t3):
    """The port's autograd gradient of loss_text + loss_speech against
    ``jax.grad(t3_loss)``, leaf by leaf."""
    b = t3_batch(3)
    want = jax.jit(jax.grad(lambda p, bt: sum(j_t3.t3_loss(p, J_T3, bt))))(t3, as_jax(b))
    loss, lt, ls, grads = p_step.t3_loss_and_grads(weights.from_jax_tree(t3), P_T3, as_port(b))
    assert float(loss) == float(lt) + float(ls)
    got = port_leaves(grads)
    assert len(got) == len(jax_leaves(want))
    for (name, g), w in zip(got.items(), jax_leaves(want)):
        assert g.shape == w.shape, name
        scale = np.abs(w).max()
        if name in ZERO_GRAD_LEAVES:
            assert scale < 1e-9 and np.abs(g).max() < 1e-9, name
        else:
            assert scale > 0, name
            assert np.abs(g - w).max() <= 1e-5 * scale, name


def _jax_step(params, batch, lr=LR):
    init, step = j_make_step(J_T3, lr)
    state = init(params)
    return jax.jit(step)(params, state, as_jax(batch)), state


def test_adamw_update_is_optax_adamw(t3):
    """The port's AdamW on the same gradients and state as ``optax.adamw``:
    two updates, params, count, mu and nu."""
    import optax

    rng = np.random.default_rng(4)
    grads = [jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(x.shape).astype(np.float32)
                                                * 1e-3), t3) for _ in range(2)]
    opt = optax.adamw(LR)
    jp, js = jax.tree.map(jnp.asarray, t3), opt.init(t3)
    pp = weights.from_jax_tree(t3)
    ps = p_step.adamw_init(pp)

    @jax.jit
    def update(g, state, params):
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state

    for g in grads:
        jp, js = update(g, js, jp)
        ps = p_step.adamw_update(pp, ps, weights.from_jax_tree(jax.tree.map(np.asarray, g)), LR)
    assert int(ps.count) == int(js[0].count) == 2 and ps.count.dtype == torch.int32
    for port, jax_tree in ((pp, jp), (ps.mu, js[0].mu), (ps.nu, js[0].nu)):
        for g, w in zip(port_leaves(port).values(), jax_leaves(jax_tree)):
            assert_close(g, w, 2.5e-7)


def test_train_step_matches_jax(t3):
    """One ``train_step`` against ``make_t3_train_step``'s: metrics, params,
    count, mu and nu; the port's step updates its params in place."""
    b = t3_batch(5)
    (jp1, js1, jm), _ = _jax_step(t3, b)
    init, step = p_step.make_t3_train_step(P_T3, LR)
    pp = weights.from_jax_tree(t3)
    before = flatten(pp)["llama/layers/q/w"].clone()
    ps = init(pp)
    pp1, ps1, pm = step(pp, ps, as_port(b))
    assert pp1 is pp and not torch.equal(flatten(pp)["llama/layers/q/w"], before)
    assert sorted(pm) == sorted(jm) == ["loss", "loss_speech", "loss_text"]
    for k in jm:
        assert_close(pm[k], np.asarray(jm[k]), 0.0, 1e-5)
    assert int(ps1.count) == int(js1[0].count) == 1
    for port, jax_tree, tol in ((ps1.mu, js1[0].mu, 1e-7), (ps1.nu, js1[0].nu, 1e-7),
                                (pp1, jp1, LR / 100)):
        for g, w in zip(port_leaves(port).values(), jax_leaves(jax_tree)):
            assert_close(g, w, tol)


# ---------------------------------------------------------------------------
# cfm_loss and the attention switches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flow():
    jp, pp = flow_params()
    return jax.tree.map(jnp.asarray, jp), pp


def cfm_inputs(seed=0, b=3, tt=40):
    rng = np.random.default_rng(seed)
    x1, mu, cond = ((rng.standard_normal((b, tt, 80)) * 0.5).astype(np.float32)
                    for _ in range(3))
    spks = rng.standard_normal((b, 80)).astype(np.float32)
    mask = np.arange(tt)[None] < np.array([tt, 31, 25][:b])[:, None]
    return x1, mask, mu, spks, cond


def jax_draws(key, x1):
    """The draws of the JAX ``cfm_loss`` for ``key``, as it makes them."""
    k_t, k_z, k_cfg = jax.random.split(key, 3)
    b = x1.shape[0]
    return (jax.random.uniform(k_t, (b,)), jax.random.normal(k_z, x1.shape, jnp.float32),
            jax.random.uniform(k_cfg, (b,)))


@pytest.fixture(scope="module")
def cfm_key():
    """A key whose CFG draws keep some rows and drop others (rate 0.2)."""
    x1 = cfm_inputs()[0]
    for seed in range(64):
        keep = np.asarray(jax_draws(jax.random.PRNGKey(seed), x1)[2]) > 0.2
        if keep.any() and not keep.all():
            return jax.random.PRNGKey(seed)
    raise AssertionError("no seed in 0..63 mixes kept and dropped rows")


def _cfm_pair(flow, key, monkeypatch=None):
    x1, mask, mu, spks, cond = cfm_inputs()
    draws = p_losses.CFMDraws(*(t(np.asarray(d)) for d in jax_draws(key, x1)))
    jargs = (j(x1), j(mask), j(mu), j(spks), j(cond))
    pargs = (t(x1), t(mask), t(mu), t(spks), t(cond))
    return jargs, pargs, draws


def test_cfm_loss_matches_jax_with_the_kernel(flow, cfm_key):
    """The kernel switch on in both packages (JAX's Pallas K3 in interpret
    mode, the port's K3 wrapper on its plain version), the same draws."""
    jf, pf = flow
    jargs, pargs, draws = _cfm_pair(flow, cfm_key)
    assert j_unet.FLASH_ATTENTION and p_unet.FLASH_ATTENTION
    want = j_losses.cfm_loss(jf, J_S3GEN.flow, *jargs, cfm_key)
    got = p_losses.cfm_loss(pf, P_S3GEN.flow, *pargs, draws=draws)
    assert_close(got, np.asarray(want), 0.0, 1e-5)
    # the kernel switch and the dense path compute one function
    dense = p_losses.cfm_loss(pf, P_S3GEN.flow, *pargs, draws=draws, use_flash=False)
    assert_close(dense, got.numpy(), 0.0, 1e-5)


def test_cfm_loss_grads_match_jax_without_the_kernel(flow, cfm_key, monkeypatch):
    """Gradients with the attention switch off on both sides (JAX's module
    global set only through monkeypatch; the port's ``use_flash=False`` and
    its module switch agree)."""
    jf, pf = flow
    jargs, pargs, draws = _cfm_pair(flow, cfm_key)
    monkeypatch.setattr(j_unet, "FLASH_ATTENTION", False)
    want = jax.jit(jax.grad(lambda p: j_losses.cfm_loss(p, J_S3GEN.flow, *jargs, cfm_key)))(jf)

    def port_grads(**kw):
        leaves = list(flatten(pf).values())
        live = [x.detach().requires_grad_() for x in leaves]
        tree = p_step._like(pf, live)
        loss = p_losses.cfm_loss(tree, P_S3GEN.flow, *pargs, draws=draws, **kw)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        return {k: (torch.zeros_like(x) if g is None else g)
                for k, x, g in zip(flatten(pf), leaves, grads)}

    got = port_grads(use_flash=False)
    monkeypatch.setattr(p_unet, "FLASH_ATTENTION", False)
    by_switch = port_grads()
    assert all(torch.equal(got[k], by_switch[k]) for k in got)
    got_j = port_leaves(p_step._like(pf, list(got.values())))
    want_flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): np.asarray(v)
                 for path, v in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(k.replace("#", "") for k in got_j) == sorted(want_flat)
    reached = 0
    for name, g in got_j.items():
        w = want_flat[name.replace("#", "")]
        assert g.shape == w.shape, name
        if not np.abs(w).max():  # the encoder and the embedding: cfm_loss takes mu as given
            assert not np.abs(g).max(), name
            continue
        reached += 1
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max(), name
    assert reached == len(flatten(pf["estimator"]))


def test_cfm_loss_draws_come_from_the_generator(flow):
    _, pf = flow
    x1, mask, mu, spks, cond = (t(a) for a in cfm_inputs())
    with torch.no_grad():
        a, b, c = (p_losses.cfm_loss(pf, P_S3GEN.flow, x1, mask, mu, spks, cond,
                                     generator=torch.Generator().manual_seed(s))
                   for s in (7, 7, 8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a > 0 and torch.isfinite(a)


def test_unet_switch_off_is_the_dense_attention(flow, monkeypatch):
    """``use_flash=False`` against the JAX UNet with ``FLASH_ATTENTION``
    off, and against the port's own kernel path (plain versions here)."""
    jf, pf = flow
    rng = np.random.default_rng(6)
    x, mu, cond = (rng.standard_normal((2, 50, 80)).astype(np.float32) for _ in range(3))
    spks = rng.standard_normal((2, 80)).astype(np.float32)
    tt = np.array([0.3, 0.71], np.float32)
    mask = np.arange(50)[None] < np.array([[50], [33]])
    cfg = P_S3GEN.flow.estimator
    args = (t(x), t(mu), t(spks), t(cond), t(tt), t(mask))
    dense = p_unet.unet_forward(pf["estimator"], cfg, *args, use_flash=False)
    kernel = p_unet.unet_forward(pf["estimator"], cfg, *args)
    assert_close(dense, kernel.numpy(), 1e-4, 1e-4)
    monkeypatch.setattr(j_unet, "FLASH_ATTENTION", False)
    want = j_unet.unet_forward(jf["estimator"], J_S3GEN.flow.estimator, j(x), j(mu), j(spks),
                               j(cond), j(tt), j(mask))
    assert_close(dense, np.asarray(want), 1e-4, 1e-4)


def test_conformer_switch_off_is_the_dense_attention(flow, monkeypatch):
    """The port's dense ESPnet attention (``FLASH_ATTENTION`` off) against
    the JAX package's dense path, and against the port's K4 path on the
    valid rows (the dense path leaves pad query rows unzeroed, in both
    packages)."""
    from chatterbox_tpu.models.s3gen import conformer as j_conformer

    jf, pf = flow
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 30, 128)) * 0.1).astype(np.float32)
    mask = np.arange(30)[None] < np.array([[30], [21]])
    cfg = P_S3GEN.flow.encoder
    kernel = p_conformer.upsample_conformer_encoder(pf["encoder"], t(x), cfg, key_mask=t(mask))
    monkeypatch.setattr(p_conformer, "FLASH_ATTENTION", False)
    monkeypatch.setattr(j_conformer, "FLASH_ATTENTION", False)
    dense = p_conformer.upsample_conformer_encoder(pf["encoder"], t(x), cfg, key_mask=t(mask))
    want = j_conformer.upsample_conformer_encoder(jf["encoder"], j(x), J_S3GEN.flow.encoder,
                                                  key_mask=j(mask))
    assert_close(dense, np.asarray(want), 1e-4, 1e-4)
    valid = np.repeat(mask, 2, axis=1)  # the encoder upsamples by 2
    assert not valid.all()
    assert_close(dense[t(valid)], kernel[t(valid)].numpy(), 1e-4, 1e-4)


# ---------------------------------------------------------------------------
# the kernel wrappers refuse autograd, as jax.grad refuses a Pallas call
# ---------------------------------------------------------------------------


def _wrapper_calls():
    """{name: (wrapper, args(grad))} for every kernel wrapper, at a tiny
    shape on the CPU; ``args(True)`` marks a float operand as requiring
    grad."""
    g = torch.Generator().manual_seed(0)

    def r(*shape, grad=False):
        return torch.randn(shape, generator=g).requires_grad_(grad)

    def decode(grad):
        return (r(2, 2, 2, 2, 16, 64), 0, 8, torch.tensor([4, 6], dtype=torch.int32), 10,
                r(2, 2, 64, grad=grad), r(2, 2, 64), r(2, 2, 64))

    def decode_int8(grad):
        return (torch.zeros((2, 2, 2, 2, 16, 64), dtype=torch.int8), torch.ones(2, 2, 2, 2, 16),
                r(2, 2, 2, 2, 8, 64), 8, 0, 10, torch.tensor([4, 6], dtype=torch.int32), 9,
                r(2, 2, 64, grad=grad), r(2, 2, 64), r(2, 2, 64))

    def probe_cache(grad):
        return (r(1, 2, 1, 1, 8, 16), r(1, 2, 1, 1, 8, grad=grad), 3)

    return {
        "flash_decode_layer_attention": (fd.flash_decode_layer_attention, decode),
        "flash_decode_layer_attention_stats": (fd.flash_decode_layer_attention_stats, decode),
        "flash_decode_layer_attention_int8": (fd.flash_decode_layer_attention_int8, decode_int8),
        "kv_cache_append": (fd.kv_cache_append,
                            lambda grad: (r(2, 2, 2, 2, 16, 64), r(2, 2, 2, 2, 64, grad=grad), 3)),
        "kv_cache_quantize_write": (fd.kv_cache_quantize_write, lambda grad: (
            torch.zeros((2, 2, 2, 2, 16, 64), dtype=torch.int8), torch.ones(2, 2, 2, 2, 16),
            r(2, 2, 2, 2, 8, 64, grad=grad), 8)),
        "flash_self_attention_packed": (fa.flash_self_attention_packed,
                                        lambda grad: (r(2, 8, 3 * 128, grad=grad), r(2, 8), 2)),
        "flash_self_attention": (fa.flash_self_attention, lambda grad: (
            r(2, 2, 8, 64, grad=grad), r(2, 2, 8, 64), r(2, 2, 8, 64), r(2, 8))),
        "flash_relpos_attention": (fa.flash_relpos_attention, lambda grad: (
            r(2, 8, 128, grad=grad), r(2, 8, 2 * 64), r(2, 8, 128), r(8, 64), r(2, 8, 128),
            r(2, 8), 2, 0.125)),
        "noop_copy": (pr.noop_copy, lambda grad: (r(4, 16, grad=grad),)),
        "cache_column_write": (pr.cache_column_write,
                               lambda grad: (*probe_cache(grad), 1)),
        "cache_block_rmw": (pr.cache_block_rmw,
                            lambda grad: (*probe_cache(grad), 1, 8, False)),
        "int8_probe": (pr.int8_probe, lambda grad: (
            "i8_load_convert", torch.zeros((pr.PD, pr.SB), dtype=torch.int8),
            torch.ones(8, pr.SB), r(8, pr.PD, grad=grad), torch.zeros((8, pr.PD), dtype=torch.int8))),
        "softmax_probe": (pr.softmax_probe, lambda grad: (
            pr.SOFTMAX_CASES[0], r(8, pr.SB, grad=grad), r(pr.SB, pr.PD), r(1, pr.PD))),
        # 2 heads of 4, state 4: conv_dim 2 * 4 + 2 * 4, in_proj row 8 + 16 + 2
        "ssm_decode_update": (sd.ssm_decode_update, lambda grad: (
            r(1, 2, 16, 3), r(1, 2, 2, 4, 4), 0, r(2, 26, grad=grad), r(16, 4), r(16), r(2),
            -r(2).abs(), r(2))),
        "add_rms_norm": (dg.add_rms_norm, lambda grad: (r(2, 1, 16), r(2, 1, 16, grad=grad),
                                                         r(16), 1e-5)),
        # 2 query heads and 1 KV head of 64; the step's K/V (L, 2, B, Hkv, D)
        "rope_split_kv": (dg.rope_split_kv, lambda grad: (
            r(2, 1, 128, grad=grad), r(2, 1, 64), r(2, 1, 64), r(2, 1, 64), r(2, 1, 64),
            r(1, 2, 2, 1, 64), 0)),
        "silu_mul": (dg.silu_mul, lambda grad: (r(2, 1, 32, grad=grad),)),
    }


def test_every_kernel_wrapper_is_covered():
    from chatterbox_tpu_torch.ops import kernels

    assert sorted(_wrapper_calls()) == sorted(kernels())


@pytest.mark.parametrize("name", sorted(_wrapper_calls()))
def test_kernel_wrapper_raises_under_autograd(name):
    """With grad mode on and an operand that requires grad, the wrapper
    raises before dispatching (here on the CPU, as on the card); under
    ``no_grad`` the same call runs its plain version."""
    fn, args = _wrapper_calls()[name]
    with pytest.raises(RuntimeError, match="no backward"):
        fn(*args(True))
    with torch.no_grad():
        fn(*args(True))
    fn(*args(False))


def test_plain_attention_versions_stay_differentiable():
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn((2, 8, 3 * 128), generator=g).requires_grad_()
    fa.flash_self_attention_packed_plain(qkv, None, 2).sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all() and qkv.grad.abs().sum() > 0


def test_jax_pallas_call_refuses_grad():
    """The JAX package's behaviour the port's wrappers copy."""
    from chatterbox_tpu.ops.flash_attention import flash_self_attention_packed

    x = jnp.asarray(np.random.default_rng(0).standard_normal((1, 128, 3 * 128)), jnp.float32)
    with pytest.raises(Exception):
        jax.grad(lambda v: flash_self_attention_packed(
            v, None, n_heads=2, interpret=True).sum())(x)


# ---------------------------------------------------------------------------
# runtime/profiling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("audio_seconds", [None, 12.5])
def test_stage_timer_report_matches_jax(audio_seconds):
    totals = {"t3": 1.234567, "flow": 0.0123456, "hift": 0.5}
    jt, pt = j_prof.StageTimer(), p_prof.StageTimer()
    for timer in (jt, pt):
        timer.totals.update(totals)
    assert pt.report(audio_seconds) == jt.report(audio_seconds)
    assert str(pt) == str(jt)


def test_stage_timer_counts_and_blocks():
    timer = p_prof.StageTimer()
    x = torch.ones(3)
    for block_on in (x, x.device):
        with timer.stage("a", block_on=block_on):
            x = x + 1
    assert timer.counts["a"] == 2 and timer.totals["a"] > 0
    assert set(timer.report()) == {"a", "total"}


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with p_prof.trace(str(tmp_path / "tr")):
        with p_prof.annotate("cbx_stage"):
            torch.ones(64).sum()
    files = list((tmp_path / "tr").glob("trace_*.json"))
    assert len(files) == 1 and "cbx_stage" in files[0].read_text()
