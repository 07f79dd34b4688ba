"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the tiny configs of ``test_pipeline.py`` (a 2-layer Llama
of width 64; a flow whose UNet has 4 heads of 64 -- inner 256, so the JAX
side takes the packed flash kernel -- and whose conformer has 4 heads of 32),
the same weights (the JAX ``init_*`` functions, bridged with
``weights.from_jax_tree``) and the same inputs, made with numpy from a seed.
Everything runs on the CPU in fp32; the JAX side runs its Pallas kernels in
interpret mode, as its own tests do.
"""

from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import torch

from chatterbox_tpu.models.s3gen import conformer as j_conformer
from chatterbox_tpu.models.s3gen import flow as j_flow
from chatterbox_tpu.models.s3gen import hifigan as j_hifigan
from chatterbox_tpu.models.s3gen import s3gen as j_s3gen
from chatterbox_tpu.models.s3gen import unet as j_unet
from chatterbox_tpu.models.s3tokenizer import S3TokenizerConfig
from chatterbox_tpu.models.t3 import llama as j_llama
from chatterbox_tpu.models.t3 import t3 as j_t3
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.models.s3gen import conformer as p_conformer
from chatterbox_tpu_torch.models.s3gen import flow as p_flow
from chatterbox_tpu_torch.models.s3gen import s3gen as p_s3gen
from chatterbox_tpu_torch.models.s3gen import unet as p_unet
from chatterbox_tpu_torch.models.t3 import llama as p_llama
from chatterbox_tpu_torch.models.t3 import t3 as p_t3

# the tier-1 run gives each of its 6 workers a file; PyTorch's default of
# one intra-op thread per core would put 6x as many threads on the cores
torch.set_num_threads(1)

_LLAMA = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
              num_attention_heads=2, num_key_value_heads=2, head_dim=32)
_CONFORMER = dict(input_size=128, output_size=128, attention_heads=4, linear_units=256,
                  num_blocks=2, num_up_blocks=1)
_UNET = dict(channels=64, n_blocks=1, num_mid_blocks=2, num_heads=4)

J_T3 = j_t3.T3Config(llama=j_llama.LlamaConfig(**_LLAMA))
P_T3 = p_t3.T3Config(llama=p_llama.LlamaConfig(**_LLAMA))
J_S3GEN = j_s3gen.S3GenConfig(
    flow=j_flow.FlowConfig(input_size=128, encoder=j_conformer.ConformerConfig(**_CONFORMER),
                           estimator=j_unet.UNetConfig(**_UNET)),
    tokenizer=S3TokenizerConfig(n_state=64, n_head=4, n_layer=2),
)
P_S3GEN = p_s3gen.S3GenConfig(
    flow=p_flow.FlowConfig(input_size=128, encoder=p_conformer.ConformerConfig(**_CONFORMER),
                           estimator=p_unet.UNetConfig(**_UNET)),
)


def np_tree(tree):
    """A JAX pytree as numpy arrays."""
    return jax.tree.map(np.asarray, tree)


@lru_cache(maxsize=None)
def _jax_t3(seed):
    return np_tree(jax.jit(lambda k: j_t3.init_t3(k, J_T3))(jax.random.PRNGKey(seed)))


@lru_cache(maxsize=None)
def _jax_s3gen(seed):
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    return np_tree({
        "flow": jax.jit(lambda k: j_flow.init_flow(k, J_S3GEN.flow))(k1),
        "hift": jax.jit(lambda k: j_hifigan.init_hift(k, J_S3GEN.hift))(k2),
    })


def t3_params(seed=0):
    """(JAX params, port params) of the tiny T3 from ``init_t3``, as numpy
    arrays and CPU tensors."""
    jp = _jax_t3(seed)
    return jp, weights.from_jax_tree(jp)


def s3gen_params(seed=0):
    """(JAX params, port params) of the tiny S3Gen synthesis half (flow +
    HiFT) from ``init_flow`` / ``init_hift``."""
    jp = _jax_s3gen(seed)
    return jp, weights.from_jax_tree(jp)


def t(x, dtype=None):
    """numpy -> CPU torch tensor (a copy)."""
    out = torch.from_numpy(np.array(x, copy=True))
    return out if dtype is None else out.to(dtype)


def j(x):
    return jnp.asarray(np.asarray(x))


def assert_close(got, want, atol, rtol=0.0, msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               atol=atol, rtol=rtol, err_msg=msg)


def ref_inputs(seed=0, b=1, prompt_tokens=10):
    """A random RefDict of the tiny config, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return (
        rng.integers(0, 6561, (b, prompt_tokens)).astype(np.int32),
        np.full((b,), prompt_tokens, np.int32),
        (rng.standard_normal((b, 2 * prompt_tokens, 80)) * 0.5 - 4.0).astype(np.float32),
        rng.standard_normal((b, 192)).astype(np.float32),
    )


def eos_boosted_t3_params():
    """Tiny T3 weights whose EOS logit rides hidden channel 0 (x4), so rows
    stop at different steps and the done-masks and EOS padding are
    exercised (random heads would almost never emit EOS)."""
    jp, _ = t3_params()
    head = np.array(jp["speech_head"]["w"])
    head[:, J_T3.stop_speech_token] = 0.0
    head[0, J_T3.stop_speech_token] = 4.0
    jp = {**jp, "speech_head": {"w": head}}
    return jp, weights.from_jax_tree(jp)


def gen_inputs(seed=3, b=3):
    """(text (B, 16) with SOT/EOT framing, right-padded; text_lens (B,);
    speaker_emb; prompt tokens; emotion) for ``t3_generate``."""
    rng = np.random.default_rng(seed)
    lens = np.array([9, 5, 14])[:b]
    text = np.zeros((b, 16), np.int32)
    for i, n in enumerate(lens):
        text[i, 0], text[i, n - 1] = J_T3.start_text_token, J_T3.stop_text_token
        text[i, 1:n - 1] = rng.integers(1, 700, n - 2)
    spk = rng.standard_normal((b, 256)).astype(np.float32)
    prompt = rng.integers(0, 6561, (b, 150)).astype(np.int32)
    emo = np.full((b,), 0.5, np.float32)
    return text, lens.astype(np.int32), spk, prompt, emo


def jax_uniforms(seed, max_new, b):
    """The per-step uniforms of the JAX ``t3_generate`` key chain
    (``key, sub = split(key); u = uniform(sub, (B,))``), (max_new, B)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(max_new):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (b,))))
    return np.stack(out)
