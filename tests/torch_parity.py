"""Shared set-up of the PyTorch port's parity tests (tests/test_torch_*.py).

Both packages get the tiny configs of ``test_pipeline.py`` (a 2-layer Llama
of width 64; a flow whose UNet has 4 heads of 64 -- inner 256, so the JAX
side takes the packed flash kernel -- and whose conformer has 4 heads of 32;
a 2-layer S3 tokenizer of width 64; a CAMPPlus with one layer per dense
block; a 2-layer voice encoder), the same weights (the JAX ``init_*``
functions, bridged with ``weights.from_jax_tree``) and the same inputs, made
with numpy from a seed.
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
from chatterbox_tpu.models import s3tokenizer as j_s3tok
from chatterbox_tpu.models import voice_encoder as j_ve
from chatterbox_tpu.models.s3gen import unet as j_unet
from chatterbox_tpu.models.s3gen import xvector as j_xvector
from chatterbox_tpu.models.t3 import llama as j_llama
from chatterbox_tpu.models.t3 import t3 as j_t3
from chatterbox_tpu_torch import weights
from chatterbox_tpu_torch.models import s3tokenizer as p_s3tok
from chatterbox_tpu_torch.models import voice_encoder as p_ve
from chatterbox_tpu_torch.models.s3gen import conformer as p_conformer
from chatterbox_tpu_torch.models.s3gen import flow as p_flow
from chatterbox_tpu_torch.models.s3gen import s3gen as p_s3gen
from chatterbox_tpu_torch.models.s3gen import unet as p_unet
from chatterbox_tpu_torch.models.s3gen import xvector as p_xvector
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
_S3TOK = dict(n_state=64, n_head=4, n_layer=2)
_CAMPPLUS = dict(growth_rate=8, bn_size=2, init_channels=32, m_channels=8, block_layers=(1, 1, 1))
_VE = dict(hidden_size=32, num_layers=2)

J_T3 = j_t3.T3Config(llama=j_llama.LlamaConfig(**_LLAMA))
P_T3 = p_t3.T3Config(llama=p_llama.LlamaConfig(**_LLAMA))
J_S3GEN = j_s3gen.S3GenConfig(
    flow=j_flow.FlowConfig(input_size=128, encoder=j_conformer.ConformerConfig(**_CONFORMER),
                           estimator=j_unet.UNetConfig(**_UNET)),
    campplus=j_xvector.CAMPPlusConfig(**_CAMPPLUS),
    tokenizer=j_s3tok.S3TokenizerConfig(**_S3TOK),
)
P_S3GEN = p_s3gen.S3GenConfig(
    flow=p_flow.FlowConfig(input_size=128, encoder=p_conformer.ConformerConfig(**_CONFORMER),
                           estimator=p_unet.UNetConfig(**_UNET)),
    campplus=p_xvector.CAMPPlusConfig(**_CAMPPLUS),
    tokenizer=p_s3tok.S3TokenizerConfig(**_S3TOK),
)
J_VE = j_ve.VoiceEncoderConfig(**_VE)
P_VE = p_ve.VoiceEncoderConfig(**_VE)


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


def _fill(shapes, rng, path=()):
    """numpy values for a tree of ShapeDtypeStructs: weights N(0, 1/fan_in)
    (the LSTM's U(+-1/sqrt(H))), biases, norm scales and batch-norm
    statistics drawn away from 0 and 1, so that a leaf the bridge or a
    module mishandles shows in the output."""
    if isinstance(shapes, dict):
        return {k: _fill(v, rng, path + (k,)) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_fill(v, rng, path + (i,)) for i, v in enumerate(shapes)]
    shape, name = tuple(shapes.shape), path[-1]
    if name in ("w_ih", "w_hh"):
        h = shape[-1] // 4
        x = rng.uniform(-(h ** -0.5), h ** -0.5, shape)
    elif name == "w":
        x = rng.standard_normal(shape) * float(np.prod(shape[:-1])) ** -0.5
    elif name in ("scale", "var"):
        x = rng.uniform(0.7, 1.3, shape)
    else:  # b, bias, mean
        x = rng.standard_normal(shape) * 0.1
    return x.astype(np.float32)


@lru_cache(maxsize=None)
def _jax_cond(seed):
    key = jax.random.PRNGKey(0)
    shapes = {
        "campplus": jax.eval_shape(lambda: j_xvector.init_campplus(key, J_S3GEN.campplus)),
        "tokenizer": jax.eval_shape(lambda: j_s3tok.init_s3tokenizer(key, J_S3GEN.tokenizer)),
        "ve": jax.eval_shape(lambda: j_ve.init_voice_encoder(key, J_VE)),
    }
    return _fill(shapes, np.random.default_rng(seed))


def cond_params(seed=0):
    """(JAX params, port params) of the tiny conditioning modules
    {"campplus", "tokenizer", "ve"}: the trees of their ``init_*``
    functions (``jax.eval_shape``; JAX's random init of CAMPPlus alone
    takes seconds on the CPU), filled from a numpy seed by ``_fill``."""
    jp = _jax_cond(seed)
    return jp, weights.from_jax_tree(jp)


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


def zero_vocoder_noise(hift_generate, zeros):
    """``hift_generate`` with its phase and additive noise zeroed (``zeros``
    is ``jnp.zeros`` or ``torch.zeros``), as ``test_from_local.py`` runs
    the vocoder for parity."""
    def run(p, cfg, mel, **kw):
        b, t_mel, _ = mel.shape
        h = cfg.nb_harmonics + 1
        kw["phase_noise"] = zeros((b, h))
        kw["additive_noise"] = zeros((b, h, t_mel * cfg.upsample_total))
        kw.pop("generator", None)
        kw.pop("rng", None)
        return hift_generate(p, cfg, mel, **kw)

    return run


def loud_s3gen_params():
    """The tiny S3Gen synthesis weights with a 100x HiFT conv_post, so the
    random vocoder's iSTFT head sees O(1) log-magnitudes and phases and the
    waveforms peak at hundreds of int16 steps rather than a few."""
    jp, _ = s3gen_params()
    hift = dict(jp["hift"])
    hift["conv_post"] = {**hift["conv_post"], "w": hift["conv_post"]["w"] * 100.0}
    jp = {**jp, "hift": hift}
    return jp, weights.from_jax_tree(jp)


def s3gen_with_conditioning():
    """(JAX, port) S3Gen trees: the loud synthesis half and the tiny
    CAMPPlus and S3 tokenizer."""
    js3, ps3 = loud_s3gen_params()
    jc, pc = cond_params()
    keys = ("campplus", "tokenizer")
    return {**js3, **{k: jc[k] for k in keys}}, {**ps3, **{k: pc[k] for k in keys}}


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
