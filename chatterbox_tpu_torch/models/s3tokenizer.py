"""S3 speech tokenizer: 16 kHz speech -> 25 Hz semantic tokens (FSQ 3^8).

Port of ``chatterbox_tpu/models/s3tokenizer.py`` (the S3TokenizerV2
encoder): two stride-2 convs with GELU (100 -> 25 frames a second), Whisper
sinusoids, pre-norm attention blocks with an FSMN memory branch on the
values, then FSQ: project to 8 dims, round each tanh to 3 levels, pack in
radix 3. ``convert_s3tokenizer`` reads the upstream checkpoint into the
JAX package's tree (``weights.py`` makes the port's layouts), with the
architecture read from the tensor shapes (``s3tok_config_from_sd``).

Two things decide every token:
  - with ``mel_lens``, pad keys are masked and pad tokens zeroed; without
    it, a row's tokens depend on the rows batched with it;
  - the FSQ rounding runs in fp32 after an fp32 ``ln_post``, as in the JAX
    package. On the card run it with TF32 off (``device.full_fp32``).
"""

import re
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..checkpoint import torch_convert as tc
from ..constants import EOS, S3_TOKEN_RATE, SOS, SPEECH_VOCAB_SIZE
from ..core.dsp import s3tok_log_mel_spectrogram
from ..core.layers import conv1d, layer_norm, linear, merge_heads, sdpa, split_heads

# the upstream quantizer scales tanh(h) by this before rounding
FSQ_TANH_SCALE = 0.9990000128746033


@dataclass(frozen=True)
class S3TokenizerConfig:
    n_mels: int = 128
    n_audio_ctx: int = 1500
    n_state: int = 1280
    n_head: int = 20
    n_layer: int = 6
    fsq_dim: int = 8
    fsq_levels: int = 3
    fsmn_kernel: int = 11

    @property
    def vocab_size(self) -> int:
        return self.fsq_levels**self.fsq_dim  # 6561


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's positional embedding."""
    log_timescale = np.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def _block(p, x, n_head, fsmn_kernel, key_mask=None):
    """Pre-norm attention with the FSMN value memory (depthwise conv of the
    masked values plus the values, masked again, added after the out
    projection), then the GELU MLP."""
    y = layer_norm(p["attn_ln"], x, 1e-5)
    q = split_heads(linear(p["q"], y), n_head)
    k = split_heads(linear(p["k"], y), n_head)
    vproj = linear(p["v"], y)
    mask = None if key_mask is None else key_mask[:, None, None, :]
    a = merge_heads(sdpa(q, k, split_heads(vproj, n_head), mask))
    vm = vproj if key_mask is None else vproj * key_mask[..., None].to(vproj.dtype)
    lpad = (fsmn_kernel - 1) // 2
    mem = conv1d(p["fsmn"], vm, padding=(lpad, fsmn_kernel - 1 - lpad), groups=vm.shape[-1]) + vm
    if key_mask is not None:
        mem = mem * key_mask[..., None].to(mem.dtype)
    x = x + linear(p["attn_out"], a) + mem
    y = layer_norm(p["mlp_ln"], x, 1e-5)
    return x + linear(p["mlp2"], F.gelu(linear(p["mlp1"], y)))


def s3_encode_fsq(p, cfg: S3TokenizerConfig, mels, mel_lens=None):
    """(B, T_mel, 128) log-mels -> (z (B, T_mel//4, 8) fp32, the FSQ
    projection before tanh, and the key mask (B, T_tok) or None)."""
    mels = mels.to(p["conv1"]["w"].dtype)
    x = F.gelu(conv1d(p["conv1"], mels, stride=2, padding=1))
    x = F.gelu(conv1d(p["conv2"], x, stride=2, padding=1))
    t = x.shape[1]
    pos = torch.from_numpy(_sinusoids(cfg.n_audio_ctx, cfg.n_state)[:t]).to(x.device, x.dtype)
    x = x + pos[None]
    key_mask = None
    if mel_lens is not None:
        key_mask = torch.arange(t, device=x.device)[None] < (mel_lens // 4)[:, None]
    for bp in p["blocks"]:
        x = _block(bp, x, cfg.n_head, cfg.fsmn_kernel, key_mask)
    x = layer_norm(p["ln_post"], x.float(), 1e-5)
    return linear(p["fsq_proj"], x), key_mask


def s3_encode_mels(p, cfg: S3TokenizerConfig, mels, mel_lens=None):
    """(B, T_mel, 128) log-mels (100 a second) -> (tokens (B, T_mel//4)
    int32 in [0, 6561), token_lens (B,) int32)."""
    z, key_mask = s3_encode_fsq(p, cfg, mels, mel_lens)
    half = (cfg.fsq_levels - 1) / 2.0
    digits = torch.round(torch.tanh(z) * FSQ_TANH_SCALE * half) + half  # {0, 1, 2}
    radix = torch.from_numpy(cfg.fsq_levels ** np.arange(cfg.fsq_dim)).to(z.device)
    tokens = (digits.to(torch.int64) * radix).sum(dim=-1).to(torch.int32)
    if key_mask is None:
        return tokens, torch.full((tokens.shape[0],), tokens.shape[1], dtype=torch.int32,
                                  device=tokens.device)
    return torch.where(key_mask, tokens, 0), (mel_lens // 4).to(torch.int32)


def pad_to_token_multiple(wav: np.ndarray, sr: int = 16000) -> np.ndarray:
    """Zero-pad a (T,) wav to a whole number of 40 ms tokens."""
    n_tokens = int(np.ceil(len(wav) / sr * S3_TOKEN_RATE))
    return np.pad(wav, (0, int(n_tokens * (sr / S3_TOKEN_RATE)) - len(wav)))


def s3_tokenize(p, cfg: S3TokenizerConfig, wav16, max_len: int = None, wav_lens=None):
    """(B, T) padded 16 kHz wavs -> (tokens (B, T_tok), lens): the mel
    frontend, optional truncation to ``max_len`` tokens (4 mel frames
    each), and with ``wav_lens`` (B,) the pad region of each row masked."""
    mels = s3tok_log_mel_spectrogram(wav16).transpose(1, 2)  # (B, T_mel, 128)
    if max_len is not None:
        mels = mels[:, : max_len * 4]
    mel_lens = None
    if wav_lens is not None:
        mel_lens = torch.clamp(wav_lens // 160, max=mels.shape[1])
    return s3_encode_mels(p, cfg, mels, mel_lens=mel_lens)


def drop_invalid_tokens(tokens: np.ndarray) -> np.ndarray:
    """The tokens between SOS and EOS, without ids outside the FSQ vocab
    (s3tokenizer/__init__.py:16-30)."""
    tokens = np.asarray(tokens).reshape(-1)
    s = int(np.argmax(tokens == SOS)) + 1 if (tokens == SOS).any() else 0
    e = int(np.argmax(tokens == EOS)) if (tokens == EOS).any() else len(tokens)
    out = tokens[s:e]
    return out[out < SPEECH_VOCAB_SIZE]


# checkpoint buffers recomputed here (the sinusoids) or of the mel frontend
# (the reference S3Tokenizer registers them, s3tokenizer.py:38-52)
_IGNORED_SUFFIXES = ("_mel_filters", "window", "positional_embedding")


def _fsq_key(sd, prefix):
    return next((k for k in sd if k.startswith(prefix) and k.endswith("project_down.weight")),
                None)


def s3tok_config_from_sd(sd, prefix: str) -> S3TokenizerConfig:
    """The architecture of the tokenizer under ``prefix`` from the
    checkpoint's tensor shapes, as the JAX package's
    ``s3tok_config_from_sd``: n_mels and n_state from conv1, n_layer by
    counting blocks, the FSMN kernel and the FSQ width from their weights,
    n_audio_ctx from the positional buffer when shipped. The head count,
    which shapes cannot tell, is n_state // 64."""
    n_state, n_mels, _ = tuple(sd[prefix + "encoder.conv1.weight"].shape)
    block = re.compile(re.escape(prefix) + r"encoder\.blocks\.(\d+)\.")
    layer_ids = {int(m.group(1)) for k in sd if (m := block.match(k))}
    if not layer_ids or layer_ids != set(range(max(layer_ids) + 1)):
        raise KeyError(f"non-contiguous/empty encoder.blocks indices: {sorted(layer_ids)}")
    fsq_key = _fsq_key(sd, prefix)
    if fsq_key is None:
        raise KeyError(f"no '*project_down.weight' (FSQ) key under prefix {prefix!r}")
    pos_key = prefix + "encoder.positional_embedding"
    return S3TokenizerConfig(
        n_mels=n_mels,
        n_audio_ctx=tuple(sd[pos_key].shape)[0] if pos_key in sd else S3TokenizerConfig.n_audio_ctx,
        n_state=n_state,
        n_head=max(n_state // 64, 1),
        n_layer=max(layer_ids) + 1,
        fsq_dim=tuple(sd[fsq_key].shape)[0],
        fsmn_kernel=tuple(sd[prefix + "encoder.blocks.0.attn.fsmn_block.weight"].shape)[-1],
    )


def convert_s3tokenizer(sd, cfg: S3TokenizerConfig, prefix: str):
    """The upstream S3TokenizerV2 checkpoint's subtree under ``prefix`` ->
    the JAX package's tree (numpy), as its ``convert_s3tokenizer`` with an
    explicit config: a missing key raises KeyError naming it, a key under
    the prefix left unread raises ValueError, and a shipped positional
    buffer must equal the sinusoids."""
    consumed = set()
    sub = tc.TrackingDict(sd, consumed)
    fsq_key = _fsq_key(sd, prefix) or prefix + "quantizer.project_down.weight"
    fsq_prefix = fsq_key[: -len(".weight")]

    def blk(i):
        b = f"{prefix}encoder.blocks.{i}."
        return {
            "attn_ln": tc.layer_norm(sub, b + "attn_ln"),
            "q": tc.linear(sub, b + "attn.query"),
            "k": tc.linear(sub, b + "attn.key"),
            "v": tc.linear(sub, b + "attn.value"),
            "fsmn": tc.conv1d(sub, b + "attn.fsmn_block"),
            "attn_out": tc.linear(sub, b + "attn.out"),
            "mlp_ln": tc.layer_norm(sub, b + "mlp_ln"),
            "mlp1": tc.linear(sub, b + "mlp.0"),
            "mlp2": tc.linear(sub, b + "mlp.2"),
        }

    params = {
        "conv1": tc.conv1d(sub, prefix + "encoder.conv1"),
        "conv2": tc.conv1d(sub, prefix + "encoder.conv2"),
        "blocks": [blk(i) for i in range(cfg.n_layer)],
        "ln_post": tc.layer_norm(sub, prefix + "encoder.ln_post"),
        "fsq_proj": tc.linear(sub, fsq_prefix),
    }
    c = cfg.n_state
    checks = {
        "conv1.w": (params["conv1"]["w"].shape, (3, cfg.n_mels, c)),
        "fsq_proj.w": (params["fsq_proj"]["w"].shape, (c, cfg.fsq_dim)),
        "blocks.0.fsmn.w": (params["blocks"][0]["fsmn"]["w"].shape, (cfg.fsmn_kernel, 1, c)),
    }
    for name, (got, want) in checks.items():
        if tuple(got) != want:
            raise ValueError(f"s3tokenizer {name}: shape {tuple(got)} != expected {want}")
    unconsumed = [k for k in sd if k.startswith(prefix) and k not in consumed
                  and not k.endswith(_IGNORED_SUFFIXES)]
    if unconsumed:
        raise ValueError(f"convert_s3tokenizer: {len(unconsumed)} checkpoint keys under "
                         f"{prefix!r} were NOT consumed (layout drift?): "
                         f"{sorted(unconsumed)[:20]}")
    pos_key = prefix + "encoder.positional_embedding"
    if pos_key in sd:
        shipped = tc.as_numpy(sd[pos_key])
        if not np.allclose(shipped, _sinusoids(*shipped.shape), atol=1e-4):
            raise ValueError("s3tokenizer positional_embedding in checkpoint differs from "
                             "recomputed sinusoids -- encoder variant mismatch")
    return params
