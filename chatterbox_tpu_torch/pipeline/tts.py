"""ChatterboxTTS: zero-shot TTS from a reference wav or from precomputed
voice conditionals.

Port of ``chatterbox_tpu/pipeline/tts.py``: ``prepare_conditionals`` turns
a reference wav into Conditionals (S3Gen's RefDict from ``embed_ref``, T3's
prompt tokens from the S3 tokenizer, the voice-encoder embedding), and
``generate_batch`` runs text -> ids -> T3 (CFG decode) -> host token
compaction -> S3Gen (flow + HiFT + trim-fade) -> watermark on the device
batch (spread-spectrum, or the neural Perth engine when a Perth checkpoint
is found: ``models/watermark.PerthImplicitWatermarker``) -> int16 PCM.
Shapes are bucketed as in the JAX package (TEXT_BUCKETS, TOKEN_BUCKETS) so
both packages see the same padded batches. Entry points
run on ``cuda`` unless the caller passes ``device``; without a GPU and
without a device they raise. The conditioning modules (voice encoder,
CAMPPlus, S3 tokenizer) stay fp32 and run with TF32 off.

T3's KV cache is int8 with an exact tail at token budgets of 500 and more,
as the JAX package's auto policy has it (``_kv_quant_for``; the
``kv_quant`` argument or ``CHATTERBOX_KV_QUANT=1/0`` overrides it), and in
the working dtype otherwise. ``generate_batch(alignment=True)`` runs the
alignment watchdog, which forces the working-dtype cache.

The CFM Euler step count is the config's (10), or ``CHATTERBOX_FLOW_STEPS``
at construction, or ``flow_steps`` per call (the serving quality tier; the
T3 tokens do not change with it). ``runtime/precision.apply_tts_precision``
puts T3 in its runtime layout (fused q/k/v, int8 weights with
``CHATTERBOX_W_QUANT=1``); ``_unfuse_qkv`` restores the canonical one.

A batch above the card's one-shot cap (``_budget_batch_cap``: the T3 KV
cache bytes against a budget sized from the card's memory) is split evenly
into chunks under the pipelined cap (the same on the card) and run through
``generate_batches_pipelined``, chunk c seeded ``seed + c``, as the JAX
package does. ``device_chain=True`` compacts the tokens on the device and
dispatches S3Gen without reading them back; ``defer_collect=True`` returns
the device handle for ``collect``.

``generate_batch_preemptible`` runs the same work in bounded pieces on the
resumable T3 carry, for the serving layer's admission control
(``serve/batcher.py``); ``pipeline/streaming.py`` streams on that carry.
``CHATTERBOX_HIFT_BF16=1`` runs the vocoder's conv trunk in bf16.

``with_mesh`` runs ``generate_batch`` over a ("data", "model") mesh of
processes (``parallel/``): each rank its rows, T3 optionally split by heads.
``from_random(..., synthetic=True)`` builds a benchmark's weights without a
generator (``runtime/fast_init.py``).
"""

import contextlib
import os
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import weights
from ..checkpoint.config_io import load_configs, save_configs
from ..checkpoint.pytree_io import save_params
from ..checkpoint.torch_convert import read_safetensors
from ..constants import S3_SR, S3GEN_SR, SPEECH_VOCAB_SIZE
from ..core.dsp import ve_mel_spectrogram
from ..core.resample import resample
from ..core.sampling import SamplingConfig
from ..device import full_fp32, resolve_device
from ..models.s3gen.s3gen import (RefDict, S3GenConfig, convert_s3gen, embed_ref,
                                  flow_steps_from_env, infer_s3gen_config, s3gen_wav,
                                  with_flow_steps)
from ..models.s3tokenizer import pad_to_token_multiple, s3_tokenize
from ..models.t3.llama import canonicalize_llama_params
from ..models.t3.t3 import (T3Config, convert_t3, t3_generate, t3_generate_resume,
                            t3_generate_start)
from ..models.tokenizer import EnTokenizer
from ..models.voice_encoder import (VoiceEncoderConfig, convert_voice_encoder, frame_step,
                                    num_wins, ve_embed_from_mels)
from ..models.watermark import PerthImplicitWatermarker
from ..parallel.sharding import data_rows, gather_rows
from ..parallel.tensor_parallel import model_parallel
from ..runtime.fast_init import synthetic_init
from .audio import load_wav, trim_silence
from .conditionals import Conditionals, T3CondData

TEXT_BUCKETS = (32, 64, 128, 256, 512)
TOKEN_BUCKETS = (64, 125, 250, 500, 750, 1000)
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16", torch.float32: "fp32"}


def punc_norm(text: str) -> str:
    """Text cleanup, mirrors reference tts.py:22-61."""
    if len(text) == 0:
        return "You need to add some text for me to talk."
    if text[0].islower():
        text = text[0].upper() + text[1:]
    text = " ".join(text.split())
    for old, new in [
        ("...", ", "), ("…", ", "), (":", ","), (" - ", ", "), (";", ", "),
        ("—", "-"), ("–", "-"), (" ,", ","), ("“", '"'), ("”", '"'),
        ("‘", "'"), ("’", "'"),
    ]:
        text = text.replace(old, new)
    text = text.rstrip(" ")
    if not any(text.endswith(p) for p in {".", "!", "?", "-", ","}):
        text += "."
    return text


def _bucket(n: int, buckets) -> int:
    return next((b for b in buckets if n <= b), buckets[-1])


# Device memory of one generate_batch call a text, over what the process
# held before the call (torch.cuda.max_memory_allocated after
# reset_peak_memory_stats, less memory_allocated before), at the 64-token
# text bucket: 250 tokens on the bf16 KV cache, and the default 1000 on the
# int8 cache. Measured by chip_smoke.py's paths A and B (8 texts; "peak over
# the ... bytes held before the call"; path I's 81 texts gave 852 422 074
# bytes a text at 1000 tokens) on an NVIDIA H100 80GB HBM3 at 700.00 W, in
# the run PERF.md section 4 names.
_ROW_PEAK_BYTES = {250: 213_619_712, 1000: 852_644_928}
# the caching allocator's room at a call's peak for each byte the call
# allocates: a fifth more for the segments its allocations fragment. Left
# unbounded, the allocator reserved 1.16 (81 texts) and 1.33 (68 texts)
# bytes for each byte path I allocated, taking what the card had free; path
# I runs the cap with the allocator held to _USABLE_SHARE (same card)
_RESERVED_PER_ALLOCATED = 1.2
# the share of the card's memory the allocator may reserve: the rest is the
# CUDA context's and the libraries' outside the allocator
_USABLE_SHARE = 0.85


def _default_dtype(device: torch.device) -> torch.dtype:
    """T3 and the flow run bf16 on the card and fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def random_s3gen(cfg: S3GenConfig, seed: int, device) -> dict:
    """Seeded random S3Gen parameters on ``device``: the flow in the
    working dtype, HiFT, CAMPPlus and the S3 tokenizer in fp32."""
    return {
        "flow": weights.init_flow(cfg.flow, seed + 1, device, _default_dtype(device)),
        "hift": weights.init_hift(cfg.hift, seed + 2, device),
        "campplus": weights.init_campplus(cfg.campplus, seed + 3, device),
        "tokenizer": weights.init_s3tokenizer(cfg.tokenizer, seed + 4, device),
    }


def _s3gen_dtype(name: str, device) -> torch.dtype:
    """The flow in the working dtype; HiFT, CAMPPlus and the S3 tokenizer fp32."""
    return _default_dtype(device) if name == "flow" else torch.float32


def cast_s3gen(params, device) -> dict:
    """S3Gen parameters in the port's layouts (``load_native``'s, or
    ``from_jax_tree`` of ``convert_s3gen``'s) -> on ``device``, cast as in
    ``random_s3gen``; a None tokenizer (a checkpoint without one) stays None."""
    return {name: weights.tree_to(sub, device, _s3gen_dtype(name, device))
            for name, sub in params.items()}


def cfm_noise(device) -> torch.Tensor:
    """The fixed CFM noise buffer (reference flow_matching.py:191), drawn
    with numpy so both packages hold the same bits."""
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 15000, 80)).astype(np.float32)
    ).to(device)


def _compact_tokens(tokens, lengths):
    """Device-side drop of invalid tokens (reference tts.py:256-262): the
    tokens below ``lengths`` and below SPEECH_VOCAB_SIZE, stable-partitioned
    to the front of each row, zeros after; returns (tokens, new lengths
    int32), as the JAX package's ``_compact_tokens``."""
    t = tokens.shape[1]
    pos = torch.arange(t, device=tokens.device)[None]
    valid = (pos < lengths[:, None]) & (tokens < SPEECH_VOCAB_SIZE)
    order = torch.argsort((~valid).to(torch.uint8), dim=1, stable=True)
    compacted = torch.take_along_dim(tokens, order, dim=1)
    new_lens = valid.sum(dim=1).to(torch.int32)
    return torch.where(pos < new_lens[:, None], compacted, 0), new_lens


def _cache_row_bytes(llama_cfg, max_new_tokens: int, text_bucket: int, itemsize: int) -> int:
    """T3's KV-cache bytes for one text (its two CFG rows) at a token budget:
    (L, 2, 2 rows, H, S, D) with S = cond + text bucket + BOS + budget,
    padded to 128 slots (the JAX package's ``_budget_batch_cap``)."""
    s = 34 + text_bucket + 2 + max_new_tokens
    s = -(-s // 128) * 128
    return (llama_cfg.num_hidden_layers * 2 * 2 * llama_cfg.num_key_value_heads
            * llama_cfg.head_dim * s * itemsize)


def card_batch_limits(device, llama_cfg, resident_bytes: int):
    """(max_device_batch, max_pipelined_batch, one-shot cache budget,
    pipelined cache budget) on ``device``: the card's own, from its
    ``total_memory`` and ``_ROW_PEAK_BYTES``. Of the usable memory
    (``_USABLE_SHARE`` of the card, less ``resident_bytes``, what the
    process holds already), the one-shot budget is the KV-cache bytes of
    the rows whose reservation (their peak times
    ``_RESERVED_PER_ALLOCATED``) fills it at 1000 tokens on the int8
    cache, where the cache
    is the smallest share of a row's peak: a budget of cache bytes admits
    fewer rows wherever a row carries more cache for its activations (a
    bf16 cache, a longer text bucket). The hard cap is the rows that fill
    it at 250 tokens, bounding the short budgets where the cache bytes say
    little. The pipelined path gets the same: its chunks run in order on
    one stream, so the allocator hands chunk c's memory to chunk c + 1 and
    a split call peaks as one chunk does (chip_smoke.py's path H). Off the
    card there is no bound (the CPU runs tests at tiny sizes; they set
    these attributes)."""
    if device.type != "cuda":
        return sys.maxsize, sys.maxsize, float("inf"), float("inf")
    usable = torch.cuda.get_device_properties(device).total_memory * _USABLE_SHARE
    usable = (usable - resident_bytes) / _RESERVED_PER_ALLOCATED
    budget = usable / _ROW_PEAK_BYTES[1000] * _cache_row_bytes(llama_cfg, 1000, 64, 1)
    hard = max(1, int(usable // _ROW_PEAK_BYTES[250]))
    return hard, hard, budget, budget


def clean_token_rows(tokens: np.ndarray, lengths: np.ndarray) -> List[np.ndarray]:
    """Host token compaction (reference tts.py:256-262): each row's tokens
    below its length and below SPEECH_VOCAB_SIZE."""
    return [row[: n][row[: n] < SPEECH_VOCAB_SIZE] for row, n in zip(tokens, lengths)]


def pad_speech(clean_rows: List[np.ndarray]):
    """Clean token rows -> (int32 (B, token bucket) zero-padded, int32 (B,)
    lengths), the bucket from TOKEN_BUCKETS."""
    n_clean = np.array([len(r) for r in clean_rows], np.int32)
    speech = np.zeros((len(clean_rows), _bucket(max(int(n_clean.max()), 2), TOKEN_BUCKETS)),
                      np.int32)
    for i, r in enumerate(clean_rows):
        speech[i, : len(r)] = r
    return speech, n_clean


def collect(handle) -> List[np.ndarray]:
    """A deferred generate_batch result (int16 wav (B, T), lengths (B,)) on
    the device -> one float32 waveform a row on the host (TTS and VC)."""
    wav, wav_lens = handle
    marked = wav.cpu().numpy().astype(np.float32) / 32767.0
    wav_lens = wav_lens.cpu().numpy()
    return [marked[i, : int(wav_lens[i])] for i in range(marked.shape[0])]


def _tile(x, b):
    """Broadcast single-voice (1, ...) conditioning to the batch."""
    return x.expand((b,) + x.shape[1:]) if x.shape[0] == 1 else x


def synthesize(s3gen_params, s3gen_cfg, noise, watermarker, speech, speech_lens, ref: RefDict,
               seed: int, hift_dtype=None, draw_rows=None):
    """Speech tokens -> S3Gen (flow + HiFT + trim-fade) -> watermark ->
    (int16 wav (B, T), wav_lens (B,)). The CFM noise is the first 2*(P + T)
    frames of ``noise``; the vocoder draws from a generator seeded seed + 1
    and runs its trunk in ``hift_dtype`` (None: fp32). ``draw_rows`` =
    (lo, hi, total): these rows are rows [lo, hi) of a batch of ``total``
    split over data-parallel ranks, and take their slice of the vocoder
    noise drawn for all ``total`` rows (``hift_generate``'s draws)."""
    b = speech.shape[0]
    ref = RefDict(*(_tile(x, b) for x in ref))
    total = 2 * (ref.prompt_token.shape[1] + speech.shape[1])
    gen = torch.Generator(device=speech.device).manual_seed(seed + 1)
    phase = additive = None
    if draw_rows is not None:
        lo, hi, n = draw_rows
        h = s3gen_cfg.hift.nb_harmonics + 1
        t = 2 * speech.shape[1] * s3gen_cfg.hift.upsample_total
        u = torch.rand((n, h), generator=gen, device=speech.device)
        phase = (u * (2.0 * np.pi) - np.pi)[lo:hi]
        additive = torch.randn((n, h, t), generator=gen, device=speech.device)[lo:hi]
    wav, wav_lens, _ = s3gen_wav(
        s3gen_params, s3gen_cfg, speech, speech_lens, ref, noise[:, :total].expand(b, total, 80),
        phase_noise=phase, additive_noise=additive, generator=gen, hift_dtype=hift_dtype,
    )
    y = watermarker.apply(wav)
    return torch.round(torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16), wav_lens


@dataclass
class CallInputs:
    """What a call prepares before T3 runs (``ChatterboxTTS.prepare_call``)."""

    conds: Conditionals  # on the device, at the call's exaggeration
    text_tokens: np.ndarray  # int32 (B, text bucket), SOT/EOT framed
    text_lens: np.ndarray  # int32 (B,)
    t3_cond: T3CondData  # broadcast to B rows
    ref: RefDict  # S3Gen's reference, broadcast to B rows
    cache_quant: bool  # T3's KV cache int8
    s3gen_cfg: S3GenConfig  # with the call's CFM step count
    noise: torch.Tensor  # the CFM noise buffer (1, 15000, 80)
    hift_dtype: Optional[torch.dtype]  # the vocoder trunk's (None: fp32)


class ChatterboxTTS:
    """The TTS pipeline over parameter trees of tensors on one device."""

    ENC_COND_LEN = 6 * S3_SR  # the T3 prompt's 6 s cap (tts.py:107)
    DEC_COND_LEN = 10 * S3GEN_SR  # S3Gen's reference: 10 s (tts.py:108)

    def __init__(self, t3_params, s3gen_params, device, tokenizer: Optional[EnTokenizer] = None,
                 t3_cfg: T3Config = T3Config(), s3gen_cfg: S3GenConfig = S3GenConfig(),
                 conds: Optional[Conditionals] = None, kv_quant: Optional[bool] = None,
                 ve_params=None, ve_cfg: VoiceEncoderConfig = VoiceEncoderConfig()):
        self.device = torch.device(device)
        # int8 KV cache: True/False, or None for the auto policy of
        # _kv_quant_for; without an argument CHATTERBOX_KV_QUANT=1/0 decides
        if kv_quant is None:
            kv_quant = {"1": True, "0": False}.get(os.environ.get("CHATTERBOX_KV_QUANT", "auto"))
        self.kv_quant = kv_quant
        # the vocoder's conv trunk in bf16 (its f0 predictor, sine source,
        # source STFT and iSTFT head stay fp32): CHATTERBOX_HIFT_BF16=1;
        # off by default, as in the JAX package (tts.py:127-133)
        self.hift_bf16 = os.environ.get("CHATTERBOX_HIFT_BF16", "0") == "1"
        self.t3_params = t3_params
        self.s3gen_params = s3gen_params
        self.ve_params = ve_params
        self.tokenizer = tokenizer
        self.t3_cfg = t3_cfg
        # the CFM Euler step count: CHATTERBOX_FLOW_STEPS when set (an
        # invalid value raises here)
        self.s3gen_cfg = flow_steps_from_env(s3gen_cfg)
        self.ve_cfg = ve_cfg
        self.conds = conds
        self.sr = S3GEN_SR
        # host seconds of the last generate_batch's stages (each ends in a
        # device-to-host copy, so no extra synchronisation is needed), and
        # its compacted speech tokens, one array a text
        self.last_timings = {}
        self.last_speech_tokens = []
        # with_mesh: the ("data", "model") mesh, and under model sharding
        # T3's local config and the "model" group of its collectives
        self.mesh = None
        self._t3_local_cfg = None
        self._tp_group = None
        # the neural Perth engine when a checkpoint is found, else
        # spread-spectrum (models/watermark.py's factory, tts.py:142)
        self.watermarker = PerthImplicitWatermarker()
        self._cfm_noise = cfm_noise(self.device)
        # the largest batch one dispatch takes, and the largest chunk of the
        # pipelined path, with the KV-cache byte budgets of
        # _budget_batch_cap: the card's own (card_batch_limits), less what
        # the process holds on the card once the weights are there
        resident = (torch.cuda.memory_allocated(self.device) if self.device.type == "cuda"
                    else 0)
        (self.max_device_batch, self.max_pipelined_batch, self.cache_budget_bytes,
         self.pipelined_cache_budget_bytes) = card_batch_limits(self.device, t3_cfg.llama,
                                                                resident)

    # --------------------------------------------------------- weight layout
    @staticmethod
    def _runtime_llama_layout(t3_params) -> bool:
        """True if T3's Llama carries a runtime layout (fused q/k/v and/or
        int8 weights) rather than the canonical dense q/k/v (tts.py:165-171)."""
        layers = t3_params.get("llama", {}).get("layers", {})
        return "qkv" in layers or any(isinstance(v, dict) and "w8" in v for v in layers.values())

    def _unfuse_qkv(self):
        """Restore T3's canonical dense separate-q/k/v layout, in T3's
        working dtype, if a runtime layout is in place (tts.py:153-163)."""
        if self._runtime_llama_layout(self.t3_params):
            dtype = self.t3_params["speech_emb"]["w"].dtype
            self.t3_params = {**self.t3_params, "llama": canonicalize_llama_params(
                self.t3_params["llama"], self.t3_cfg.llama, dtype)}

    def with_mesh(self, mesh, model_sharded: bool = False) -> "ChatterboxTTS":
        """Run ``generate_batch`` over a ("data", "model") mesh
        (``parallel/sharding.make_mesh``), as the JAX package's ``with_mesh``
        (tts.py:174-189): every rank calls it with the same texts, each runs
        its rows of the batch (a multiple of the data axis's size) and
        returns the whole batch's wavs, in order. With ``model_sharded`` T3's
        heads, FFN and vocabulary heads split over "model" (this rank keeps
        its shards). The runtime layouts go first (``_unfuse_qkv``); under a
        mesh the KV cache is the working dtype's, as the JAX package's
        meshed T3 keeps it."""
        from ..parallel.sharding import local_t3_config, shard_params, t3_param_specs

        self._unfuse_qkv()  # the specs address the canonical q/k/v
        self.mesh = mesh
        if model_sharded:
            size = mesh.size(1)
            self._t3_local_cfg = local_t3_config(self.t3_cfg, size)
            self.t3_params = shard_params(self.t3_params, mesh, t3_param_specs(self.t3_params))
            self._tp_group = mesh.get_group("model") if size > 1 else None
        return self

    def _no_mesh(self, what: str):
        if self.mesh is not None:
            raise ValueError(f"{what} does not run under a mesh (with_mesh); generate_batch does")

    # ------------------------------------------------------------------ load
    @classmethod
    def from_random(cls, seed: int = 0, t3_cfg: T3Config = None, s3gen_cfg: S3GenConfig = None,
                    synthetic: bool = False, *, device=None,
                    ve_cfg: VoiceEncoderConfig = None) -> "ChatterboxTTS":
        """Seeded random weights built on the device by the port's own inits
        (T3 and flow in bf16 on the card and fp32 on the CPU; HiFT and the
        conditioning modules fp32). ``synthetic=True`` fills every leaf with
        the generator-free pseudo-noise of ``runtime/fast_init.py`` instead
        (the seed is not used), as the JAX package's ``synthetic=True``."""
        dev = resolve_device(device)
        t3_cfg = t3_cfg or T3Config()
        s3gen_cfg = s3gen_cfg or S3GenConfig()
        ve_cfg = ve_cfg or VoiceEncoderConfig()
        if synthetic:
            t3 = synthetic_init(lambda d: weights.init_t3(t3_cfg, seed, d), _default_dtype(dev),
                                device=dev)
            s3gen = cast_s3gen(synthetic_init(lambda d: random_s3gen(s3gen_cfg, seed, d),
                                              device=dev), dev)
            ve = synthetic_init(lambda d: weights.init_voice_encoder(ve_cfg, seed + 5, d),
                                device=dev)
        else:
            t3 = weights.init_t3(t3_cfg, seed, dev, _default_dtype(dev))
            s3gen = random_s3gen(s3gen_cfg, seed, dev)
            ve = weights.init_voice_encoder(ve_cfg, seed + 5, dev)
        return cls(t3, s3gen, dev, t3_cfg=t3_cfg, s3gen_cfg=s3gen_cfg, ve_params=ve,
                   ve_cfg=ve_cfg)

    @classmethod
    def from_native(cls, ckpt_dir, tokenizer_json=None, *, device=None) -> "ChatterboxTTS":
        """Load a directory written by the JAX package's ``save_native``
        (cast as in ``from_random``; the voice encoder from
        ``ve.jax.safetensors`` when the directory has one)."""
        dev = resolve_device(device)
        ckpt = Path(ckpt_dir)
        t3_cfg, s3gen_cfg, ve_cfg = T3Config(), S3GenConfig(), VoiceEncoderConfig()
        if (ckpt / "config.json").exists():
            t3_cfg, s3gen_cfg, ve_cfg = load_configs(ckpt / "config.json")
        t3_params = weights.tree_to(weights.load_native(ckpt / "t3.jax.safetensors"), dev,
                                    _default_dtype(dev))
        ve_params = None
        if (ckpt / "ve.jax.safetensors").exists():
            ve_params = weights.tree_to(weights.load_native(ckpt / "ve.jax.safetensors"), dev,
                                        torch.float32)
        tok_path = Path(tokenizer_json or ckpt / "tokenizer.json")
        tok = EnTokenizer(str(tok_path)) if tok_path.exists() else None
        conds = None
        if (ckpt / "conds.safetensors").exists():
            conds = Conditionals.load(ckpt / "conds.safetensors")
        s3gen_params = cast_s3gen(weights.load_native(ckpt / "s3gen.jax.safetensors"), dev)
        return cls(t3_params, s3gen_params, dev, tokenizer=tok,
                   t3_cfg=t3_cfg, s3gen_cfg=s3gen_cfg, conds=conds, ve_params=ve_params,
                   ve_cfg=ve_cfg)

    @classmethod
    def from_local(cls, ckpt_dir, conds_path: str = None, *, device=None) -> "ChatterboxTTS":
        """Load the reference checkpoint set (``ve``, ``t3_cfg`` and
        ``s3gen.safetensors``, ``tokenizer.json``, and ``conds.pt`` or else
        ``conds.safetensors``), converting the torch layouts once, as the
        JAX package's ``from_local`` (tts.py:193-225): the default configs
        with the tokenizer's read from the s3gen checkpoint's shapes
        (``infer_s3gen_config``), a uniform ``model.`` key prefix of
        ``t3_cfg`` dropped. Cast as in ``from_random``. Each module's state
        dict is read memory-mapped, converted, moved to the device leaf by
        leaf and dropped before the next is read."""
        dev = resolve_device(device)
        ckpt_dir = Path(ckpt_dir)
        t3_cfg, s3gen_cfg, ve_cfg = T3Config(), S3GenConfig(), VoiceEncoderConfig()
        ve_params = weights.tree_to(weights.from_jax_tree(convert_voice_encoder(
            read_safetensors(ckpt_dir / "ve.safetensors"), ve_cfg)), dev, torch.float32)
        t3_sd = read_safetensors(ckpt_dir / "t3_cfg.safetensors")
        # the reference unwraps a "model"-keyed T3 state (tts.py:146-147);
        # in a safetensors file that is a uniform "model." prefix
        if t3_sd and all(k.startswith("model.") for k in t3_sd):
            t3_sd = {k[len("model."):]: v for k, v in t3_sd.items()}
        t3_params = weights.tree_to(weights.from_jax_tree(convert_t3(t3_sd, t3_cfg)), dev,
                                    _default_dtype(dev))
        del t3_sd
        s3_sd = read_safetensors(ckpt_dir / "s3gen.safetensors")
        s3gen_cfg = infer_s3gen_config(s3_sd, s3gen_cfg)
        s3gen_params = cast_s3gen(weights.from_jax_tree(convert_s3gen(s3_sd, s3gen_cfg)), dev)
        del s3_sd
        conds = None
        conds_file = Path(conds_path or ckpt_dir / "conds.pt")
        if conds_file.exists():
            conds = Conditionals.load_torch(conds_file)
        elif (ckpt_dir / "conds.safetensors").exists():
            conds = Conditionals.load(ckpt_dir / "conds.safetensors")
        tok = EnTokenizer(str(ckpt_dir / "tokenizer.json"))
        return cls(t3_params, s3gen_params, dev, tokenizer=tok, t3_cfg=t3_cfg,
                   s3gen_cfg=s3gen_cfg, conds=conds, ve_params=ve_params, ve_cfg=ve_cfg)

    @classmethod
    def from_pretrained(cls, ckpt_dir=None, *, device=None) -> "ChatterboxTTS":
        """``from_local`` of a directory that already holds the published
        set: no download (tts.py:226-235), so no directory raises."""
        if ckpt_dir is None:
            raise ValueError(
                "No network egress: pass ckpt_dir containing ve/t3_cfg/s3gen "
                ".safetensors + tokenizer.json (the ResembleAI/chatterbox set)")
        return cls.from_local(ckpt_dir, device=device)

    def save_native(self, out_dir):
        """Write the parameters as the native checkpoint the JAX package's
        ``save_native`` writes (tts.py:274-299): ``t3``/``s3gen``/
        ``ve.jax.safetensors`` in its layouts (bf16 leaves as BF16),
        ``config.json`` and ``conds.safetensors``. T3 is written in the
        canonical q/k/v layout from a copy: a runtime layout in place stays."""
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        t3 = self.t3_params
        if self._runtime_llama_layout(t3):
            t3 = {**t3, "llama": canonicalize_llama_params(t3["llama"], self.t3_cfg.llama,
                                                           t3["speech_emb"]["w"].dtype)}
        save_params(weights.jax_layout(t3), out / "t3.jax.safetensors")
        save_params(weights.jax_layout(self.s3gen_params), out / "s3gen.jax.safetensors")
        if self.ve_params is not None:
            save_params(weights.jax_layout(self.ve_params), out / "ve.jax.safetensors")
        save_configs(out / "config.json", self.t3_cfg, self.s3gen_cfg, self.ve_cfg)
        if self.conds is not None:
            self.conds.save(out / "conds.safetensors")

    # ---------------------------------------------------------- conditioning
    @torch.inference_mode()
    def prepare_conditionals(self, wav_fpath_or_array, exaggeration: float = 0.5) -> Conditionals:
        """Reference wav (a path, or a 24 kHz float array) -> Conditionals,
        as the JAX package's ``prepare_conditionals`` (tts.py:329-394):
          - S3Gen's RefDict from the first 10 s at 24 kHz (``embed_ref``);
          - T3's prompt tokens from the first 6 s at 16 kHz, at most
            ``speech_cond_prompt_len`` of them;
          - the voice-encoder embedding of the silence-trimmed 16 kHz wav,
            zero-padded to a 0.5 s bucket, averaging only the windows of the
            unpadded length.
        Both caps pad to whole 40 ms tokens. Also kept as ``self.conds``."""
        if isinstance(wav_fpath_or_array, (str, Path)):
            ref24 = load_wav(wav_fpath_or_array, S3GEN_SR)
        else:
            ref24 = np.asarray(wav_fpath_or_array, np.float32)
        dev = self.device
        with full_fp32():
            ref16 = resample(torch.from_numpy(ref24).to(dev), S3GEN_SR, S3_SR).cpu().numpy()
            dec_ref = pad_to_token_multiple(ref24[: self.DEC_COND_LEN], S3GEN_SR)
            enc_ref = pad_to_token_multiple(ref16[: self.ENC_COND_LEN])
            ve_wav = trim_silence(ref16, top_db=20)
            bucket = S3_SR // 2
            ve_padded = np.zeros(max(-(-len(ve_wav) // bucket) * bucket, bucket), np.float32)
            ve_padded[: len(ve_wav)] = ve_wav
            step = frame_step(self.ve_cfg, self.ve_cfg.default_rate)
            n_valid = num_wins(max(1 + len(ve_wav) // 160, 1), step, self.ve_cfg)  # centred frames

            ref_dict = embed_ref(self.s3gen_params, self.s3gen_cfg,
                                 torch.from_numpy(dec_ref).to(dev)[None], S3GEN_SR)
            prompt_tokens, _ = s3_tokenize(
                self.s3gen_params["tokenizer"], self.s3gen_cfg.tokenizer,
                torch.from_numpy(enc_ref).to(dev)[None], max_len=self.t3_cfg.speech_cond_prompt_len)
            mels = ve_mel_spectrogram(torch.from_numpy(ve_padded).to(dev)[None]).transpose(1, 2)
            ve_embed = ve_embed_from_mels(self.ve_params, self.ve_cfg, mels,
                                          torch.tensor([n_valid], device=dev))
        self.conds = Conditionals(
            T3CondData(ve_embed, prompt_tokens, torch.full((1,), exaggeration, device=dev)),
            ref_dict)
        return self.conds

    # ------------------------------------------------------------- generate
    def generate(
        self,
        text: str,
        repetition_penalty: float = 1.2,
        min_p: float = 0.05,
        top_p: float = 1.0,
        audio_prompt_path=None,
        exaggeration: float = 0.5,
        cfg_weight: float = 0.5,
        temperature: float = 0.8,
        seed: int = 0,
        max_new_tokens: int = 1000,
        min_new_tokens: int = 0,
        num_return_sequences: int = 1,
        greedy: bool = False,
        flow_steps: Optional[int] = None,
        alignment: bool = False,
        *,
        conds: Optional[Conditionals] = None,
    ) -> np.ndarray:
        """One text -> (k, T) float32, k = ``num_return_sequences`` sampled
        variants right-padded to the longest; the JAX package's parameters in
        its order (the reference API's). With ``audio_prompt_path`` the voice
        comes from ``prepare_conditionals`` on that wav, else from ``conds``
        or the pipeline's; the rest as generate_batch."""
        if audio_prompt_path is not None:
            conds = self.prepare_conditionals(audio_prompt_path, exaggeration)
        wavs = self.generate_batch(
            [text] * num_return_sequences, conds=conds, repetition_penalty=repetition_penalty,
            min_p=min_p, top_p=top_p, exaggeration=exaggeration, cfg_weight=cfg_weight,
            temperature=temperature, seed=seed, max_new_tokens=max_new_tokens,
            min_new_tokens=min_new_tokens, greedy=greedy, flow_steps=flow_steps,
            alignment=alignment)
        out = np.zeros((len(wavs), max(len(w) for w in wavs)), np.float32)
        for i, w in enumerate(wavs):
            out[i, : len(w)] = w
        return out

    @torch.inference_mode()
    def generate_batch(
        self,
        texts: List[str],
        conds: Optional[Conditionals] = None,
        repetition_penalty: float = 1.2,
        min_p: float = 0.05,
        top_p: float = 1.0,
        exaggeration: float = 0.5,
        cfg_weight: float = 0.5,
        temperature: float = 0.8,
        seed: int = 0,
        max_new_tokens: int = 1000,
        min_new_tokens: int = 0,
        greedy: bool = False,
        device_chain: bool = False,
        defer_collect: bool = False,
        flow_steps: Optional[int] = None,
        alignment: bool = False,
    ) -> List[np.ndarray]:
        """One T3 decode and one S3Gen pass over the batch -> one float32
        waveform per text (int16 PCM scaled back to [-1, 1]); the JAX
        package's parameters in its order.

        A batch above the one-shot cap (``_budget_batch_cap``) is split
        evenly under the pipelined cap and run through
        ``generate_batches_pipelined`` (chunk c seeded ``seed + c``).

        ``device_chain=True`` compacts the tokens on the device and
        dispatches S3Gen without reading them back; the flow then runs at
        the full ``max_new_tokens`` width. ``defer_collect=True`` (only for
        a batch under the cap, else ValueError) returns the device handle
        (int16 wav (B, T), wav lengths (B,)) for ``collect``.

        ``last_timings`` holds host seconds: ``t3_s`` to T3's return (its
        decode loop ends in a read of the lengths, so T3's device work is
        done by then); ``s3gen_s`` from there to the wav's readback, or
        under ``defer_collect`` to S3Gen's dispatch only. ``last_speech_tokens``
        holds the compacted tokens, one array a text; under ``device_chain``
        they are not read back and it is None.

        ``alignment=True`` runs the hallucination watchdog in the decode loop
        (``models/t3/alignment.py``) on a working-dtype KV cache.
        ``flow_steps`` sets the CFM Euler step count of this call only (the
        quality tier; fewer steps are faster); a value below 1 raises."""
        t_start = time.perf_counter()
        inp = self.prepare_call(texts, conds, exaggeration, max_new_tokens, flow_steps,
                                alignment)
        conds = inp.conds
        b = len(texts)
        tmax = inp.text_tokens.shape[1]
        if b > self._budget_batch_cap(max_new_tokens, False, tmax, alignment):
            self._no_mesh("a batch over the one-shot cap")
            if defer_collect:
                raise ValueError(f"defer_collect takes a batch under the one-shot cap; {b} texts "
                                 f"exceed it at {max_new_tokens} tokens")
            # an even split under the cap (16 at a cap of 11: 8 + 8, not 11 + 5)
            cap = self._budget_batch_cap(max_new_tokens, True, tmax, alignment)
            step = -(-b // -(-b // cap))
            rows = self.generate_batches_pipelined(
                [texts[i:i + step] for i in range(0, b, step)], conds=conds,
                repetition_penalty=repetition_penalty, min_p=min_p, top_p=top_p,
                exaggeration=exaggeration, cfg_weight=cfg_weight, temperature=temperature,
                seed=seed, max_new_tokens=max_new_tokens, min_new_tokens=min_new_tokens,
                greedy=greedy, flow_steps=flow_steps, alignment=alignment)
            return [w for chunk in rows for w in chunk]
        sampling = SamplingConfig(
            temperature=temperature, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
            min_new_tokens=min_new_tokens, greedy=greedy,
        )
        t3c = inp.t3_cond
        # under a mesh this rank's rows, which take their slice of the whole
        # batch's draws; the tokens and wavs are gathered over "data"
        lo, hi = (0, b) if self.mesh is None else data_rows(self.mesh, b)
        draw_rows = None if self.mesh is None else (lo, hi, b)
        with model_parallel(self._tp_group):
            res = t3_generate(
                self.t3_params, self._t3_local_cfg or self.t3_cfg,
                torch.from_numpy(inp.text_tokens[lo:hi]).to(self.device),
                torch.from_numpy(inp.text_lens[lo:hi]).to(self.device), t3c.speaker_emb[lo:hi],
                t3c.prompt_tokens[lo:hi], t3c.emotion_adv[lo:hi], sampling, max_new_tokens,
                generator=torch.Generator(device=self.device).manual_seed(seed),
                alignment=alignment, cache_quant=inp.cache_quant, draw_rows=draw_rows,
            )
        t_t3 = time.perf_counter()

        if device_chain:
            speech, clean_lens = _compact_tokens(res.tokens, res.lengths)
            clean_rows = None
        else:
            tokens, lengths = res.tokens, res.lengths
            if self.mesh is not None:  # the whole batch's tokens fix its token bucket
                tokens, lengths = (gather_rows(x, self.mesh, lo, b) for x in (tokens, lengths))
            clean_rows = clean_token_rows(tokens.cpu().numpy(), lengths.cpu().numpy())
            speech, n_clean = pad_speech(clean_rows)
            speech = torch.from_numpy(speech[lo:hi]).to(self.device)
            clean_lens = torch.from_numpy(n_clean[lo:hi]).to(self.device)

        handle = synthesize(
            self.s3gen_params, inp.s3gen_cfg, inp.noise, self.watermarker, speech, clean_lens,
            RefDict(*(x[lo:hi] for x in inp.ref)), seed, inp.hift_dtype, draw_rows,
        )
        if self.mesh is not None:
            handle = tuple(gather_rows(x, self.mesh, lo, b) for x in handle)
        kv_cache = "int8" if inp.cache_quant else _DTYPE_NAMES[self.t3_params["speech_emb"]["w"].dtype]
        self.last_speech_tokens = clean_rows
        self.last_timings = {"t3_s": t_t3 - t_start, "t3_steps": res.steps,
                             "token_bucket": speech.shape[1], "kv_cache": kv_cache,
                             "alignment": alignment,
                             "flow_steps": inp.s3gen_cfg.flow.n_timesteps,
                             "device_chain": device_chain}
        if defer_collect:
            self.last_timings["s3gen_s"] = time.perf_counter() - t_t3
            return handle
        wavs = self.collect(handle)
        self.last_timings["s3gen_s"] = time.perf_counter() - t_t3
        return wavs

    collect = staticmethod(collect)

    def generate_batches_pipelined(self, batches: List[List[str]], **kw) -> List[List[np.ndarray]]:
        """Several batches, each chunk's readback overlapping the next
        chunk's dispatch: every chunk runs ``device_chain=True,
        defer_collect=True`` and chunk c - 1 is collected after chunk c is
        dispatched. Each batch is split evenly under the pipelined cap,
        sized for the longest text bucket of any chunk; chunk c is seeded
        ``seed + c``. Per-row (B, ...) conds are sliced with
        ``Conditionals.rows`` and must have a row for each text, else
        ValueError. The other keywords are ``generate_batch``'s."""
        base_seed = kw.pop("seed", 0)
        conds = kw.pop("conds", None)
        if conds is not None and conds.t3.speaker_emb.shape[0] > 1:
            total = sum(len(t) for t in batches)
            if conds.t3.speaker_emb.shape[0] != total:
                raise ValueError(f"per-row conds have {conds.t3.speaker_emb.shape[0]} rows for "
                                 f"{total} texts")
        row_lens = [len(self._cap_text_row(self._encode_text(t))) for texts in batches
                    for t in texts]
        tb = _bucket(max(row_lens, default=2), TEXT_BUCKETS)
        cap = self._budget_batch_cap(kw.get("max_new_tokens", 1000), True, tb,
                                     kw.get("alignment", False))
        chunks = []  # (batch index, texts, first conds row)
        off = 0
        for i, texts in enumerate(batches):
            step = -(-len(texts) // -(-len(texts) // cap)) if texts else cap
            chunks.extend((i, texts[j:j + step], off + j) for j in range(0, len(texts), step))
            off += len(texts)
        handles, out = [], [[] for _ in batches]
        for c, (i, texts, o) in enumerate(chunks):
            ck = conds.rows(o, o + len(texts)) if conds is not None else None
            handles.append((i, self.generate_batch(texts, ck, seed=base_seed + c,
                                                   device_chain=True, defer_collect=True, **kw)))
            if len(handles) > 1:
                i0, h = handles.pop(0)
                out[i0].extend(self.collect(h))
        for i0, h in handles:
            out[i0].extend(self.collect(h))
        return out

    @torch.inference_mode()
    def generate_batch_preemptible(
        self,
        texts: List[str],
        conds: Optional[Conditionals] = None,
        lock=None,
        t3_chunk_tokens: int = 50,
        s3gen_max_rows: Optional[int] = None,
        repetition_penalty: float = 1.2,
        min_p: float = 0.05,
        top_p: float = 1.0,
        exaggeration: float = 0.5,
        cfg_weight: float = 0.5,
        temperature: float = 0.8,
        seed: int = 0,
        max_new_tokens: int = 1000,
        min_new_tokens: int = 0,
        flow_steps: Optional[int] = None,
        alignment: bool = False,
    ) -> List[np.ndarray]:
        """``generate_batch`` in bounded pieces, releasing ``lock`` between
        them (tts.py:692-827): T3 runs as ``t3_chunk_tokens``-step chunks of
        the resumable carry (the tokens of one run), and S3Gen in groups of
        at most ``s3gen_max_rows`` rows (None: all), each piece under the
        lock. The serving layer's admission control runs bulk batches so
        while streams are live, so that a stream's tick waits for one piece
        and not for a whole batch.

        A batch above the one-shot cap (``_budget_batch_cap``) is split
        evenly, chunk j seeded ``seed + j``. ``alignment=True`` runs the
        whole-batch ``generate_batch`` under the lock, as the JAX package
        does. With the same seed the tokens and wavs equal
        ``generate_batch``'s."""
        self._no_mesh("generate_batch_preemptible")
        lock = lock if lock is not None else contextlib.nullcontext()
        if alignment:
            with lock:
                return self.generate_batch(
                    texts, conds=conds, repetition_penalty=repetition_penalty, min_p=min_p,
                    top_p=top_p, exaggeration=exaggeration, cfg_weight=cfg_weight,
                    temperature=temperature, seed=seed, max_new_tokens=max_new_tokens,
                    min_new_tokens=min_new_tokens, flow_steps=flow_steps, alignment=True)
        inp = self.prepare_call(texts, conds, exaggeration, max_new_tokens, flow_steps)
        conds = inp.conds
        b = len(texts)
        cap = self._budget_batch_cap(max_new_tokens, False, inp.text_tokens.shape[1])
        if b > cap:
            step = -(-b // -(-b // cap))
            out = []
            for j, i0 in enumerate(range(0, b, step)):
                sub = texts[i0:i0 + step]
                out.extend(self.generate_batch_preemptible(
                    sub, conds.rows(i0, i0 + len(sub)), lock, t3_chunk_tokens, s3gen_max_rows,
                    repetition_penalty, min_p, top_p, exaggeration, cfg_weight, temperature,
                    seed + j, max_new_tokens, min_new_tokens, flow_steps))
            return out
        sampling = SamplingConfig(
            temperature=temperature, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
            min_new_tokens=min_new_tokens,
        )
        t3c = inp.t3_cond
        lens_d = torch.from_numpy(inp.text_lens).to(self.device)
        with lock:
            carry = t3_generate_start(
                self.t3_params, self.t3_cfg, torch.from_numpy(inp.text_tokens).to(self.device),
                lens_d, t3c.speaker_emb, t3c.prompt_tokens, t3c.emotion_adv, sampling,
                max_new_tokens, cache_quant=inp.cache_quant,
                generator=torch.Generator(device=self.device).manual_seed(seed))
        while True:
            with lock:
                carry, res = t3_generate_resume(self.t3_params, self.t3_cfg, carry, lens_d,
                                                sampling, t3_chunk_tokens)
                finished = bool(carry.done.all())  # waits for the chunk
            if finished or res.steps >= max_new_tokens:
                break
        clean_rows = clean_token_rows(res.tokens.cpu().numpy(), res.lengths.cpu().numpy())
        del carry  # the KV cache and K1's workspace go before S3Gen
        speech, clean_lens = pad_speech(clean_rows)

        rows_cap = s3gen_max_rows or b
        handles = []
        for i0 in range(0, b, rows_cap):
            i1 = min(b, i0 + rows_cap)
            with lock:
                handles.append(synthesize(
                    self.s3gen_params, inp.s3gen_cfg, inp.noise, self.watermarker,
                    torch.from_numpy(speech[i0:i1]).to(self.device),
                    torch.from_numpy(clean_lens[i0:i1]).to(self.device),
                    RefDict(*(x[i0:i1] for x in inp.ref)), seed, inp.hift_dtype))
        self.last_speech_tokens = clean_rows
        # the readbacks do not occupy the device: no lock
        return [w for h in handles for w in self.collect(h)]

    def prepare_call(self, texts: List[str], conds: Optional[Conditionals], exaggeration: float,
                     max_new_tokens: int, flow_steps: Optional[int] = None,
                     alignment: bool = False) -> CallInputs:
        """The inputs of one call over ``texts``, as ``generate_batch``,
        ``generate_batch_preemptible`` and ``pipeline/streaming.py`` use
        them: ``conds`` (else the pipeline's; neither: ValueError) on the
        device at ``exaggeration``, the framed text ids, the conditioning
        broadcast to the batch, the cache policy (alignment forces the
        working-dtype cache), the S3Gen config at ``flow_steps`` (below 1:
        ValueError), the CFM noise buffer and the vocoder's dtype."""
        s3gen_cfg = with_flow_steps(self.s3gen_cfg, self._effective_flow_steps(flow_steps))
        conds = conds or self.conds
        if conds is None:
            raise ValueError("no voice conditionals: pass conds or set self.conds")
        conds = conds.to(self.device)
        if bool((conds.t3.emotion_adv != exaggeration).any()):
            conds = conds.with_exaggeration(exaggeration)
        b = len(texts)
        text_tokens, lens = self._text_batch(texts)
        return CallInputs(
            conds=conds, text_tokens=text_tokens, text_lens=lens,
            t3_cond=T3CondData(*(_tile(x, b) for x in conds.t3)),
            ref=RefDict(*(_tile(x, b) for x in conds.gen)),
            cache_quant=self._kv_quant_for(max_new_tokens) and not alignment and self.mesh is None,
            s3gen_cfg=s3gen_cfg, noise=self._cfm_noise,
            hift_dtype=torch.bfloat16 if self.hift_bf16 else None)

    def _effective_flow_steps(self, flow_steps: Optional[int]) -> int:
        """The call's CFM step count: ``flow_steps``, else the pipeline's
        (tts.py:914-921). A value below 1 raises ValueError."""
        if flow_steps is None:
            return self.s3gen_cfg.flow.n_timesteps
        if flow_steps < 1:
            raise ValueError(f"flow_steps must be >= 1, got {flow_steps}")
        return int(flow_steps)

    def _budget_batch_cap(self, max_new_tokens: int, pipelined: bool, text_bucket: int = 64,
                          alignment: bool = False) -> int:
        """The largest batch one dispatch takes at this token budget and
        text bucket: the JAX package's formula (tts.py:598-627), T3's
        KV-cache bytes per text against a byte budget, capped by
        ``max_device_batch`` (and ``max_pipelined_batch`` when
        ``pipelined``), with the budgets the card's (``card_batch_limits``).
        The cache is counted as the one the call uses: one byte a value on
        the int8 cache, two on the bf16 one, which alignment and a mesh
        force (the JAX package counts one byte there too). Under a mesh a
        rank holds its rows' cache of its own heads: the cap counts those
        and comes back for the whole batch."""
        quant = self._kv_quant_for(max_new_tokens) and not alignment and self.mesh is None
        llama = (self._t3_local_cfg or self.t3_cfg).llama
        per_row = _cache_row_bytes(llama, max_new_tokens, text_bucket, 1 if quant else 2)
        data = 1 if self.mesh is None else self.mesh.size(0)
        if pipelined:
            budget = self.pipelined_cache_budget_bytes
            hard = min(self.max_device_batch, self.max_pipelined_batch)
        else:
            budget, hard = self.cache_budget_bytes, self.max_device_batch
        return max(1, int(min(hard, budget // max(per_row, 1)))) * data

    def _kv_quant_for(self, max_new_tokens: int) -> bool:
        """Whether T3 keeps its KV cache int8 at this token budget: the
        explicit setting when there is one, else from 500 tokens on (the
        JAX package's policy, tts.py:589-596). Alignment overrides it."""
        if self.kv_quant is not None:
            return self.kv_quant
        return max_new_tokens >= 500

    # ------------------------------------------------------------- internals
    def _text_batch(self, texts: List[str]):
        """Texts -> (int32 (B, text bucket) ids with SOT/EOT framing,
        right-padded; int32 (B,) lengths)."""
        rows = [self._cap_text_row(self._encode_text(t)) for t in texts]
        lens = np.array([len(r) for r in rows], np.int32)
        text_tokens = np.zeros((len(rows), _bucket(int(lens.max()), TEXT_BUCKETS)), np.int32)
        for i, r in enumerate(rows):
            text_tokens[i, : len(r)] = r
        return text_tokens, lens

    def _encode_text(self, text: str) -> np.ndarray:
        text = punc_norm(text)
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(text)
        else:  # random-weights mode: hash chars into the text vocab
            ids = [(ord(c) % 700) + 1 for c in text]
        sot, eot = self.t3_cfg.start_text_token, self.t3_cfg.stop_text_token
        return np.array([sot] + list(ids) + [eot], np.int32)

    @staticmethod
    def _cap_text_row(row: np.ndarray) -> np.ndarray:
        """Truncate an encoded row to the largest text bucket, keeping EOT."""
        cap = TEXT_BUCKETS[-1]
        if len(row) <= cap:
            return row
        return np.concatenate([row[: cap - 1], row[-1:]]).astype(np.int32)

