"""ChatterboxVC: voice conversion, source speech -> the target voice.

Port of ``chatterbox_tpu/pipeline/vc.py`` (reference vc.py): the target
voice becomes a RefDict (``embed_ref`` on its first 10 s); the sources are
packed as int16 PCM into one batch bucketed by TOKEN_BUCKETS, tokenized by
the S3 tokenizer with each row's pad region masked, re-synthesised by S3Gen
with the target's RefDict, and watermarked (``CHATTERBOX_HIFT_BF16=1`` runs
the vocoder's conv trunk in bf16, as in TTS). Entry points run on ``cuda``
unless the caller passes ``device``; without a GPU and without a device
they raise.

The CFM Euler step count is the config's, or ``CHATTERBOX_FLOW_STEPS`` at
construction, or ``flow_steps`` per call (VC is flow-bound, so fewer steps
are the large speed lever).

``generate_batch(defer_collect=True)`` returns the device handle for
``collect``; ``generate_batches_pipelined`` converts several batches, one
thread packing batch c + 1 on the host while batch c computes, and batch
c - 1 collected after batch c is dispatched. The sources' copies to the
card (~1.5 MB a batch of 8) run on the caller's stream.

``with_mesh`` splits a batch's sources over the "data" axis of a mesh.
"""

import os
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import weights
from ..checkpoint.config_io import load_configs
from ..checkpoint.torch_convert import read_safetensors
from ..constants import S3_SR, S3GEN_SR
from ..device import full_fp32, resolve_device
from ..models.s3gen.s3gen import (RefDict, S3GenConfig, convert_s3gen, embed_ref,
                                  flow_steps_from_env, with_flow_steps)
from ..models.s3tokenizer import pad_to_token_multiple, s3_tokenize
from ..models.watermark import PerthImplicitWatermarker
from ..parallel.sharding import data_rows, gather_rows
from .audio import load_wav
from .conditionals import Conditionals
from .tts import TOKEN_BUCKETS, _bucket, cast_s3gen, cfm_noise, collect, random_s3gen, synthesize

_SAMPLES_PER_TOKEN = S3_SR // 25  # 640 at 16 kHz


class ChatterboxVC:
    """The VC pipeline over S3Gen parameter trees of tensors on one device."""

    DEC_COND_LEN = 10 * S3GEN_SR

    def __init__(self, s3gen_params, device, s3gen_cfg: S3GenConfig = S3GenConfig(),
                 ref_dict: Optional[RefDict] = None):
        self.device = torch.device(device)
        self.s3gen_params = s3gen_params
        # CHATTERBOX_FLOW_STEPS when set (an invalid value raises here)
        self.s3gen_cfg = flow_steps_from_env(s3gen_cfg)
        self.ref_dict = ref_dict
        self.sr = S3GEN_SR
        # the vocoder's conv trunk in bf16: CHATTERBOX_HIFT_BF16=1, read at
        # construction as the JAX package's field is (vc.py:41-43)
        self.hift_bf16 = os.environ.get("CHATTERBOX_HIFT_BF16", "0") == "1"
        self.mesh = None  # with_mesh
        self.watermarker = PerthImplicitWatermarker()
        self._cfm_noise = cfm_noise(self.device)
        # host seconds of the last generate_batch, ending in the int16 copy
        # (under defer_collect, in S3Gen's dispatch)
        self.last_timings = {}

    def with_mesh(self, mesh) -> "ChatterboxVC":
        """Data-parallel VC over a ("data", "model") mesh
        (``parallel/sharding.make_mesh``), as the JAX package's
        ``with_mesh`` (vc.py:59-66): every rank calls ``generate_batch`` with
        the same sources, converts its rows (the batch a multiple of the data
        axis's size; the weights replicated) and returns every source's wav,
        in order."""
        self.mesh = mesh
        return self

    @classmethod
    def from_random(cls, seed: int = 0, s3gen_cfg: S3GenConfig = None, *,
                    device=None) -> "ChatterboxVC":
        """Seeded random S3Gen weights from the port's own inits (as
        ``ChatterboxTTS.from_random`` builds them for the same seed)."""
        dev = resolve_device(device)
        s3gen_cfg = s3gen_cfg or S3GenConfig()
        return cls(random_s3gen(s3gen_cfg, seed, dev), dev, s3gen_cfg)

    @classmethod
    def from_native(cls, ckpt_dir, *, device=None) -> "ChatterboxVC":
        """Load S3Gen from a directory written by the JAX package's
        ``save_native`` (the flow in the working dtype, the rest fp32)."""
        dev = resolve_device(device)
        ckpt = Path(ckpt_dir)
        s3gen_cfg = S3GenConfig()
        if (ckpt / "config.json").exists():
            s3gen_cfg = load_configs(ckpt / "config.json")[1]
        return cls(cast_s3gen(weights.load_native(ckpt / "s3gen.jax.safetensors"), dev), dev,
                   s3gen_cfg)

    @classmethod
    def from_local(cls, ckpt_dir, *, device=None) -> "ChatterboxVC":
        """S3Gen from the reference set's ``s3gen.safetensors`` at the default
        config, and the target voice from its ``conds.pt`` when there is
        one, as the JAX package's ``from_local`` (vc.py:69-80); cast as in
        ``from_random``."""
        dev = resolve_device(device)
        ckpt_dir = Path(ckpt_dir)
        cfg = S3GenConfig()
        params = cast_s3gen(weights.from_jax_tree(convert_s3gen(
            read_safetensors(ckpt_dir / "s3gen.safetensors"), cfg)), dev)
        ref_dict = None
        if (ckpt_dir / "conds.pt").exists():
            gen = Conditionals.load_torch(ckpt_dir / "conds.pt").gen
            ref_dict = RefDict(*(x.to(dev) for x in gen))
        return cls(params, dev, cfg, ref_dict)

    @torch.inference_mode()
    def set_target_voice(self, wav_fpath_or_array) -> RefDict:
        """The target voice (a path, or a 24 kHz float array) -> its RefDict,
        from the first 10 s padded to whole 40 ms tokens (vc.py:76-81)."""
        if isinstance(wav_fpath_or_array, (str, Path)):
            ref = load_wav(wav_fpath_or_array, S3GEN_SR)
        else:
            ref = np.asarray(wav_fpath_or_array, np.float32)
        ref = pad_to_token_multiple(ref[: self.DEC_COND_LEN], S3GEN_SR)
        with full_fp32():
            self.ref_dict = embed_ref(self.s3gen_params, self.s3gen_cfg,
                                      torch.from_numpy(ref).to(self.device)[None], S3GEN_SR)
        return self.ref_dict

    def generate(self, audio, target_voice_path=None, seed: int = 0,
                 flow_steps: Optional[int] = None) -> np.ndarray:
        """One source (a path, or a 16 kHz float array) -> (1, T) waveform."""
        return self.generate_batch([audio], target_voice_path, seed=seed,
                                   flow_steps=flow_steps)[0][None]

    def _effective_flow_steps(self, flow_steps: Optional[int]) -> int:
        """The call's CFM step count: ``flow_steps``, else the pipeline's
        (vc.py:146-152). A value below 1 raises ValueError."""
        if flow_steps is None:
            return self.s3gen_cfg.flow.n_timesteps
        if flow_steps < 1:
            raise ValueError(f"flow_steps must be >= 1, got {flow_steps}")
        return int(flow_steps)

    @staticmethod
    def _pack_sources(audios: List):
        """Sources -> (int16 PCM batch (B, bucket * 640), tokens per row,
        bucket * 640). Each source is cut to the largest token bucket and
        padded to whole tokens. The int16 round trip is the JAX package's
        (its host-to-device format): it changes the samples the tokenizer
        sees, so parity keeps it."""
        srcs = []
        for a in audios:
            wav = load_wav(a, S3_SR) if isinstance(a, (str, Path)) else np.asarray(a, np.float32)
            srcs.append(pad_to_token_multiple(wav[: TOKEN_BUCKETS[-1] * _SAMPLES_PER_TOKEN]))
        n_toks = np.array([len(s) // _SAMPLES_PER_TOKEN for s in srcs], np.int32)
        wav_bucket = _bucket(int(n_toks.max()), TOKEN_BUCKETS) * _SAMPLES_PER_TOKEN
        batch = np.zeros((len(srcs), wav_bucket), np.int16)
        for i, s in enumerate(srcs):
            batch[i, : len(s)] = np.clip(np.round(s * 32768.0), -32768, 32767).astype(np.int16)
        return batch, n_toks, wav_bucket

    def _upload_sources(self, packed):
        """Packed sources -> (int16 batch, tokens per row, bucket * 640) on
        the device, copied on the caller's stream."""
        batch, n_toks, wav_bucket = packed
        return (torch.from_numpy(batch).to(self.device), torch.from_numpy(n_toks).to(self.device),
                wav_bucket)

    @torch.inference_mode()
    def generate_batch(self, audios: List = None, target_voice_path=None, seed: int = 0,
                       defer_collect: bool = False, _uploaded=None,
                       flow_steps: Optional[int] = None) -> List[np.ndarray]:
        """Sources -> one float32 waveform each (int16 PCM scaled back to
        [-1, 1]), 2 * 480 samples a source token; the JAX package's
        parameters in its order. ``defer_collect=True`` returns the device
        handle (int16 wav (B, T), wav lengths (B,)) for ``collect``.
        ``_uploaded``: sources already on the device from
        ``_upload_sources`` (the pipelined path). ``flow_steps`` sets the CFM
        Euler step count of this call only."""
        n_steps = self._effective_flow_steps(flow_steps)
        if target_voice_path is not None:
            self.set_target_voice(target_voice_path)
        if self.ref_dict is None:
            raise ValueError("no target voice: call set_target_voice or pass target_voice_path")
        t_start = time.perf_counter()
        if _uploaded is None:
            _uploaded = self._upload_sources(self._pack_sources(audios))
        batch, lens, wav_bucket = _uploaded
        b = batch.shape[0]
        lo, hi = (0, b) if self.mesh is None else data_rows(self.mesh, b)
        batch, lens = batch[lo:hi], lens[lo:hi]
        wav16 = batch.float() / 32768.0
        with full_fp32():
            # pad keys masked: a row's tokens must not depend on its batch-mates
            tokens, _ = s3_tokenize(self.s3gen_params["tokenizer"], self.s3gen_cfg.tokenizer,
                                    wav16, wav_lens=lens * _SAMPLES_PER_TOKEN)
        handle = synthesize(self.s3gen_params, with_flow_steps(self.s3gen_cfg, n_steps),
                            self._cfm_noise, self.watermarker, tokens, lens, self.ref_dict, seed,
                            torch.bfloat16 if self.hift_bf16 else None,
                            None if self.mesh is None else (lo, hi, b))
        if self.mesh is not None:
            handle = tuple(gather_rows(x, self.mesh, lo, b) for x in handle)
        if not defer_collect:
            handle = self.collect(handle)
        self.last_timings = {"vc_s": time.perf_counter() - t_start,
                             "token_bucket": wav_bucket // _SAMPLES_PER_TOKEN,
                             "flow_steps": n_steps}
        return handle

    collect = staticmethod(collect)

    def generate_batches_pipelined(self, batches: List[List], target_voice_path=None,
                                   seed: int = 0,
                                   flow_steps: Optional[int] = None) -> List[List[np.ndarray]]:
        """Convert several batches (batch c seeded ``seed + c``), as
        per-batch ``generate_batch`` calls would, with one thread packing
        batch c + 1 (reading and padding its sources on the host) while
        batch c computes, and batch c - 1 collected after batch c is
        dispatched. The copies to the device run here, on the caller's
        stream: a batch's ~1.5 MB is not worth a stream of its own."""
        if target_voice_path is not None:
            self.set_target_voice(target_voice_path)
        handles, out = [], []
        with ThreadPoolExecutor(1, thread_name_prefix="vc-pack") as ex:
            fut = ex.submit(self._pack_sources, batches[0])
            for c in range(len(batches)):
                packed = fut.result()
                if c + 1 < len(batches):
                    fut = ex.submit(self._pack_sources, batches[c + 1])
                handles.append(self.generate_batch(seed=seed + c, defer_collect=True,
                                                   _uploaded=self._upload_sources(packed),
                                                   flow_steps=flow_steps))
                if len(handles) > 1:
                    out.append(self.collect(handles.pop(0)))
        out.extend(self.collect(h) for h in handles)
        return out
