"""ChatterboxVC: voice conversion, source speech -> the target voice.

Port of ``chatterbox_tpu/pipeline/vc.py`` (reference vc.py): the target
voice becomes a RefDict (``embed_ref`` on its first 10 s); the sources are
packed as int16 PCM into one batch bucketed by TOKEN_BUCKETS, tokenized by
the S3 tokenizer with each row's pad region masked, re-synthesised by S3Gen
with the target's RefDict, and watermarked. Entry points run on ``cuda``
unless the caller passes ``device``; without a GPU and without a device
they raise.

The CFM Euler step count is the config's, or ``CHATTERBOX_FLOW_STEPS`` at
construction, or ``flow_steps`` per call (VC is flow-bound, so fewer steps
are the large speed lever).

Not in this slice: ``defer_collect``/``collect``,
``generate_batches_pipelined`` and ``with_mesh``.
"""

import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from ..checkpoint.config_io import load_configs
from ..constants import S3_SR, S3GEN_SR
from ..device import full_fp32, resolve_device
from ..models.s3gen.s3gen import (RefDict, S3GenConfig, embed_ref, flow_steps_from_env,
                                  with_flow_steps)
from ..models.s3tokenizer import pad_to_token_multiple, s3_tokenize
from ..models.watermark import SpreadSpectrumWatermarker
from .audio import load_wav
from .tts import TOKEN_BUCKETS, _bucket, cfm_noise, native_s3gen, random_s3gen, synthesize

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
        self.watermarker = SpreadSpectrumWatermarker()
        self._cfm_noise = cfm_noise(self.device)
        # host seconds of the last generate_batch, ending in the int16 copy
        self.last_timings = {}

    @classmethod
    def from_random(cls, seed: int = 0, s3gen_cfg: S3GenConfig = None,
                    device=None) -> "ChatterboxVC":
        """Seeded random S3Gen weights from the port's own inits (as
        ``ChatterboxTTS.from_random`` builds them for the same seed)."""
        dev = resolve_device(device)
        s3gen_cfg = s3gen_cfg or S3GenConfig()
        return cls(random_s3gen(s3gen_cfg, seed, dev), dev, s3gen_cfg)

    @classmethod
    def from_native(cls, ckpt_dir, device=None) -> "ChatterboxVC":
        """Load S3Gen from a directory written by the JAX package's
        ``save_native`` (the flow in the working dtype, the rest fp32)."""
        dev = resolve_device(device)
        ckpt = Path(ckpt_dir)
        s3gen_cfg = S3GenConfig()
        if (ckpt / "config.json").exists():
            s3gen_cfg = load_configs(ckpt / "config.json")[1]
        return cls(native_s3gen(ckpt / "s3gen.jax.safetensors", dev), dev, s3gen_cfg)

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

    @torch.inference_mode()
    def generate_batch(self, audios: List, target_voice_path=None, seed: int = 0,
                       flow_steps: Optional[int] = None) -> List[np.ndarray]:
        """Sources -> one float32 waveform each (int16 PCM scaled back to
        [-1, 1]), 2 * 480 samples a source token. ``flow_steps`` sets the
        CFM Euler step count of this call only."""
        n_steps = self._effective_flow_steps(flow_steps)
        if target_voice_path is not None:
            self.set_target_voice(target_voice_path)
        if self.ref_dict is None:
            raise ValueError("no target voice: call set_target_voice or pass target_voice_path")
        t_start = time.perf_counter()
        batch, n_toks, wav_bucket = self._pack_sources(audios)
        lens = torch.from_numpy(n_toks).to(self.device)
        wav16 = torch.from_numpy(batch).to(self.device).float() / 32768.0
        with full_fp32():
            # pad keys masked: a row's tokens must not depend on its batch-mates
            tokens, _ = s3_tokenize(self.s3gen_params["tokenizer"], self.s3gen_cfg.tokenizer,
                                    wav16, wav_lens=lens * _SAMPLES_PER_TOKEN)
        wav, wav_lens = synthesize(self.s3gen_params, with_flow_steps(self.s3gen_cfg, n_steps),
                                   self._cfm_noise, self.watermarker, tokens, lens, self.ref_dict,
                                   seed)
        marked = wav.cpu().numpy().astype(np.float32) / 32767.0
        wav_lens = wav_lens.cpu().numpy()
        self.last_timings = {"vc_s": time.perf_counter() - t_start,
                             "token_bucket": wav_bucket // _SAMPLES_PER_TOKEN,
                             "flow_steps": n_steps}
        return [marked[i, : int(wav_lens[i])] for i in range(len(audios))]
