"""ChatterboxTTS: zero-shot TTS from precomputed voice conditionals.

Port of the main path of ``chatterbox_tpu/pipeline/tts.py``:
text -> ids -> T3 (CFG decode) -> host token compaction -> S3Gen (flow +
HiFT + trim-fade) -> spread-spectrum watermark -> int16 PCM. Shapes are
bucketed as in the JAX package (TEXT_BUCKETS, TOKEN_BUCKETS) so both
packages see the same padded batches. Entry points run on ``cuda`` unless
the caller passes ``device``; without a GPU and without a device they raise.

Not in this slice: conditioning from a raw wav, alignment, streaming, the
int8 KV cache, batch splitting under a memory budget, and serving.
"""

import time
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .. import weights
from ..checkpoint.config_io import load_configs
from ..constants import S3GEN_SR, SPEECH_VOCAB_SIZE
from ..core.sampling import SamplingConfig
from ..device import resolve_device
from ..models.s3gen.s3gen import RefDict, S3GenConfig, s3gen_wav
from ..models.t3.t3 import T3Config, t3_generate
from ..models.tokenizer import EnTokenizer
from ..models.watermark import SpreadSpectrumWatermarker
from .conditionals import Conditionals, T3CondData

TEXT_BUCKETS = (32, 64, 128, 256, 512)
TOKEN_BUCKETS = (64, 125, 250, 500, 750, 1000)


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


def _default_dtype(device: torch.device) -> torch.dtype:
    """T3 and the flow run bf16 on the card and fp32 on the CPU."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


class ChatterboxTTS:
    """The TTS pipeline over parameter trees of tensors on one device."""

    def __init__(self, t3_params, s3gen_params, device, tokenizer: Optional[EnTokenizer] = None,
                 t3_cfg: T3Config = T3Config(), s3gen_cfg: S3GenConfig = S3GenConfig(),
                 conds: Optional[Conditionals] = None):
        self.device = torch.device(device)
        self.t3_params = t3_params
        self.s3gen_params = s3gen_params
        self.tokenizer = tokenizer
        self.t3_cfg = t3_cfg
        self.s3gen_cfg = s3gen_cfg
        self.conds = conds
        self.sr = S3GEN_SR
        # host seconds of the last generate_batch's stages (each ends in a
        # device-to-host copy, so no extra synchronisation is needed)
        self.last_timings = {}
        self.watermarker = SpreadSpectrumWatermarker()
        # the fixed CFM noise buffer (reference flow_matching.py:191), built
        # with numpy so both packages hold the same bits
        self._cfm_noise = torch.from_numpy(
            np.random.default_rng(0).standard_normal((1, 15000, 80)).astype(np.float32)
        ).to(self.device)

    # ------------------------------------------------------------------ load
    @classmethod
    def from_random(cls, seed: int = 0, t3_cfg: T3Config = None, s3gen_cfg: S3GenConfig = None,
                    device=None) -> "ChatterboxTTS":
        """Seeded random weights built on the device by the port's own inits
        (T3 and flow in bf16 on the card and fp32 on the CPU; HiFT fp32)."""
        dev = resolve_device(device)
        dtype = _default_dtype(dev)
        t3_cfg = t3_cfg or T3Config()
        s3gen_cfg = s3gen_cfg or S3GenConfig()
        t3_params = weights.init_t3(t3_cfg, seed, dev, dtype)
        s3gen_params = {
            "flow": weights.init_flow(s3gen_cfg.flow, seed + 1, dev, dtype),
            "hift": weights.init_hift(s3gen_cfg.hift, seed + 2, dev),
        }
        return cls(t3_params, s3gen_params, dev, t3_cfg=t3_cfg, s3gen_cfg=s3gen_cfg)

    @classmethod
    def from_native(cls, ckpt_dir, device=None, tokenizer_json=None) -> "ChatterboxTTS":
        """Load a directory written by the JAX package's ``save_native``
        (T3 and flow cast as in ``from_random``; HiFT fp32)."""
        dev = resolve_device(device)
        dtype = _default_dtype(dev)
        ckpt = Path(ckpt_dir)
        t3_cfg, s3gen_cfg = T3Config(), S3GenConfig()
        if (ckpt / "config.json").exists():
            t3_cfg, s3gen_cfg = load_configs(ckpt / "config.json")
        s3 = weights.load_native(ckpt / "s3gen.jax.safetensors")
        s3gen_params = {
            "flow": weights.tree_to(s3["flow"], dev, dtype),
            "hift": weights.tree_to(s3["hift"], dev, torch.float32),
        }
        t3_params = weights.tree_to(weights.load_native(ckpt / "t3.jax.safetensors"), dev, dtype)
        tok_path = Path(tokenizer_json or ckpt / "tokenizer.json")
        tok = EnTokenizer(str(tok_path)) if tok_path.exists() else None
        conds = None
        if (ckpt / "conds.safetensors").exists():
            conds = Conditionals.load(ckpt / "conds.safetensors")
        return cls(t3_params, s3gen_params, dev, tokenizer=tok, t3_cfg=t3_cfg,
                   s3gen_cfg=s3gen_cfg, conds=conds)

    # ------------------------------------------------------------- generate
    def generate(self, text: str, num_return_sequences: int = 1, **kw) -> np.ndarray:
        """One text -> (k, T) float32, k = ``num_return_sequences`` sampled
        variants right-padded to the longest; keywords as generate_batch."""
        wavs = self.generate_batch([text] * num_return_sequences, **kw)
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
    ) -> List[np.ndarray]:
        """One T3 decode and one S3Gen pass over the batch -> one float32
        waveform per text (int16 PCM scaled back to [-1, 1])."""
        t_start = time.perf_counter()
        conds = conds or self.conds
        if conds is None:
            raise ValueError("no voice conditionals: pass conds or set self.conds")
        conds = conds.to(self.device)
        if bool((conds.t3.emotion_adv != exaggeration).any()):
            conds = conds.with_exaggeration(exaggeration)

        b = len(texts)
        tok_rows = [self._cap_text_row(self._encode_text(t)) for t in texts]
        lens = np.array([len(r) for r in tok_rows], np.int32)
        tmax = _bucket(int(lens.max()), TEXT_BUCKETS)
        text_tokens = np.zeros((b, tmax), np.int32)
        for i, r in enumerate(tok_rows):
            text_tokens[i, : len(r)] = r
        sampling = SamplingConfig(
            temperature=temperature, top_p=top_p, min_p=min_p,
            repetition_penalty=repetition_penalty, cfg_weight=cfg_weight,
            min_new_tokens=min_new_tokens, greedy=greedy,
        )
        t3c = T3CondData(*(self._tile(x, b) for x in conds.t3))
        res = t3_generate(
            self.t3_params, self.t3_cfg, torch.from_numpy(text_tokens).to(self.device),
            torch.from_numpy(lens).to(self.device), t3c.speaker_emb, t3c.prompt_tokens,
            t3c.emotion_adv, sampling, max_new_tokens,
            generator=torch.Generator(device=self.device).manual_seed(seed),
        )

        # host: drop invalid tokens per row (reference tts.py:256-262)
        tokens, tok_lens = res.tokens.cpu().numpy(), res.lengths.cpu().numpy()
        t_t3 = time.perf_counter()
        clean_rows = []
        for i in range(b):
            row = tokens[i, : tok_lens[i]]
            clean_rows.append(row[row < SPEECH_VOCAB_SIZE])
        clean_lens = np.array([len(r) for r in clean_rows], np.int32)
        tbucket = _bucket(max(int(clean_lens.max()), 2), TOKEN_BUCKETS)
        speech = np.zeros((b, tbucket), np.int32)
        for i, r in enumerate(clean_rows):
            speech[i, : len(r)] = r

        wav, wav_lens = self._run_s3gen(
            torch.from_numpy(speech).to(self.device), torch.from_numpy(clean_lens).to(self.device),
            conds.gen, b, seed,
        )
        marked = wav.cpu().numpy().astype(np.float32) / 32767.0
        wav_lens = wav_lens.cpu().numpy()
        self.last_timings = {"t3_s": t_t3 - t_start, "s3gen_s": time.perf_counter() - t_t3,
                             "t3_steps": res.steps, "token_bucket": tbucket}
        return [marked[i, : int(wav_lens[i])] for i in range(b)]

    # ------------------------------------------------------------- internals
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

    @staticmethod
    def _tile(x, b):
        """Broadcast single-voice (1, ...) conditioning to the batch."""
        return x.expand((b,) + x.shape[1:]) if x.shape[0] == 1 else x

    def _run_s3gen(self, speech, speech_lens, ref: RefDict, b: int, seed: int):
        """Flow + HiFT + trim-fade, then the watermark -> (int16 wav, lens)."""
        ref = RefDict(*(self._tile(x, b) for x in ref))
        total = 2 * (ref.prompt_token.shape[1] + speech.shape[1])
        noise = self._cfm_noise[:, :total].expand(b, total, 80)
        wav, wav_lens, _ = s3gen_wav(
            self.s3gen_params, self.s3gen_cfg, speech, speech_lens, ref, noise,
            generator=torch.Generator(device=self.device).manual_seed(seed + 1),
        )
        y = self.watermarker.apply(wav)
        return torch.round(torch.clamp(y, -1.0, 1.0) * 32767.0).to(torch.int16), wav_lens
