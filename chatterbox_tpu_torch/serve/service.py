"""Serving logic: one TTSService with plain-function route handlers, which
the stdlib HTTP server (``serve/server.py``) exposes. Port of the JAX
package's ``serve/service.py``, with its route set: /health, /generate,
/generate/stream, /emotions CRUD + test, /voices upload/list/remove,
/outputs files and the / web UI.

The model: the ``tts`` given, else ``model_dir`` loaded with
``from_native`` (a native checkpoint) or ``from_local`` (the reference
checkpoint set), else seeded random weights (a development server), on
the configured device (``auto``: the card, never the CPU on its own).
``health()``
reports the torch device and its allocator's memory. Unlike the JAX
package, ``/generate/stream`` refuses ``alignment=true`` (a ValueError: 400)
instead of dropping it: the streaming carry runs no watchdog.
"""

import base64
import io
import logging
import time
import uuid
import wave
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..device import resolve_device
from ..pipeline.tts import ChatterboxTTS
from .batcher import DynamicBatcher, StreamBatcher
from .config import ServerConfig
from .fairlock import FairRLock
from .schemas import (
    EmotionCreateRequest,
    EmotionListResponse,
    EmotionProfile,
    EmotionUpdateRequest,
    ServerStatus,
    TTSRequest,
    TTSResponse,
    VoiceUploadResponse,
)
from .voice_manager import VoiceManager

logger = logging.getLogger(__name__)


def wav_bytes(wav: np.ndarray, sr: int) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def load_model(cfg: ServerConfig) -> ChatterboxTTS:
    """The configured model on the configured device: a non-empty
    ``model_dir`` loads with ``from_native`` when it holds a native
    checkpoint (``t3.jax.safetensors``) and with ``from_local`` (the
    reference checkpoint set) otherwise, as the JAX service; without one,
    seeded random weights."""
    device = resolve_device(None if cfg.device == "auto" else cfg.device)
    if cfg.model_dir:
        if (Path(cfg.model_dir) / "t3.jax.safetensors").exists():
            return ChatterboxTTS.from_native(cfg.model_dir, device=device)
        return ChatterboxTTS.from_local(cfg.model_dir, device=device)
    logger.warning("CHATTERBOX_MODEL_DIR unset: serving random-weight model (dev mode)")
    return ChatterboxTTS.from_random(device=device)


class TTSService:
    def __init__(self, cfg: ServerConfig, tts: Optional[ChatterboxTTS] = None):
        self.cfg = cfg
        if tts is None:
            tts = load_model(cfg)
        cfg.ensure_dirs()
        self.start_time = time.time()
        self.tts = tts
        self.voices = VoiceManager(
            tts, cfg.voice_storage_path, cfg.config_storage_path, cfg.cache_path
        )
        # dynamic request batching: concurrent /generate calls coalesce into
        # one generate_batch call. device_lock serializes every pipeline
        # call across the HTTP handler threads (ThreadingHTTPServer) and the
        # batcher workers. It must be FIFO-fair: with a plain RLock a busy
        # generate worker re-acquires back to back and starves stream ticks
        # (see fairlock.py).
        self.device_lock = FairRLock()
        self.batcher = DynamicBatcher(
            tts, max_batch=cfg.max_dynamic_batch, window_ms=cfg.batch_window_ms,
            device_lock=self.device_lock,
            # admission control (cfg.admission_control): while streams are
            # live, bulk batches run preemptibly so stream ticks never wait
            # behind a whole-batch dispatch
            stream_active_fn=(
                self._stream_active if cfg.admission_control else None
            ),
            bulk_chunk_tokens=cfg.bulk_chunk_tokens,
            bulk_rows_with_streams=cfg.bulk_rows_with_streams,
        )
        # concurrent /generate/stream requests coalesce into LOCKSTEP groups
        # that share each tick's batched calls
        self.stream_batcher = StreamBatcher(
            tts, max_streams=cfg.max_stream_group,
            window_ms=max(cfg.batch_window_ms, 50.0),
            device_lock=self.device_lock,
        )

    def _stream_active(self) -> bool:
        return self.stream_batcher.has_active()

    # ---------------------------------------------------------------- routes
    def health(self) -> ServerStatus:
        dev = self.tts.device
        mem = {}
        if dev.type == "cuda":
            _, total = torch.cuda.mem_get_info(dev)
            mem = {
                "bytes_in_use": torch.cuda.memory_allocated(dev),
                "bytes_reserved": torch.cuda.memory_reserved(dev),
                "bytes_limit": total,
            }
        return ServerStatus(
            status="ok",
            model_loaded=self.tts is not None,
            device=dev.type,
            emotions_ready=self.voices.get_stats()["ready"],
            uptime_seconds=time.time() - self.start_time,
            memory=mem,
            batching={**self.batcher.stats, **self.stream_batcher.stats},
        )

    def _resolve_conds(self, req: TTSRequest):
        """Returns (conds, exaggeration). A request without an explicit
        exaggeration uses the emotion profile's stored value (the point of
        exaggeration-keyed conditioning caches) or the server default."""
        if req.emotion:
            # cold-profile conditioning runs the device models -- lock it
            with self.device_lock:
                conds = self.voices.get_conditionals(req.emotion)
            if conds is None:
                raise KeyError(f"emotion profile not found or has no samples: {req.emotion}")
            if req.exaggeration is not None:
                exag = req.exaggeration
            else:
                prof = self.voices.get_profile(req.emotion)
                exag = prof.exaggeration if prof else self.cfg.default_exaggeration
            return conds, exag
        exag = req.exaggeration if req.exaggeration is not None else self.cfg.default_exaggeration
        if self.tts.conds is not None:
            return self.tts.conds, exag
        raise ValueError("no emotion specified and no default voice loaded")

    def _tier_flow_steps(self, req: TTSRequest):
        """Map the request quality tier to a per-call CFM step count (None =
        pipeline default)."""
        return self.cfg.turbo_flow_steps if req.quality == "turbo" else None

    def generate(self, req: TTSRequest) -> TTSResponse:
        conds, exaggeration = self._resolve_conds(req)

        params = dict(
            repetition_penalty=req.repetition_penalty,
            min_p=req.min_p,
            top_p=req.top_p,
            exaggeration=exaggeration,
            cfg_weight=req.cfg_weight,
            temperature=req.temperature,
            max_new_tokens=req.max_new_tokens,
            flow_steps=self._tier_flow_steps(req),
            alignment=req.alignment,
        )
        t0 = time.time()
        # seeded requests run as solo groups (the batch shares sampling
        # draws; solo keeps seed -> audio deterministic)
        wav = self.batcher.submit(
            req.text, conds, params, req.seed, timeout=self.cfg.generate_timeout_s,
        )
        gen_time = time.time() - t0
        duration = len(wav) / self.tts.sr
        resp = TTSResponse(
            sample_rate=self.tts.sr,
            duration_seconds=round(duration, 3),
            generation_time_seconds=round(gen_time, 3),
            rtf=round(gen_time / max(duration, 1e-6), 3),
            metadata={"emotion": req.emotion, "seed": req.seed,
                      "quality": req.quality},
        )
        data = wav_bytes(wav, self.tts.sr)
        if req.return_base64:
            resp.audio_base64 = base64.b64encode(data).decode()
        else:
            name = f"tts_{uuid.uuid4().hex[:10]}.wav"
            (Path(self.cfg.output_path) / name).write_bytes(data)
            resp.audio_url = f"/outputs/{name}"
        return resp

    def generate_stream(self, req: TTSRequest):
        """Yield raw 16-bit PCM chunks while synthesis continues (chunked
        HTTP streaming). The sample rate rides the X-Sample-Rate response
        header. ``alignment=True`` raises ValueError: the streaming carry
        runs no watchdog, and the flag is not dropped silently."""
        from ..pipeline.streaming import StreamConfig

        if req.alignment:
            raise ValueError("alignment is not available on /generate/stream: the streaming "
                             "decode runs no alignment watchdog; use /generate")
        conds, exaggeration = self._resolve_conds(req)

        stream = StreamConfig(
            max_new_tokens=req.max_new_tokens,
            flow_steps=self._tier_flow_steps(req),
        )
        params = dict(
            stream=stream,
            repetition_penalty=req.repetition_penalty,
            min_p=req.min_p,
            top_p=req.top_p,
            exaggeration=exaggeration,
            cfg_weight=req.cfg_weight,
            temperature=req.temperature,
        )
        # lockstep groups: N concurrent streams share batched per-tick
        # dispatches (serve/batcher.py StreamBatcher)
        for chunk in self.stream_batcher.submit(req.text, conds, params, req.seed):
            yield (np.clip(chunk, -1, 1) * 32767).astype("<i2").tobytes()

    def list_emotions(self) -> EmotionListResponse:
        """Reference /emotions shape (server.py:301-312): emotions +
        total_count + distinct characters."""
        profiles = self.voices.list_profiles()
        return EmotionListResponse(
            emotions=[p.model_dump() for p in profiles],
            total_count=len(profiles),
            characters=self.voices.list_characters(),
        )

    def create_emotion(self, req: EmotionCreateRequest) -> EmotionProfile:
        return self.voices.create_profile(EmotionProfile(**req.model_dump()))

    def get_emotion(self, emotion_id: str) -> Optional[EmotionProfile]:
        return self.voices.get_profile(emotion_id)

    def update_emotion(self, emotion_id: str, req: EmotionUpdateRequest) -> Optional[EmotionProfile]:
        return self.voices.update_profile(emotion_id, req.model_dump())

    def delete_emotion(self, emotion_id: str) -> bool:
        return self.voices.delete_profile(emotion_id)

    def upload_emotion_voice(
        self, emotion_id: str, filename: str, data: bytes, description=None
    ) -> VoiceUploadResponse:
        """Reference POST /emotions/{id}/voices (server.py:376-440)."""
        if self.voices.get_profile(emotion_id) is None:
            raise KeyError("Emotion not found")
        if not filename or not any(
            filename.lower().endswith("." + f) for f in self.cfg.allowed_audio_formats
        ):
            raise ValueError(
                f"Invalid file format. Allowed formats: {self.cfg.allowed_audio_formats}"
            )
        if len(data) > self.cfg.max_upload_mb * 1024 * 1024:
            raise ValueError(f"File too large. Maximum size: {self.cfg.max_upload_mb}MB")
        sample = self.voices.add_voice_sample(emotion_id, data, filename, description)
        return VoiceUploadResponse(
            success=True,
            message="Voice sample uploaded successfully",
            voice_id=sample["voice_id"],
            file_path=sample["file_path"],
        )

    def remove_emotion_voice(self, emotion_id: str, voice_filename: str) -> dict:
        """Reference DELETE /emotions/{id}/voices/remove (server.py:442-469)."""
        if self.voices.get_profile(emotion_id) is None:
            raise KeyError("Emotion not found")
        if not self.voices.remove_voice_sample(emotion_id, voice_filename):
            raise KeyError("Voice sample not found")
        return {"success": True, "message": "Voice sample removed successfully"}

    def test_emotion(self, emotion_id: str, text: str = "This is a test of the emotion profile.") -> TTSResponse:
        return self.generate(TTSRequest(text=text, emotion=emotion_id))

    def upload_voice(self, filename: str, data: bytes) -> dict:
        if len(data) > self.cfg.max_upload_mb * 1024 * 1024:
            raise ValueError("upload too large")
        safe = Path(filename).name
        if not safe.lower().endswith(".wav"):
            raise ValueError("only .wav uploads supported")
        (Path(self.cfg.voice_storage_path) / safe).write_bytes(data)
        return {"filename": safe, "size": len(data)}

    def list_voices(self):
        return sorted(p.name for p in Path(self.cfg.voice_storage_path).glob("*.wav"))

    def delete_voice(self, name: str) -> bool:
        p = Path(self.cfg.voice_storage_path) / Path(name).name
        if p.exists():
            p.unlink()
            return True
        return False

    def output_file(self, name: str) -> Optional[bytes]:
        p = Path(self.cfg.output_path) / Path(name).name
        return p.read_bytes() if p.exists() else None
