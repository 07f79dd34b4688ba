"""Server configuration from ``CHATTERBOX_*`` environment variables: the
JAX package's ``serve/config.py`` surface, as a dataclass of the port's
``schemas.Schema`` (no pydantic).

``device`` is ``auto`` (the card; without a GPU the service raises, it
never falls back to the CPU), ``cuda`` or ``cpu``. ``tpu`` is refused: the
port runs on NVIDIA GPUs.
"""

import os
from dataclasses import dataclass, fields
from pathlib import Path

from .schemas import F, Schema, ValidationError


@dataclass
class ServerConfig(Schema):
    host: str = "0.0.0.0"
    port: int = F(8000, ge=0, le=65535)  # 0: an ephemeral port
    device: str = "auto"  # auto (the card) | cuda | cpu
    model_dir: str = ""  # a native or reference checkpoint set; empty: random weights (dev)
    voice_storage_path: str = "storage/voices"
    config_storage_path: str = "storage/configs"
    cache_path: str = "storage/cache"
    output_path: str = "storage/outputs"
    max_upload_mb: int = 50
    allowed_audio_formats: tuple = ("wav", "mp3", "flac", "ogg")
    default_exaggeration: float = 0.5
    # dynamic request batching (serve/batcher.py): concurrent /generate
    # requests within the window coalesce into one batched call; at 0 a
    # request waits for no companion
    batch_window_ms: float = F(25.0, ge=0.0)
    max_dynamic_batch: int = 16
    # the most /generate/stream rows of one lockstep group
    max_stream_group: int = 8
    generate_timeout_s: float = 300.0
    # the CFM Euler step count of the "turbo" quality tier
    turbo_flow_steps: int = 4
    # mixed-load admission control (serve/batcher.py): while streams are
    # live, bulk /generate work runs preemptibly -- T3 in bulk_chunk_tokens
    # chunks and S3Gen in groups of at most bulk_rows_with_streams rows, the
    # device lock released between them, so that stream ticks interleave
    admission_control: bool = True
    bulk_chunk_tokens: int = 25
    bulk_rows_with_streams: int = 2

    def __post_init__(self):
        super().__post_init__()
        if self.device not in ("auto", "cuda", "cpu"):
            raise ValidationError([{
                "loc": ["device"], "input": self.device,
                "msg": "must be auto, cuda or cpu (the port runs on NVIDIA GPUs, not TPUs)"}])

    @classmethod
    def from_env(cls) -> "ServerConfig":
        prefix = "CHATTERBOX_"
        kwargs = {}
        for f in fields(cls):
            env = os.environ.get(prefix + f.name.upper())
            if env is not None:
                kwargs[f.name] = env
        return cls(**kwargs)

    def ensure_dirs(self):
        for p in [self.voice_storage_path, self.config_storage_path, self.cache_path,
                  self.output_path]:
            Path(p).mkdir(parents=True, exist_ok=True)


_config = None


def get_config() -> ServerConfig:
    global _config
    if _config is None:
        _config = ServerConfig.from_env()
    return _config
