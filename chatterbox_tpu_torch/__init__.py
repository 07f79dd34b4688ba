"""chatterbox-tpu-torch: the PyTorch/CUDA port of chatterbox-tpu for one
NVIDIA H100.

Public API (same names as the JAX package):
  - ChatterboxTTS : text + precomputed voice conditionals -> 24 kHz waveform
  - Conditionals  : precomputed voice conditioning

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no GPU present and no device asked for they raise. The four attention
kernels of the main path are hand-written CUDA for Hopper (``csrc/``), built
with ``nvcc`` on first use.
"""

__version__ = "0.1.0"

from .constants import S3_SR, S3GEN_SR, S3_TOKEN_RATE, SPEECH_VOCAB_SIZE

__all__ = [
    "S3_SR",
    "S3GEN_SR",
    "S3_TOKEN_RATE",
    "SPEECH_VOCAB_SIZE",
    "ChatterboxTTS",
    "Conditionals",
]


def __getattr__(name):
    # lazy: `import chatterbox_tpu_torch` imports no model code and no torch
    if name == "ChatterboxTTS":
        from .pipeline import tts

        return tts.ChatterboxTTS
    if name == "Conditionals":
        from .pipeline import conditionals

        return conditionals.Conditionals
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
