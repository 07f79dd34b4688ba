"""Host-side audio I/O: WAV read and write, resampling, and silence
trimming.

Port of ``chatterbox_tpu/pipeline/audio.py``. ``load_wav`` decodes with the
native library (``chatterbox_tpu_torch/native``) first, as the JAX package
does, and otherwise reads the RIFF chunks itself in numpy, with the same
formats and arithmetic, so a machine without g++ loses no format.
Resampling runs the port's windowed-sinc ``resample`` on the CPU.
"""

import struct
import wave

import numpy as np
import torch

from ..core.resample import resample
from ..native import wav_decode

_PCM, _FLOAT, _EXTENSIBLE = 1, 3, 0xFFFE


def _pcm_to_float(raw: bytes, fmt: int, bits: int) -> np.ndarray:
    """Interleaved samples -> float64 in [-1, 1] (the native decoder's
    arithmetic: PCM over 2^(bits - 1), 8-bit offset by 128)."""
    if fmt == _FLOAT and bits == 32:
        return np.frombuffer(raw, "<f4").astype(np.float64)
    if fmt != _PCM:
        raise ValueError(f"unsupported WAV format {fmt} ({bits} bits)")
    if bits == 8:
        return (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) / 128.0
    if bits == 16:
        return np.frombuffer(raw, "<i2") / 32768.0
    if bits == 24:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        return (((b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)) << 8) >> 8) / 8388608.0
    if bits == 32:
        return np.frombuffer(raw, "<i4") / 2147483648.0
    raise ValueError(f"unsupported PCM sample width of {bits} bits")


def read_riff(data: bytes):
    """RIFF/WAVE bytes -> (float32 mono, sample rate): PCM of 8, 16, 24 or
    32 bits and 32-bit float (formats 1 and 3, also inside a
    ``WAVE_FORMAT_EXTENSIBLE`` header), channels averaged in float64 as the
    native decoder averages them. Raises ValueError on anything else."""
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")
    pos, fmt, pcm = 12, None, None
    while pos + 8 <= len(data):
        tag, size = data[pos:pos + 4], struct.unpack_from("<I", data, pos + 4)[0]
        body = data[pos + 8:min(pos + 8 + size, len(data))]
        if tag == b"fmt " and len(body) >= 16:
            fmt = struct.unpack_from("<HHIIHH", body)
            if fmt[0] == _EXTENSIBLE and len(body) >= 26:  # the subformat GUID's first field
                fmt = (struct.unpack_from("<H", body, 24)[0],) + fmt[1:]
        elif tag == b"data":
            pcm = body
        pos += 8 + size + (size & 1)
    if fmt is None or pcm is None:
        raise ValueError("WAV file without a fmt or data chunk")
    code, channels, sr, _, _, bits = fmt
    if channels < 1 or bits < 8:
        raise ValueError(f"WAV file with {channels} channels of {bits} bits")
    frame = channels * (bits // 8)
    x = _pcm_to_float(pcm[: len(pcm) // frame * frame], code, bits)
    return x.reshape(-1, channels).mean(axis=1).astype(np.float32), sr


def load_wav(path, target_sr: int = None) -> np.ndarray:
    """A WAV file -> float32 mono in [-1, 1], resampled to ``target_sr``
    when given: the native decoder when the library is there and takes the
    file, else ``read_riff``."""
    with open(path, "rb") as f:
        data = f.read()
    res = wav_decode(data)
    x, sr = res if res is not None else read_riff(data)
    if target_sr is not None and sr != target_sr:
        x = resample(torch.from_numpy(x), sr, target_sr).numpy()
    return x.astype(np.float32)


def save_wav(path, wav: np.ndarray, sr: int):
    """Write a mono 16-bit PCM WAV (samples clipped to [-1, 1])."""
    wav = np.asarray(wav).reshape(-1)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())


def trim_silence(wav: np.ndarray, top_db: float = 20.0, frame_length: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """librosa.effects.trim: drop the leading and trailing frames more than
    ``top_db`` below the loudest frame's RMS."""
    if len(wav) < frame_length:
        return wav
    pad = frame_length // 2
    xp = np.pad(wav, (pad, pad), mode="constant")
    n_frames = 1 + (len(xp) - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(xp[idx] ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return wav
    start = max(0, keep[0] * hop - pad)
    end = min(len(wav), keep[-1] * hop + frame_length - pad)
    return wav[start:end]


def synthetic_voice(seed: int, seconds: float, sr: int) -> np.ndarray:
    """A seeded stand-in for recorded speech, where none is at hand: a
    voiced harmonic signal (a gliding 90-250 Hz pitch, 12 harmonics falling
    off as 1/k), syllable-rate amplitude bursts, a little noise, and 0.2 s
    of near-silence at each end. float32 in [-1, 1]."""
    rng = np.random.default_rng(seed)
    n = int(seconds * sr)
    t = np.arange(n) / sr
    f0 = 90.0 + 160.0 * rng.random() + 30.0 * np.sin(2 * np.pi * (0.3 + rng.random()) * t)
    phase = 2 * np.pi * np.cumsum(f0) / sr
    voiced = sum(np.sin(k * phase + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 13))
    syllables = 0.5 + 0.5 * np.sin(2 * np.pi * (3.0 + 2.0 * rng.random()) * t) ** 2
    edge = np.clip(np.minimum(t, seconds - t) / 0.2, 0.0, 1.0) ** 4
    x = 0.25 * voiced * syllables * edge + 0.003 * rng.standard_normal(n)
    return np.clip(x, -1.0, 1.0).astype(np.float32)
