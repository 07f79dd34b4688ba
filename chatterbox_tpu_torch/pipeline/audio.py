"""Host-side audio I/O: WAV read and write with the stdlib ``wave`` module,
resampling, and silence trimming.

Port of ``chatterbox_tpu/pipeline/audio.py`` (its stdlib fallback: the port
never uses the JAX package's C++ decoder). Resampling runs the port's
windowed-sinc ``resample`` on the CPU.
"""

import wave

import numpy as np
import torch

from ..core.resample import resample


def load_wav(path, target_sr: int = None) -> np.ndarray:
    """A PCM WAV file (8, 16, 24 or 32 bits; channels averaged) -> float32
    mono in [-1, 1], resampled to ``target_sr`` when given."""
    with wave.open(str(path), "rb") as f:
        sr, ch, width = f.getframerate(), f.getnchannels(), f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 3:
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3).astype(np.int32)
        x = (((b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16)) << 8) >> 8).astype(np.float32)
        x = x / 8388608.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
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
