"""ctypes bindings of the host-side C++ library (``chatterbox_native.cpp``
beside this file).

Port of ``chatterbox_tpu/native/loader.py``. The library is built on first
use with ``g++ -O2 -std=c++17 -shared -fPIC`` into
``chatterbox_tpu_torch/build/`` (rebuilt when the source is newer), written
under a temporary name and renamed, so that processes starting together do
not load a half-written file. Every function has a Python fallback: when
g++ or the build is missing, ``get_lib()`` returns None, a warning names
the fallback once, and ``wav_decode``/``wav_encode_pcm16``/``sinf`` return
None. This is host code, not a device kernel.
"""

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "chatterbox_native.cpp"
SO = Path(__file__).resolve().parent.parent / "build" / "libchatterbox_native.so"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")

_lib = None
_tried = False
_lock = threading.Lock()


def _build() -> bool:
    SO.parent.mkdir(parents=True, exist_ok=True)
    tmp = SO.with_name(f"{SO.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, SO)
        return True
    except Exception as e:  # no g++, or it failed: the Python paths run
        logger.warning("native library build failed (%s): the pure-Python WAV codec and BPE "
                       "run instead", e)
        tmp.unlink(missing_ok=True)
        return False


def _bind(lib):
    c = ctypes
    lib.cbx_wav_decode.restype = c.c_int
    lib.cbx_wav_decode.argtypes = [c.c_char_p, c.c_size_t, c.POINTER(c.POINTER(c.c_float)),
                                   c.POINTER(c.c_int32), c.POINTER(c.c_size_t)]
    lib.cbx_wav_encode_pcm16.restype = c.c_int
    lib.cbx_wav_encode_pcm16.argtypes = [c.POINTER(c.c_float), c.c_size_t, c.c_int32,
                                         c.POINTER(c.POINTER(c.c_uint8)), c.POINTER(c.c_size_t)]
    lib.cbx_bpe_create.restype = c.c_void_p
    lib.cbx_bpe_create.argtypes = [c.c_char_p, c.POINTER(c.c_int32), c.c_int32, c.c_char_p,
                                   c.c_int32, c.c_char_p, c.c_int32, c.c_int32]
    lib.cbx_bpe_destroy.argtypes = [c.c_void_p]
    lib.cbx_bpe_encode.restype = c.c_int32
    lib.cbx_bpe_encode.argtypes = [c.c_void_p, c.c_char_p, c.POINTER(c.c_int32), c.c_int32]
    lib.cbx_sinf.restype = None
    lib.cbx_sinf.argtypes = [c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_size_t]
    lib.cbx_free.argtypes = [c.c_void_p]


def get_lib():
    """The loaded library, built first if needed; None when it cannot be
    built or loaded (tried once a process)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not SO.exists() or SO.stat().st_mtime < SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(SO))
            _bind(lib)
        except (OSError, AttributeError) as e:
            logger.warning("native library load failed (%s): the pure-Python WAV codec and BPE "
                           "run instead", e)
            return None
        _lib = lib
        return _lib


def native_available() -> bool:
    return get_lib() is not None


def wav_decode(data: bytes):
    """RIFF/WAVE bytes (PCM 8/16/24/32 or float32) -> (float32 mono array,
    sample rate), or None without the library or on a file it rejects."""
    lib = get_lib()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_float)()
    sr, n = ctypes.c_int32(), ctypes.c_size_t()
    if lib.cbx_wav_decode(data, len(data), ctypes.byref(out), ctypes.byref(sr),
                          ctypes.byref(n)) != 0:
        return None
    arr = np.ctypeslib.as_array(out, shape=(n.value,)).copy() if n.value else np.zeros(0, np.float32)
    lib.cbx_free(out)
    return arr, sr.value


def wav_encode_pcm16(x: np.ndarray, sr: int):
    """Mono float32 -> the bytes of a 16-bit PCM WAV, or None without the
    library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = ctypes.c_size_t()
    if lib.cbx_wav_encode_pcm16(x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(x), sr,
                                ctypes.byref(out), ctypes.byref(n)) != 0:
        return None
    data = bytes(np.ctypeslib.as_array(out, shape=(n.value,)))
    lib.cbx_free(out)
    return data


def sinf(x: np.ndarray):
    """libm's fp32 sine of each element (float32 array), or None without
    the library."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.empty_like(x)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.cbx_sinf(x.ctypes.data_as(fp), y.ctypes.data_as(fp), x.size)
    return y


class NativeBPE:
    """The C++ greedy-merge BPE over a parsed tokenizer.json spec."""

    def __init__(self, spec: dict):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        model = spec["model"]
        vocab = model["vocab"]
        tokens = list(vocab.keys())
        ids = np.asarray([vocab[t] for t in tokens], np.int32)
        merges = model.get("merges", [])
        merge_lines = "\n".join(m if isinstance(m, str) else " ".join(m) for m in merges)
        specials = [t["content"] for t in spec.get("added_tokens", [])]
        self._h = lib.cbx_bpe_create(
            "\n".join(tokens).encode("utf-8"), ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            len(tokens), merge_lines.encode("utf-8"), len(merges),
            "\n".join(specials).encode("utf-8"), len(specials), vocab.get("[UNK]", -1))

    def encode(self, text: str):
        raw = text.encode("utf-8")
        buf = (ctypes.c_int32 * 4096)()
        n = self._lib.cbx_bpe_encode(self._h, raw, buf, 4096)
        if n > 4096:
            buf = (ctypes.c_int32 * n)()
            n = self._lib.cbx_bpe_encode(self._h, raw, buf, n)
        return [int(buf[i]) for i in range(n)]

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.cbx_bpe_destroy(h)
