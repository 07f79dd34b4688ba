"""The port's native library (``chatterbox_tpu_torch/native``), its WAV
reader with and without it, and ``EnTokenizer``'s backends, against the
JAX package's ``load_wav`` and ``EnTokenizer`` on files the tests write."""

import json
import struct

import numpy as np
import pytest

from chatterbox_tpu.models.tokenizer import EnTokenizer as JEnTokenizer
from chatterbox_tpu.pipeline.audio import load_wav as j_load_wav
from chatterbox_tpu_torch import native
from chatterbox_tpu_torch.models.tokenizer import EnTokenizer, PurePythonBPE
from chatterbox_tpu_torch.native import loader
from chatterbox_tpu_torch.pipeline import audio
from torch_reference_format import tokenizer_spec

# (format code, bits): PCM 8/16/24/32 and IEEE float32
FORMATS = [(1, 8), (1, 16), (1, 24), (1, 32), (3, 32)]


def wav_bytes(code, bits, x, sr=16000, extensible=False):
    """A RIFF/WAVE file of ``x`` (frames, channels) in [-1, 1]."""
    ch = x.shape[1]
    if code == 3:
        raw = x.astype("<f4").tobytes()
    elif bits == 8:
        raw = np.clip(np.round(x * 127 + 128), 0, 255).astype(np.uint8).tobytes()
    else:
        v = np.round(x * (2.0 ** (bits - 1) - 1)).astype(np.int64)
        raw = np.stack([(v >> (8 * i)) & 255 for i in range(bits // 8)], -1).astype(
            np.uint8).tobytes()
    align = ch * bits // 8
    if extensible:  # WAVE_FORMAT_EXTENSIBLE: the real format in the subformat GUID
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, ch, sr, sr * align, align, bits, 22, bits, 0)
        fmt += struct.pack("<H", code) + bytes.fromhex("000000001000800000aa00389b71")
    else:
        fmt = struct.pack("<HHIIHH", code, ch, sr, sr * align, align, bits)
    body = (b"WAVE" + b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"LIST"
            + struct.pack("<I", 3) + b"abc\0" + b"data" + struct.pack("<I", len(raw)) + raw)
    return b"RIFF" + struct.pack("<I", len(body)) + body


@pytest.fixture(scope="module")
def lib():
    assert native.native_available(), "g++ builds the native library here"
    assert loader.SO.exists() and loader.SO.parent.name == "build"
    return native.get_lib()


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("code,bits", FORMATS)
def test_load_wav_equals_jax_with_and_without_the_library(lib, tmp_path, monkeypatch, code,
                                                          bits, channels):
    """Bit for bit against the JAX ``load_wav`` (its native decoder), with the
    port's native decoder and with it forced off (the numpy RIFF reader; a
    float32 file is the C14 case: stdlib ``wave`` refuses format 3)."""
    rng = np.random.default_rng(bits + channels)
    x = rng.uniform(-0.9, 0.9, (1601, channels))
    path = tmp_path / f"f{code}_{bits}_{channels}.wav"
    path.write_bytes(wav_bytes(code, bits, x))
    want = j_load_wav(path)
    got = audio.load_wav(path)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    monkeypatch.setattr(audio, "wav_decode", lambda data: None)
    assert np.array_equal(audio.load_wav(path), want)


def test_extensible_header_and_resampling(lib, tmp_path, monkeypatch):
    """A WAVE_FORMAT_EXTENSIBLE file, which the native decoder refuses, reads
    as its subformat; resampling on load is the port's resampler."""
    rng = np.random.default_rng(0)
    x = rng.uniform(-0.9, 0.9, (2400, 2))
    plain, ext = tmp_path / "plain.wav", tmp_path / "ext.wav"
    plain.write_bytes(wav_bytes(3, 32, x, sr=24000))
    ext.write_bytes(wav_bytes(3, 32, x, sr=24000, extensible=True))
    assert native.wav_decode(ext.read_bytes()) is None
    assert np.array_equal(audio.load_wav(ext), audio.load_wav(plain))
    got = audio.load_wav(plain, 16000)
    np.testing.assert_allclose(got, j_load_wav(plain, 16000), atol=1e-5)
    with pytest.raises(ValueError):
        audio.read_riff(b"RIFF\0\0\0\0WAVEdata\0\0\0\0")


def test_wav_encode_round_trip(lib, tmp_path):
    x = np.random.default_rng(1).uniform(-1, 1, 999).astype(np.float32)
    data = native.wav_encode_pcm16(x, 24000)
    got, sr = audio.read_riff(data)
    assert sr == 24000
    np.testing.assert_allclose(got, np.round(x * 32767) / 32768, atol=1 / 32768)


@pytest.fixture(scope="module")
def tokenizer_json(tmp_path_factory):
    path = tmp_path_factory.mktemp("tok") / "tokenizer.json"
    path.write_text(json.dumps(tokenizer_spec(seed=3)))
    return path


TEXTS = ["Hello world, this is a test.", "the quick brown fox jumps", "a", "",
         "Zebras? 42 quizzical jackdaws!", "[START]x[STOP] y"]


def test_bpe_ids_equal_pure_python_and_jax(lib, tokenizer_json):
    spec = json.loads(tokenizer_json.read_text())
    nat, py = native.NativeBPE(spec), PurePythonBPE(spec)
    jax_tok = JEnTokenizer(str(tokenizer_json))
    tok = EnTokenizer(str(tokenizer_json))
    assert tok.backend == "native"
    for text in TEXTS:
        assert nat.encode(text) == py.encode(text), text
        assert tok.encode(text) == jax_tok.encode(text), text
        assert tok.decode(tok.encode(text)) == jax_tok.decode(jax_tok.encode(text)), text


def test_backend_argument(lib, tokenizer_json, monkeypatch):
    """``auto`` takes the native BPE; ``python`` the pure one; ``native``
    raises without the library, where ``auto`` falls back (with a warning);
    ``hf`` is the ``tokenizers`` package and raises where it is absent."""
    path = str(tokenizer_json)
    assert EnTokenizer(path, backend="python").backend == "python"
    assert EnTokenizer(path, backend="native").backend == "native"
    with pytest.raises(ValueError):
        EnTokenizer(path, backend="rust")
    try:
        import tokenizers  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            EnTokenizer(path, backend="hf")
    else:
        hf = EnTokenizer(path, backend="hf")
        assert hf.backend == "hf" and hf.encode(TEXTS[0]) == JEnTokenizer(path).encode(TEXTS[0])
    monkeypatch.setattr(loader, "get_lib", lambda: None)
    with pytest.raises(RuntimeError):
        EnTokenizer(path, backend="native")
    monkeypatch.setitem(__import__("sys").modules, "tokenizers", None)
    auto = EnTokenizer(path)
    assert auto.backend == "python" and auto.encode(TEXTS[0]) == JEnTokenizer(path).encode(TEXTS[0])


def test_build_goes_to_the_ports_build_directory(lib):
    assert loader.SRC.parent.name == "native" and loader.SRC.parent.parent.name == (
        "chatterbox_tpu_torch")
    assert loader.SO.parent == loader.SRC.parent.parent / "build"
    x = np.linspace(-10, 10, 101, dtype=np.float32)
    np.testing.assert_allclose(native.sinf(x), np.sin(x.astype(np.float64)), atol=1e-6)
