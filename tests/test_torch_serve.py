"""The port's serving layer (``chatterbox_tpu_torch/serve``) on the CPU, over
a tiny random-weight model: the FIFO-fair device lock, the schemas without
pydantic, the dynamic batcher with admission control,
``generate_batch_preemptible`` against ``generate_batch``, and REST round
trips against the stdlib server bound to an ephemeral port (the JAX
package's ``test_server.py`` holds port 18751, and xdist runs both files at
once)."""

import base64
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from chatterbox_tpu_torch.models.s3gen.conformer import ConformerConfig
from chatterbox_tpu_torch.models.s3gen.flow import FlowConfig
from chatterbox_tpu_torch.models.s3gen.hifigan import HiFTConfig
from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict, S3GenConfig
from chatterbox_tpu_torch.models.s3gen.unet import UNetConfig
from chatterbox_tpu_torch.models.s3gen.xvector import CAMPPlusConfig
from chatterbox_tpu_torch.models.s3tokenizer import S3TokenizerConfig
from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
from chatterbox_tpu_torch.models.t3.t3 import T3Config
from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig
from chatterbox_tpu_torch.pipeline.audio import save_wav, synthetic_voice
from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData
from chatterbox_tpu_torch.serve.batcher import DynamicBatcher
from chatterbox_tpu_torch.serve.config import ServerConfig
from chatterbox_tpu_torch.serve.fairlock import FairRLock
from chatterbox_tpu_torch.serve.schemas import (EmotionCreateRequest, EmotionProfile,
                                                EmotionUpdateRequest, TTSRequest,
                                                ValidationError)

torch.set_num_threads(1)  # one of the tier-1 run's 6 workers (see torch_parity)

TINY_T3 = T3Config(llama=LlamaConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=1,
                                     num_attention_heads=2, num_key_value_heads=2, head_dim=16),
                   alignment_layer=0)
TINY_S3GEN = S3GenConfig(
    flow=FlowConfig(input_size=64, encoder=ConformerConfig(
        input_size=64, output_size=64, attention_heads=2, linear_units=64, num_blocks=1,
        num_up_blocks=1), estimator=UNetConfig(channels=32, n_blocks=1, num_mid_blocks=1,
                                               num_heads=2), n_timesteps=2),
    hift=HiFTConfig(base_channels=32, f0_cond_channels=32),
    campplus=CAMPPlusConfig(growth_rate=8, bn_size=2, init_channels=16, m_channels=8,
                            block_layers=(1, 1, 1)),
    tokenizer=S3TokenizerConfig(n_state=32, n_head=2, n_layer=1))
PARAMS = dict(max_new_tokens=16, repetition_penalty=1.2, min_p=0.05, top_p=1.0,
              exaggeration=0.5, cfg_weight=0.5, temperature=0.8)


def _tiny_tts():
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS

    return ChatterboxTTS.from_random(seed=0, t3_cfg=TINY_T3, s3gen_cfg=TINY_S3GEN, device="cpu",
                                     ve_cfg=VoiceEncoderConfig(hidden_size=16, num_layers=1))


def _conds(seed: int, p_len: int = 25) -> Conditionals:
    rng = np.random.default_rng(seed)
    f = torch.from_numpy
    return Conditionals(
        T3CondData(f(rng.standard_normal((1, 256)).astype(np.float32)),
                   f(rng.integers(0, 6561, (1, 150)).astype(np.int32)), torch.full((1,), 0.5)),
        RefDict(f(rng.integers(0, 6561, (1, p_len)).astype(np.int32)),
                torch.full((1,), p_len, dtype=torch.int32),
                f(rng.standard_normal((1, 2 * p_len, 80)).astype(np.float32)),
                f(rng.standard_normal((1, 192)).astype(np.float32))))


@pytest.fixture(scope="module")
def tts():
    return _tiny_tts()


# ---------------------------------------------------------------------------
# FairRLock (the JAX package's test_fairlock.py cases)
# ---------------------------------------------------------------------------


def test_fairlock_reentrant():
    lk = FairRLock()
    with lk:
        with lk:
            assert lk.acquire()
            lk.release()
    got = []
    t = threading.Thread(target=lambda: (lk.acquire(), got.append(1), lk.release()))
    t.start()
    t.join(timeout=5)
    assert got == [1]


def test_fairlock_nonblocking_and_timeout():
    lk = FairRLock()
    lk.acquire()
    res = []
    t = threading.Thread(target=lambda: res.append(lk.acquire(blocking=False)))
    t.start()
    t.join(5)
    assert res == [False]
    t = threading.Thread(target=lambda: res.append(lk.acquire(timeout=0.05)))
    t.start()
    t.join(5)
    assert res == [False, False]
    lk.release()
    with pytest.raises(RuntimeError):
        lk.release()


def test_fairlock_fifo_handoff_beats_hog():
    """A release-then-reacquire loop must not starve a waiter: the waiter
    gets the lock within a few of the hog's cycles."""
    lk = FairRLock()
    acquired_by_waiter, stop, waiting = threading.Event(), threading.Event(), threading.Event()
    cycles_after_wait = [0]

    def hog():
        while not stop.is_set():
            with lk:
                time.sleep(0.002)
            if waiting.is_set() and not acquired_by_waiter.is_set():
                cycles_after_wait[0] += 1

    def waiter():
        time.sleep(0.05)
        waiting.set()
        with lk:
            acquired_by_waiter.set()

    th, tw = threading.Thread(target=hog), threading.Thread(target=waiter)
    th.start()
    tw.start()
    ok = acquired_by_waiter.wait(timeout=5.0)
    stop.set()
    th.join(5)
    tw.join(5)
    assert ok, "waiter starved behind the re-acquiring hog"
    assert cycles_after_wait[0] <= 3, cycles_after_wait


def test_fairlock_fifo_order():
    lk = FairRLock()
    lk.acquire()
    order, threads = [], []

    def w(i):
        with lk:
            order.append(i)
            time.sleep(0.01)

    for i in range(4):
        t = threading.Thread(target=w, args=(i,))
        t.start()
        time.sleep(0.05)
        threads.append(t)
    lk.release()
    for t in threads:
        t.join(5)
    assert order == [0, 1, 2, 3], order


def test_fairlock_mutual_exclusion_under_stress():
    """16 threads (more than the cores of a test worker) take the lock 200
    times each, with a short switch interval, and do a read-modify-write
    under it: no update is lost, and nested acquisitions stay reentrant."""
    import sys

    lk, box = FairRLock(), {"n": 0}

    def work():
        for _ in range(200):
            with lk:
                with lk:
                    n = box["n"]
                    time.sleep(0)
                    box["n"] = n + 1

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(saved)
    assert not any(t.is_alive() for t in threads)
    assert box["n"] == 16 * 200


# ---------------------------------------------------------------------------
# schemas and config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("field,bad,good", [
    ("text", "", "x"), ("text", "x" * 5001, "x" * 5000), ("cfg_weight", 1.5, 1.0),
    ("cfg_weight", -0.1, 0.0), ("temperature", 0.05, 0.1), ("temperature", 2.5, 2.0),
    ("repetition_penalty", 0.9, 3.0), ("min_p", 1.1, 1.0), ("top_p", -0.5, 0.5),
    ("exaggeration", 2.1, 2.0), ("max_new_tokens", 0, 1), ("max_new_tokens", 1001, 1000),
    ("quality", "fast", "turbo"), ("seed", "abc", 7), ("alignment", "maybe", "true"),
])
def test_tts_request_ranges(field, bad, good):
    """The JAX package's ranges, value by value: its pydantic model refuses
    and takes the same values as the port's."""
    from pydantic import ValidationError as PydanticError

    from chatterbox_tpu.serve.schemas import TTSRequest as JaxTTSRequest

    base = {"text": "Hello."}
    with pytest.raises(ValidationError) as e:
        TTSRequest.parse({**base, field: bad})
    assert e.value.errors()[0]["loc"] == [field] and isinstance(e.value, ValueError)
    with pytest.raises(PydanticError):
        JaxTTSRequest(**{**base, field: bad})
    req = TTSRequest.parse({**base, field: good})
    assert getattr(req, field) == getattr(JaxTTSRequest(**{**base, field: good}), field)


def test_schemas_defaults_parse_and_dump():
    req = TTSRequest.parse({"text": "Hi.", "unknown_key": 1, "seed": "12"})
    assert req.seed == 12 and req.cfg_weight == 0.5 and req.quality == "default"
    assert req.model_dump()["max_new_tokens"] == 1000 and not req.alignment
    with pytest.raises(ValidationError, match="field required"):
        TTSRequest.parse({"cfg_weight": 0.5})
    with pytest.raises(ValidationError):
        TTSRequest.parse(["not", "an", "object"])
    prof = EmotionProfile(**EmotionCreateRequest.parse({"id": "a", "exaggeration": 0.3})
                          .model_dump())
    assert prof.voice_samples == [] and prof.created_at > 0
    dumped = prof.model_dump()
    dumped["voice_samples"].append("x.wav")  # a copy, not the profile's list
    assert prof.voice_samples == []
    assert prof.model_copy(update={"name": "n"}).name == "n"
    with pytest.raises(ValidationError):
        EmotionCreateRequest.parse({"id": "a", "exaggeration": 1.5})
    with pytest.raises(ValidationError):
        EmotionUpdateRequest.parse({"name": ""})
    assert EmotionUpdateRequest.parse({}).model_dump() == {
        "name": None, "character": None, "exaggeration": None, "description": None}


def test_server_config_device_and_env(monkeypatch):
    assert ServerConfig().device == "auto"
    assert ServerConfig(device="cuda").device == "cuda"
    with pytest.raises(ValidationError, match="NVIDIA"):
        ServerConfig(device="tpu")
    monkeypatch.setenv("CHATTERBOX_PORT", "9123")
    monkeypatch.setenv("CHATTERBOX_ADMISSION_CONTROL", "0")
    monkeypatch.setenv("CHATTERBOX_BATCH_WINDOW_MS", "12.5")
    monkeypatch.setenv("CHATTERBOX_ALLOWED_AUDIO_FORMATS", "wav,flac")
    cfg = ServerConfig.from_env()
    assert (cfg.port, cfg.admission_control, cfg.batch_window_ms) == (9123, False, 12.5)
    assert cfg.allowed_audio_formats == ("wav", "flac")
    monkeypatch.setenv("CHATTERBOX_DEVICE", "tpu")
    with pytest.raises(ValidationError):
        ServerConfig.from_env()


def test_service_model_dir(tmp_path, monkeypatch):
    """A native checkpoint directory loads through ``from_native`` and any
    other directory (the reference checkpoint set) through ``from_local``,
    as the JAX service does, each on the configured device."""
    from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS
    from chatterbox_tpu_torch.serve import service

    calls = []
    for name in ("from_native", "from_local"):
        monkeypatch.setattr(ChatterboxTTS, name, classmethod(
            lambda cls, d, device=None, name=name: calls.append((name, d, device))))
    ref_dir = tmp_path / "reference"
    ref_dir.mkdir()
    (ref_dir / "t3_cfg.safetensors").write_bytes(b"")
    service.load_model(ServerConfig(model_dir=str(ref_dir), device="cpu"))
    native = tmp_path / "native"
    native.mkdir()
    (native / "t3.jax.safetensors").write_bytes(b"")
    service.load_model(ServerConfig(model_dir=str(native), device="cpu"))
    assert calls == [("from_local", str(ref_dir), torch.device("cpu")),
                     ("from_native", str(native), torch.device("cpu"))]


# ---------------------------------------------------------------------------
# generate_batch_preemptible and the batcher
# ---------------------------------------------------------------------------


def test_preemptible_matches_one_shot(tts):
    """Chunked T3 (chunks of 5, crossing the done checks) and one S3Gen
    group: bit for bit ``generate_batch``'s wavs for the same seed."""
    conds = Conditionals.stack([_conds(30), _conds(31)])
    texts = ["preemptible check", "a second, longer preemptible row"]
    direct = tts.generate_batch(texts, conds=conds, seed=44, **PARAMS)
    chunked = tts.generate_batch_preemptible(texts, conds=conds, seed=44, t3_chunk_tokens=5,
                                             **PARAMS)
    assert len(chunked) == 2
    for g, w in zip(chunked, direct):
        np.testing.assert_array_equal(g, w)


def test_preemptible_splits_above_the_cap(tts):
    """Three texts over a one-shot cap of 2: chunks of 2 and 1, chunk j
    seeded ``seed + j``, each equal to a direct call on its rows."""
    stack = Conditionals.stack([_conds(20 + i) for i in range(3)])
    texts = [f"split row {i}" for i in range(3)]
    saved = tts.max_device_batch
    try:
        tts.max_device_batch = 2
        got = tts.generate_batch_preemptible(texts, conds=stack, seed=5, t3_chunk_tokens=7,
                                             **PARAMS)
        direct = (tts.generate_batch(texts[:2], conds=stack.rows(0, 2), seed=5, **PARAMS)
                  + tts.generate_batch(texts[2:], conds=stack.rows(2, 3), seed=6, **PARAMS))
    finally:
        tts.max_device_batch = saved
    assert len(got) == 3
    for g, w in zip(got, direct):
        np.testing.assert_array_equal(g, w)


def test_preemptible_row_split_lock_and_alignment(tts):
    """S3Gen split into one-row groups: valid audio a row, and the lock
    taken once a piece (the prefill, every T3 chunk, every S3Gen group).
    ``alignment=True`` runs the whole-batch call under the lock once."""
    acquires = []

    class CountingLock:
        def __enter__(self):
            acquires.append(1)

        def __exit__(self, *a):
            return False

    stack = Conditionals.stack([_conds(31), _conds(32)])
    wavs = tts.generate_batch_preemptible(["row one text", "row two text"], conds=stack,
                                          lock=CountingLock(), seed=2, t3_chunk_tokens=4,
                                          s3gen_max_rows=1, **PARAMS)
    assert len(wavs) == 2 and all(len(w) > 0 and np.isfinite(w).all() for w in wavs)
    assert len(acquires) >= 1 + 16 // 4 + 2, acquires  # prefill + chunks + rows
    acquires.clear()
    wavs = tts.generate_batch_preemptible(["aligned"], conds=_conds(33), lock=CountingLock(),
                                          seed=2, alignment=True, **PARAMS)
    assert len(acquires) == 1 and len(wavs) == 1
    assert tts.last_timings["alignment"] is True


def test_batcher_coalesces_concurrent_requests(tts):
    batcher = DynamicBatcher(tts, max_batch=8, window_ms=200.0)
    try:
        c1, c2 = _conds(1), _conds(2)  # two voices in one batch
        results, errs = [None] * 4, []

        def worker(i, conds):
            try:
                results[i] = batcher.submit(f"request number {i}", conds, PARAMS, None)
            except BaseException as e:  # pragma: no cover
                errs.append(e)

        threads = [threading.Thread(target=worker, args=(i, c1 if i % 2 == 0 else c2))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not errs
        assert all(r is not None and np.isfinite(r).all() and len(r) > 0 for r in results)
        assert batcher.stats["max_batch_seen"] >= 2 and batcher.stats["batches"] < 4
        assert batcher.stats["requests"] == 4
    finally:
        batcher.shutdown()


def test_batcher_seeded_request_matches_direct_call(tts):
    conds = _conds(3)
    direct = tts.generate_batch(["determinism check"], conds=conds, seed=123, **PARAMS)[0]
    batcher = DynamicBatcher(tts, max_batch=8, window_ms=50.0)
    try:
        np.testing.assert_array_equal(batcher.submit("determinism check", conds, PARAMS, 123),
                                      direct)
        other = threading.Thread(
            target=lambda: batcher.submit("background noise", _conds(4), PARAMS, None))
        other.start()
        got = batcher.submit("determinism check", conds, PARAMS, 123)
        other.join(timeout=300)
        np.testing.assert_array_equal(got, direct)
    finally:
        batcher.shutdown()


def test_batcher_error_reaches_the_caller(tts):
    batcher = DynamicBatcher(tts, max_batch=4, window_ms=10.0)
    try:
        with pytest.raises(TypeError):
            batcher.submit("boom", _conds(5), dict(PARAMS, nonexistent_kwarg=1), None)
        ok = batcher.submit("recovery", _conds(6), PARAMS, None)  # the worker survived
        assert np.isfinite(ok).all() and len(ok) > 0
    finally:
        batcher.shutdown()


@pytest.mark.parametrize("streams_live", [True, False])
def test_batcher_admission_control(tts, streams_live):
    """With live streams reported, bulk groups go through
    ``generate_batch_preemptible``, and a seeded request still equals the
    direct call; with none, through ``generate_batch``."""
    conds = _conds(33)
    direct = tts.generate_batch(["admission check"], conds=conds, seed=77, **PARAMS)[0]
    batcher = DynamicBatcher(tts, max_batch=8, window_ms=10.0,
                             stream_active_fn=lambda: streams_live, bulk_chunk_tokens=5,
                             bulk_rows_with_streams=1)
    try:
        np.testing.assert_array_equal(batcher.submit("admission check", conds, PARAMS, 77),
                                      direct)
        assert batcher.stats["preempted_batches"] == (1 if streams_live else 0)
    finally:
        batcher.shutdown()


def test_hift_bf16_env_runs_the_vocoder_trunk_in_bf16(monkeypatch):
    """``CHATTERBOX_HIFT_BF16=1`` (read at construction) asks the vocoder
    for its bf16 trunk on the batch path and on the streaming tick; unset,
    the fp32 one. Both give finite whole-token audio."""
    from chatterbox_tpu_torch.models.s3gen import s3gen
    from chatterbox_tpu_torch.pipeline import streaming

    for flag, want in (("1", torch.bfloat16), (None, None)):
        if flag is None:
            monkeypatch.delenv("CHATTERBOX_HIFT_BF16", raising=False)
        else:
            monkeypatch.setenv("CHATTERBOX_HIFT_BF16", flag)
        tts = _tiny_tts()
        assert tts.hift_bf16 is (flag == "1")
        seen = []
        for mod in (s3gen, streaming):
            real = mod.hift_generate
            monkeypatch.setattr(mod, "hift_generate",
                                lambda *a, _real=real, **kw: seen.append(kw["compute_dtype"])
                                or _real(*a, **kw))
        wav = tts.generate_batch(["Trunk dtype."], conds=_conds(50), seed=1, **PARAMS)[0]
        chunks = list(streaming.stream_generate(
            tts, "Trunk dtype.", conds=_conds(50), min_new_tokens=7,
            stream=streaming.StreamConfig(chunk_tokens=4, first_chunk_tokens=0, max_new_tokens=8)))
        assert seen == [want] * (1 + len(chunks)) and len(chunks) == 2
        for w in [wav] + chunks:
            assert len(w) > 0 and len(w) % 960 == 0 and np.isfinite(w).all()
        monkeypatch.undo()


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------


def _req(port, path, method="GET", body=None):
    data = json.dumps(body).encode() if isinstance(body, (dict, list)) else body
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method)
    if isinstance(body, (dict, list)):
        r.add_header("Content-Type", "application/json")
    with urllib.request.urlopen(r, timeout=120) as resp:
        raw = resp.read()
        ctype = resp.headers.get("Content-Type", "")
        return resp.status, (json.loads(raw) if "json" in ctype else raw), resp.headers


def _status(port, path, method="POST", body=None):
    try:
        return _req(port, path, method, body)[0]
    except urllib.error.HTTPError as e:
        return e.code


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from chatterbox_tpu_torch.serve.server import run_server

    tmp = tmp_path_factory.mktemp("server")
    cfg = ServerConfig(host="127.0.0.1", port=0, device="cpu",
                       voice_storage_path=str(tmp / "voices"),
                       config_storage_path=str(tmp / "configs"), cache_path=str(tmp / "cache"),
                       output_path=str(tmp / "outputs"))
    tts = _tiny_tts()
    tts.conds = _conds(40)
    httpd = run_server(cfg, tts=tts, background=True)

    class Handle:
        port = httpd.server_address[1]
        service = httpd.service

    yield Handle
    httpd.shutdown()
    httpd.service.batcher.shutdown()
    httpd.service.stream_batcher.shutdown()


def test_server_health_and_index(server):
    code, j, _ = _req(server.port, "/health")
    assert code == 200 and j["status"] == "ok" and j["model_loaded"] and j["device"] == "cpu"
    assert "preempted_batches" in j["batching"] and "stream_groups" in j["batching"]
    code, body, _ = _req(server.port, "/")
    assert code == 200 and b"chatterbox" in body


def test_server_voice_emotion_generate_roundtrip(server, tmp_path):
    wav_path = tmp_path / "v.wav"
    save_wav(wav_path, synthetic_voice(0, 1.0, 24000), 24000)
    code, j, _ = _req(server.port, "/voices/upload?filename=v.wav", "POST", wav_path.read_bytes())
    assert code == 200 and j["filename"] == "v.wav"
    assert "v.wav" in _req(server.port, "/voices")[1]
    code, j, _ = _req(server.port, "/emotions", "POST",
                      {"id": "happy", "name": "Happy", "character": "Narrator",
                       "exaggeration": 0.7, "voice_samples": ["v.wav"]})
    assert code == 200 and j["id"] == "happy"
    lst = _req(server.port, "/emotions")[1]
    assert lst["total_count"] == len(lst["emotions"]) and lst["characters"] == ["Narrator"]
    code, j, _ = _req(server.port, "/emotions/happy", "PUT", {"description": "glad"})
    assert code == 200 and j["description"] == "glad"
    code, j, _ = _req(server.port, "/generate", "POST",
                      {"text": "Hi.", "emotion": "happy", "seed": 1, "max_new_tokens": 8})
    assert code == 200 and j["success"] and j["duration_seconds"] > 0
    assert base64.b64decode(j["audio_base64"])[:4] == b"RIFF"
    assert "happy" in _req(server.port, "/health")[1]["emotions_ready"]
    # a multipart sample upload to the profile, then its removal
    boundary = "XyZ"
    body = (f"--{boundary}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"w.wav\"\r\n\r\n").encode() + wav_path.read_bytes() + \
        f"\r\n--{boundary}--\r\n".encode()
    r = urllib.request.Request(f"http://127.0.0.1:{server.port}/emotions/happy/voices",
                               data=body, method="POST")
    r.add_header("Content-Type", f"multipart/form-data; boundary={boundary}")
    with urllib.request.urlopen(r, timeout=60) as resp:
        assert resp.status == 200 and json.loads(resp.read())["success"]
    code, j, _ = _req(server.port, "/emotions/happy/voices/remove?voice_filename=w.wav", "DELETE")
    assert code == 200 and j["success"]
    assert _req(server.port, "/emotions/happy", "DELETE")[0] == 200
    assert not any(p["id"] == "happy" for p in _req(server.port, "/emotions")[1]["emotions"])
    assert _status(server.port, "/emotions/happy", "GET") == 404


def test_server_rejects_bad_requests(server):
    """422 for a body out of its schema, 400 for what the service refuses
    (an unknown emotion; ``alignment`` on the stream), 404 elsewhere."""
    assert _status(server.port, "/generate", body={"text": "x", "temperature": 5.0}) == 422
    assert _status(server.port, "/generate", body={"cfg_weight": 0.5}) == 422
    assert _status(server.port, "/emotions", body={"id": "a", "exaggeration": 3}) == 422
    assert _status(server.port, "/emotions", body={"id": "../etc"}) == 400
    assert _status(server.port, "/generate",
                   body={"text": "x", "emotion": "nope", "max_new_tokens": 4}) == 400
    assert _status(server.port, "/generate/stream",
                   body={"text": "Aligned stream.", "alignment": True, "max_new_tokens": 8}) == 400
    assert _status(server.port, "/nowhere", "GET") == 404


def test_server_generate_stream_chunked(server):
    """The chunked audio/L16 body: whole tokens of int16 PCM, the sample
    rate in its header, one lockstep group."""
    before = server.service.stream_batcher.stats["stream_groups"]
    code, raw, headers = _req(server.port, "/generate/stream", "POST",
                              {"text": "Streaming over HTTP.", "max_new_tokens": 20, "seed": 3})
    assert code == 200 and headers["Content-Type"] == "audio/L16"
    assert headers["X-Sample-Rate"] == "24000"
    pcm = np.frombuffer(raw, "<i2")
    assert len(pcm) > 0 and len(pcm) % 960 == 0
    assert server.service.stream_batcher.stats["stream_groups"] == before + 1
