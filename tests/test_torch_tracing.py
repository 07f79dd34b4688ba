"""The span and counter recorder (``runtime/profiling.py``) on the port's
pipelines at tiny widths, and on the card: its sync counter, and the
benchmark's attribution of device operations to spans by their launches
(``benchmark/spans.py``).

This file imports neither JAX nor the JAX package, so its card tests run on
the machine with the card, without the repo's conftest:

    python -m pytest tests/test_torch_tracing.py -q --noconftest -p no:cacheprovider
"""

import statistics
import time

import numpy as np
import pytest
import torch

from benchmark import spans as bspans
from chatterbox_tpu_torch.models.s3gen.conformer import ConformerConfig
from chatterbox_tpu_torch.models.s3gen.flow import FlowConfig
from chatterbox_tpu_torch.models.s3gen.hifigan import HiFTConfig
from chatterbox_tpu_torch.models.s3gen.s3gen import S3GenConfig
from chatterbox_tpu_torch.models.s3gen.unet import UNetConfig
from chatterbox_tpu_torch.models.s3gen.xvector import CAMPPlusConfig
from chatterbox_tpu_torch.models.s3tokenizer import S3TokenizerConfig
from chatterbox_tpu_torch.models.t3.llama import LlamaConfig
from chatterbox_tpu_torch.models.t3.t3 import DONE_CHECK_EVERY, T3Config
from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig
from chatterbox_tpu_torch.pipeline.audio import synthetic_voice
from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS
from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC
from chatterbox_tpu_torch.runtime import profiling

torch.set_num_threads(1)

T3 = T3Config(llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                num_attention_heads=2, num_key_value_heads=2, head_dim=32))
S3 = S3GenConfig(
    flow=FlowConfig(input_size=128,
                    encoder=ConformerConfig(input_size=128, output_size=128, attention_heads=4,
                                            linear_units=256, num_blocks=2, num_up_blocks=1),
                    estimator=UNetConfig(channels=64, n_blocks=1, num_mid_blocks=2,
                                         num_heads=4)),
    hift=HiFTConfig(base_channels=32, f0_cond_channels=32),
    campplus=CAMPPlusConfig(growth_rate=8, bn_size=2, init_channels=32, m_channels=8,
                            block_layers=(1, 1, 1)),
    tokenizer=S3TokenizerConfig(n_state=64, n_head=4, n_layer=2),
)
TEXTS = ["Hello world.", "A somewhat longer test sentence."]
MAX_NEW = 2 * DONE_CHECK_EVERY + 3  # two done checks
FLOW_STEPS = 2
S3GEN_STAGES = ("s3gen.encoder", "s3gen.euler", "s3gen.hift", "s3gen.watermark",
                "s3gen.collect")


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off and empty."""
    profiling.disable()
    profiling.take()
    yield
    profiling.disable()
    profiling.take()


@pytest.fixture(scope="module")
def tts():
    tts = ChatterboxTTS.from_random(0, T3, S3, device="cpu",
                                    ve_cfg=VoiceEncoderConfig(hidden_size=32, num_layers=2))
    tts.prepare_conditionals(synthetic_voice(1, 3.0, 24000))
    return tts


@pytest.fixture(scope="module")
def vc(tts):
    vc = ChatterboxVC(tts.s3gen_params, "cpu", S3)
    vc.set_target_voice(synthetic_voice(1, 3.0, 24000))
    return vc


def _generate(tts):
    """EOS suppressed, so every row runs to MAX_NEW: MAX_NEW loop steps."""
    wavs = tts.generate_batch(TEXTS, seed=3, max_new_tokens=MAX_NEW, min_new_tokens=MAX_NEW,
                              flow_steps=FLOW_STEPS)
    return wavs, tts.last_speech_tokens


def _sources():
    return [synthetic_voice(2, 1.0, 16000), synthetic_voice(3, 0.6, 16000)]


def _recorded(fn):
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    return out, profiling.take()


def _named(rec, name):
    return [s for s in rec.spans if s.name == name]


def test_off_costs_one_shared_context_and_records_nothing(tts):
    assert profiling.annotate("a") is profiling.annotate("b")  # no allocation when off
    _generate(tts)
    assert profiling.take() == ([], {})


def test_tts_span_tree(tts):
    _, rec = _recorded(lambda: _generate(tts))
    by_id = {s.id: s for s in rec.spans}
    (root,) = _named(rec, "tts.call")
    assert root.parent == -1 and root.call > 0
    assert len(_named(rec, "t3.step")) == MAX_NEW
    assert len(_named(rec, "t3.sample")) == MAX_NEW
    assert len(_named(rec, "t3.forward")) == MAX_NEW - 1  # the last token's logits are not read
    assert len(_named(rec, "t3.done_check")) == (MAX_NEW - 1) // DONE_CHECK_EVERY
    assert len(_named(rec, "s3gen.euler")) == FLOW_STEPS
    for name in ("tts.prepare", "t3.prefill", "tts.tokens") + S3GEN_STAGES:
        assert len(_named(rec, name)) == (FLOW_STEPS if name == "s3gen.euler" else 1), name
    for s in rec.spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        assert s.call == root.call  # one call id for the call's spans
        if s is not root:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s.name, p.name)
    for name in ("t3.sample", "t3.forward", "t3.done_check"):
        assert {by_id[s.parent].name for s in _named(rec, name)} == {"t3.step"}
    assert {by_id[s.parent].name for s in _named(rec, "t3.step")} == {"tts.call"}
    # a step's children in the loop's order, and the steps one after another
    steps = _named(rec, "t3.step")
    assert all(a.end_ns <= b.start_ns for a, b in zip(steps, steps[1:]))


def test_each_call_opens_its_own_id(tts, vc):
    def both():
        _generate(tts)
        vc.generate_batch(_sources(), seed=1, flow_steps=FLOW_STEPS)
        _generate(tts)

    _, rec = _recorded(both)
    roots = [s for s in rec.spans if s.parent == -1]
    assert [s.name for s in roots] == ["tts.call", "vc.call", "tts.call"]
    assert len({s.call for s in roots}) == 3
    for r in roots:
        assert r.call > 0
    assert {s.call for s in rec.spans} == {r.call for r in roots}


def test_vc_span_tree(vc):
    _, rec = _recorded(lambda: vc.generate_batch(_sources(), seed=1, flow_steps=FLOW_STEPS))
    by_id = {s.id: s for s in rec.spans}
    (root,) = _named(rec, "vc.call")
    names = [s.name for s in rec.spans]
    assert names == ["vc.call", "vc.upload", "vc.tokenize", "s3gen.encoder"] + \
        ["s3gen.euler"] * FLOW_STEPS + ["s3gen.hift", "s3gen.watermark", "s3gen.collect"]
    assert all(by_id[s.parent] is root for s in rec.spans if s is not root)


def test_spans_close_when_the_call_raises(tts):
    def bad():
        with pytest.raises(ValueError):
            tts.generate_batch(TEXTS, max_new_tokens=MAX_NEW, flow_steps=0)
        with profiling.annotate("after"):
            pass

    _, rec = _recorded(bad)
    assert [s.name for s in rec.spans] == ["tts.call", "tts.prepare", "after"]
    assert all(s.end_ns is not None for s in rec.spans)
    assert _named(rec, "after")[0].parent == -1  # nothing was left open


def test_outputs_bit_identical_on_and_off(tts, vc):
    wavs_off, tok_off = _generate(tts)
    (wavs_on, tok_on), _ = _recorded(lambda: _generate(tts))
    assert len(tok_on) == len(tok_off) == len(TEXTS)
    for a, b in zip(tok_on + wavs_on, tok_off + wavs_off):
        assert np.array_equal(a, b)
    off = vc.generate_batch(_sources(), seed=1, flow_steps=FLOW_STEPS)
    on, _ = _recorded(lambda: vc.generate_batch(_sources(), seed=1, flow_steps=FLOW_STEPS))
    for a, b in zip(on, off):
        assert np.array_equal(a, b)


def test_take_clears_and_counts_go_to_the_innermost_span():
    def work():
        profiling.count("loose")
        with profiling.annotate("outer"):
            profiling.count("n", 2)
            with profiling.annotate("inner"):
                profiling.count("n")
            profiling.count("n")

    _, rec = _recorded(work)
    (outer,), (inner,) = _named(rec, "outer"), _named(rec, "inner")
    assert outer.counts == {"n": 3} and inner.counts == {"n": 1}
    assert rec.counts == {"loose": 1}
    assert profiling.take() == ([], {})
    profiling.count("n")  # off: counts nothing
    with profiling.annotate("x"):
        pass
    assert profiling.take() == ([], {})


def test_a_span_taken_while_open_closes_later():
    profiling.enable()
    with profiling.annotate("open"):
        (span,), _ = profiling.take()
        assert span.end_ns is None
    profiling.disable()
    assert span.end_ns is not None and profiling.take() == ([], {})


def test_attribution_by_launch_on_made_up_spans():
    """Launch times against nested spans, on the CPU: each time goes to
    the innermost span open then, whatever the order of the spans."""
    mk = profiling.Span
    spans = [mk("root", 0, -1, 1, 0, 100), mk("a", 1, 0, 1, 10, 40), mk("a1", 2, 1, 1, 20, 30),
             mk("b", 3, 0, 1, 50, None)]
    times = [5, 15, 25, 30, 45, 60, 200, None, -1]
    got = bspans.innermost(times, list(reversed(spans)))
    assert [s.name if s else None for s in got] == \
        ["root", "a", "a1", "a", "root", "b", "b", None, None]
    assert bspans.lineage(spans)[2] == ("a1", "a", "root")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sync counter and launch events are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_host_syncs_counts_every_sync(cuda):
    mode = torch.cuda.get_sync_debug_mode()
    x = torch.arange(8.0, device=cuda)
    torch.cuda.synchronize()

    def toy():
        with profiling.annotate("toy"):
            for _ in range(2):  # the same site twice: both count
                float(x.sum().item())
            torch.from_numpy(np.ones(16, np.float32)).to(cuda)  # a pageable upload
            (x * 2).sum()  # no sync

    _, rec = _recorded(toy)
    (span,) = rec.spans
    assert span.counts == {profiling.HOST_SYNCS: 3}
    assert torch.cuda.get_sync_debug_mode() == mode


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        torch.cuda._sleep(1000)
        marker_ns = time.perf_counter_ns()
        out = fn()
        torch.cuda.synchronize()
    return out, bspans.launched(prof.profiler.kineto_results.events(), marker_ns)


@pytest.mark.cuda
def test_a_launch_belongs_to_the_span_it_was_launched_in(cuda):
    """The inner kernel runs after its 1 ms span has closed (a ~5 ms kernel
    is queued before it): it is still the inner span's."""

    def work():
        with profiling.annotate("outer"):
            torch.cuda._sleep(10_000_000)
            time.sleep(0.001)
            with profiling.annotate("inner"):
                time.sleep(0.0005)
                torch.cuda._sleep(100_000)
                time.sleep(0.0005)
            time.sleep(0.001)

    (_, rec), la = _profiled(lambda: _recorded(work))
    assert la is not None, "the trace holds no launch event of the marker"
    assert len(la.ops) == 2  # the two sleeps, in launch order
    owners = bspans.innermost([op[3] for op in la.ops], rec.spans)
    assert [o.name for o in owners] == ["outer", "inner"]
    (inner,) = _named(rec, "inner")
    assert inner.end_ns - inner.start_ns >= 1_000_000
    # it ran after the inner span closed, on the same clock
    assert la.host_ns(la.ops[1][1]) > inner.end_ns


@pytest.mark.cuda
def test_clock_tie_spread_over_100_markers(cuda):
    """The tie (the end of a launch on the trace's clock minus
    perf_counter_ns as the launch returned) over 100 marker launches: its
    spread is the tie's error, well under the 1 ms of the shortest span
    attributed."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    reads = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            torch.cuda._sleep(1000)
            reads.append(time.perf_counter_ns())
            time.sleep(0.0002)
        torch.cuda.synchronize()
    launches = sorted(e.start_ns() + e.duration_ns() for e in prof.profiler.kineto_results.events()
                      if e.device_type() != DeviceType.CUDA
                      and e.name().startswith(bspans.LAUNCH_CALLS))
    assert len(launches) == 100
    ties = [lc - r for lc, r in zip(launches, reads)]
    q1, _, q3 = statistics.quantiles(ties, n=4)
    spread_us = (max(ties) - min(ties)) / 1e3
    print(f"clock tie over 100 markers: quartiles {(q3 - q1) / 1e3:.3f} us apart, max - min "
          f"{spread_us:.3f} us ({torch.cuda.get_device_name(0)})")
    assert spread_us < 500
