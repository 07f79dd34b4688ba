"""``benchmark/spans.py`` on made-up kineto events and program records, on
the CPU: the tie of launches to the host clock, attribution by launch, the
readers and the idle labels. No number here is a device number."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from benchmark import harness
from benchmark import spans as sp
from benchmark.trace import DeviceTrace
from chatterbox_tpu_torch.runtime.profiling import Recording, Span

TIE = 1_000_000  # the made-up trace clock runs 1 ms ahead of perf_counter_ns
MARKER_NS = 7_000  # perf_counter_ns as the marker's launch returned


class Ev:
    def __init__(self, name, start, dur, corr, dev):
        self._v = (name, start, dur, corr, DeviceType.CUDA if dev else DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return self._v[4]


def _events():
    """The marker (launched from host 5 000 to 7 000 ns, running from 6 000
    on the device, 5 900 on the host clock), a kernel launched at host 20 000 ns
    that runs at 100 000 (queued behind), one launched at 25 000 that runs
    at 36 000, a copy launched at 60 000, and a kernel with no launch
    event."""
    t = TIE
    return [
        Ev("cudaLaunchKernel", t + 5_100, 2_000, 1, False), Ev("sleep", t + 6_000, 1_000, 1, True),
        Ev("cudaLaunchKernel", t + 25_100, 2_000, 5, False), Ev("k2", t + 36_000, 10_000, 5, True),
        Ev("cudaLaunchKernelExC", t + 20_000, 3_000, 2, False),
        Ev("gemm", t + 100_000, 40_000, 2, True),
        Ev("cudaMemcpyAsync", t + 60_000, 2_000, 3, False),
        Ev("Memcpy DtoH (Device -> Pageable)", t + 150_000, 10_000, 3, True),
        Ev("orphan", t + 170_000, 5_000, 9, True),
        Ev("cudaStreamSynchronize", t + 61_000, 100_000, 4, False),  # not a launch
    ]


def _spans():
    """Host ns: tts.call [0, 300 000) holding t3.step [10 000, 50 000) with
    t3.forward [15 000, 30 000), and s3gen.collect [55 000, 70 000)."""
    return [Span("tts.call", 0, -1, 1, 0, 300_000, {"host_syncs": 4}),
            Span("t3.step", 1, 0, 1, 10_000, 50_000, {"host_syncs": 1}),
            Span("t3.forward", 2, 1, 1, 15_000, 30_000, {"host_syncs": 1}),
            Span("s3gen.collect", 3, 0, 1, 55_000, 70_000, {"host_syncs": 2})]


def test_launched_ties_launches_to_the_host_clock():
    la = sp.launched(_events(), MARKER_NS)
    assert la.tie_ns == TIE + 100
    assert [op[0] for op in la.ops] == ["k2", "gemm", "Memcpy DtoH (Device -> Pageable)",
                                        "orphan"]
    assert [op[3] for op in la.ops] == [25_000, 19_900, 59_900, None]
    assert la.ops[1][1] == pytest.approx(94e-6) and la.ops[1][2] == pytest.approx(40e-6)
    assert la.host_ns(la.ops[1][1]) == 94_000 + 6_000 - 100  # the device start on the host clock


def test_launched_is_none_without_the_markers_launch():
    evs = [e for e in _events() if e.correlation_id() != 1 or e.device_type() == DeviceType.CUDA]
    assert sp.launched(evs, MARKER_NS) is None
    assert sp.launched([], MARKER_NS) is None


def _run(with_records=True, with_launches=True):
    la = sp.launched(_events(), MARKER_NS) if with_launches else None
    dt = DeviceTrace(0.3, [("k2", 30e-6, 10e-6), ("gemm", 94e-6, 40e-6),
                           ("orphan", 164e-6, 5e-6)],
                     [("Memcpy DtoH", 144e-6, 10e-6)], {"t3": (0.0, 0.12), "s3gen": (0.12, 0.3)})
    dt.launched = la
    rec = Recording(_spans(), {}) if with_records else ()
    traced = harness.Call(k=0, wall_s=0.3, audio_s=2.0, seed=1, traced=True)
    host = harness.Call(k=1, wall_s=0.3, audio_s=2.0, seed=1)
    traced.spans, host.spans = rec, rec
    return SimpleNamespace(calls=[traced, host], trace=dt, traced_call=lambda: traced,
                           host_calls=lambda: [host])


def test_readers_from_records_and_launches():
    run = _run()
    assert sp.t3_step_ms(run) == pytest.approx(0.04)
    assert sp.t3_syncs_per_step(run) == 2.0  # its own and its child's
    assert sp.s3gen_syncs_per_call(run) == 2.0
    assert sp.t3_step_launches(run) == 2.0
    assert sp.device_s_in(run, ("t3.step",)) == pytest.approx(50e-6)
    assert sp.device_ms_per_audio_s(run, ("s3gen.collect",)) == pytest.approx(1e3 * 10e-6 / 2.0)
    # of the kernels (k2 10 us, gemm 40 us, orphan 5 us), two are below the root
    assert sp.attributed_share(run) == pytest.approx(100 * 50 / 55)
    assert sp.device_s_in(run, ("s3gen.collect",)) == pytest.approx(10e-6)


@pytest.mark.parametrize("records,launches", [(False, True), (True, False), (False, False)])
def test_readers_report_nothing_without_what_they_read(records, launches):
    run = _run(records, launches)
    device = [sp.t3_step_launches(run), sp.device_s_in(run, ("t3.step",)),
              sp.attributed_share(run), sp.breakdown(run), sp.gap_labels(run)]
    assert device == [None] * 5
    if not records:
        assert [sp.t3_step_ms(run), sp.t3_syncs_per_step(run),
                sp.s3gen_syncs_per_call(run)] == [None] * 3


def test_breakdown_labels_idle_gaps_with_the_program_span():
    run = _run()
    out = sp.breakdown(run)
    labels = [k for k, _ in out["idle_gaps"]]
    # gap midpoints on the host clock (device seconds + 5 900 ns): 0-30 us
    # at 20 900 ns, in t3.forward; 40-94 us at 72 900, 134-144 at 144 900
    # and 154-164 at 164 900, in the root alone; the rest of the call past
    # every span
    got = {round(s * 1e9): name for s, name in sp.gap_labels(run).items()}
    assert got == {0: "t3.forward", 40_000: "tts.call", 134_000: "tts.call",
                   154_000: "tts.call", 169_000: "(none)"}
    assert [k for k in labels if "all gaps" in k] == [
        "s3gen/(none) (all gaps)", "t3/tts.call (all gaps)", "t3/t3.forward (all gaps)"]
    assert [n for n, _ in out["device_ops"]][0] == "gemm"
