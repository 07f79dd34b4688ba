"""The program's spans and counters (``chatterbox_tpu_torch.runtime.profiling``)
on the device trace's clock, and the per-layer numbers read from them.

Each device operation of a traced call is tied to the CUDA runtime call that
launched it (the kineto event of ``cudaLaunchKernel``, ``cudaMemcpyAsync``
and the like with the same correlation id). The host's launch times are put
on ``time.perf_counter_ns``'s clock, the program's, by the marker kernel that
starts the call: the end of its own launch event against a
``perf_counter_ns`` reading taken as soon as the launch returned. (The start
of a first launch under the profiler lags the host by tens of
microseconds; its end does not.) An operation belongs to the innermost
program span open when it was launched, not when it ran: the host runs
ahead of the device.

A call's record is what ``profiling.take()`` returned after it (spans and
the counts made outside any span). Every reader returns None where the run
holds no such record or no launch events, as a run of a program without
spans does.
"""

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from benchmark import trace

# the CUDA API calls that put an operation on a stream
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaGraphLaunch")
T3_STEP = "t3.step"
ROOTS = ("tts.call", "vc.call")
# from T3's return (VC: from the sources' upload) to the wav's readback
S3GEN_STAGES = ("tts.tokens", "vc.upload", "vc.tokenize", "s3gen.encoder", "s3gen.euler",
                "s3gen.hift", "s3gen.watermark", "s3gen.collect")
HOST_SYNCS = "host_syncs"


@dataclass
class Launched:
    """A traced call's device operations with their launches."""

    ops: List[Tuple[str, float, float, Optional[int]]]  # (name, start s from the
    # marker's start, duration s, launch on perf_counter_ns or None), marker left out
    tie_ns: int  # the trace's host clock minus perf_counter_ns
    origin_ns: int  # the marker's device start, on the trace's clock

    def host_ns(self, t: float) -> int:
        """Seconds from the marker's device start -> perf_counter_ns."""
        return self.origin_ns + round(t * 1e9) - self.tie_ns


def launched(events: Iterable, marker_ns: int) -> Optional[Launched]:
    """The device operations of kineto ``events`` (a profile whose first
    device operation is the marker, whose launch returned just before
    ``marker_ns``, a ``perf_counter_ns`` reading), each with its launch's
    host time; None when the trace holds no launch event of the marker."""
    from torch.autograd import DeviceType

    dev, runtime = [], {}
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            dev.append((e.name(), e.start_ns(), e.duration_ns(), e.correlation_id()))
        elif e.name().startswith(LAUNCH_CALLS):
            runtime[e.correlation_id()] = (e.start_ns(), e.duration_ns())
    if not dev:
        return None
    dev.sort(key=lambda x: x[1])
    marker = dev[0]
    if marker[3] not in runtime:
        return None
    tie = sum(runtime[marker[3]]) - marker_ns
    ops = [(name, (s - marker[1]) / 1e9, d / 1e9,
            runtime[c][0] - tie if c in runtime else None) for name, s, d, c in dev[1:]]
    return Launched(ops, tie, marker[1])


def innermost(times: Sequence[Optional[int]], spans) -> List[Optional[object]]:
    """For each host time (perf_counter_ns, or None), the innermost span
    open then, or None: one sweep over spans that nest (one thread's)."""
    order = sorted((t, i) for i, t in enumerate(times) if t is not None)
    spans = sorted(spans, key=lambda s: s.start_ns)
    out: List[Optional[object]] = [None] * len(times)
    stack, j = [], 0
    for t, i in order:
        while j < len(spans) and spans[j].start_ns <= t:
            s = spans[j]
            j += 1
            while stack and _end(stack[-1]) <= s.start_ns:
                stack.pop()
            stack.append(s)
        while stack and _end(stack[-1]) <= t:
            stack.pop()
        out[i] = stack[-1] if stack else None
    return out


def _end(span) -> float:
    return float("inf") if span.end_ns is None else span.end_ns


def lineage(spans) -> Dict[int, Tuple[str, ...]]:
    """Span id -> the names from that span up to its root."""
    by_id = {s.id: s for s in spans}
    out = {}
    for s in spans:
        names, p = [], s
        while p is not None:
            names.append(p.name)
            p = by_id.get(p.parent)
        out[s.id] = tuple(names)
    return out


def _record(call):
    """A call's (spans, counts), or None without a record."""
    rec = getattr(call, "spans", ())
    return rec if rec else None


def _launches(run):
    """(traced call's spans, Launched), or None."""
    c = run.traced_call()
    rec = _record(c) if c is not None else None
    la = getattr(run.trace, "launched", None)
    if rec is None or la is None or not rec[0]:
        return None
    return rec[0], la


def op_owners(run):
    """(ops, each op's innermost span at launch, lineage) of the traced
    call, or None."""
    got = _launches(run)
    if got is None:
        return None
    spans, la = got
    return la.ops, innermost([op[3] for op in la.ops], spans), lineage(spans)


def t3_step_ms(run) -> Optional[float]:
    """Host ms of the ``t3.step`` spans over their count, in the calls the
    profiler did not cover."""
    steps = [s for c in run.host_calls() if _record(c) for s in _record(c)[0]
             if s.name == T3_STEP and s.end_ns is not None]
    if not steps:
        return None
    return sum(s.end_ns - s.start_ns for s in steps) / len(steps) / 1e6


def t3_syncs_per_step(run) -> Optional[float]:
    """``host_syncs`` inside ``t3.step`` spans (their children's too) over
    their count, over every call with a record."""
    syncs = steps = 0
    for c in run.calls:
        rec = _record(c)
        if rec is None:
            continue
        names = lineage(rec[0])
        for s in rec[0]:
            if T3_STEP in names[s.id]:
                syncs += s.counts.get(HOST_SYNCS, 0)
                steps += s.name == T3_STEP
    return syncs / steps if steps else None


def s3gen_syncs_per_call(run) -> Optional[float]:
    """``host_syncs`` in the stages from T3's return (VC: the sources'
    upload) to the wav's readback (``S3GEN_STAGES`` and their children), a
    call, over every call with a record."""
    per_call = []
    for c in run.calls:
        rec = _record(c)
        if rec is None or not rec[0]:
            continue
        names = lineage(rec[0])
        per_call.append(sum(s.counts.get(HOST_SYNCS, 0) for s in rec[0]
                            if any(n in S3GEN_STAGES for n in names[s.id])))
    return sum(per_call) / len(per_call) if per_call else None


def t3_step_launches(run) -> Optional[float]:
    """Device operations launched inside ``t3.step`` spans over their count,
    in the traced call."""
    got = op_owners(run)
    if got is None:
        return None
    ops, owners, names = got
    steps = sum(1 for s in _record(run.traced_call())[0] if s.name == T3_STEP)
    if not steps:
        return None
    return sum(1 for o in owners if o is not None and T3_STEP in names[o.id]) / steps


def device_s_in(run, stages: Sequence[str]) -> Optional[float]:
    """Device seconds of the traced call's operations launched inside any of
    ``stages`` (their children's too)."""
    got = op_owners(run)
    if got is None:
        return None
    ops, owners, names = got
    return sum(op[2] for op, o in zip(ops, owners)
               if o is not None and any(n in stages for n in names[o.id]))


def device_ms_per_audio_s(run, stages: Sequence[str]) -> Optional[float]:
    """``device_s_in`` in ms over the traced call's audio seconds."""
    s = device_s_in(run, stages)
    c = run.traced_call()
    if s is None or not c.audio_s:
        return None
    return 1e3 * s / c.audio_s


def attributed_share(run) -> Optional[float]:
    """% of the traced call's kernel time launched inside a program span
    below the call's root span."""
    got = op_owners(run)
    if got is None:
        return None
    ops, owners, _ = got
    kernels = [(op, o) for op, o in zip(ops, owners) if not _is_copy(op[0])]
    total = sum(op[2] for op, _ in kernels)
    inside = sum(op[2] for op, o in kernels if o is not None and o.name not in ROOTS)
    return 100.0 * inside / total if total else None


def _is_copy(name: str) -> bool:
    low = name.lower()
    return "memcpy" in low or "memset" in low


def gap_labels(run) -> Optional[Dict[float, str]]:
    """Each idle gap's start (as ``DeviceTrace.gaps`` gives it) -> the
    innermost program span open on the host at the gap's midpoint."""
    got = _launches(run)
    if got is None:
        return None
    spans, la = got
    gaps = run.trace.gaps()
    owners = innermost([la.host_ns(s + g / 2) for s, g in gaps], spans)
    return {s: (o.name if o is not None else "(none)") for (s, _), o in zip(gaps, owners)}


def breakdown(run, top: int = 10):
    """``trace.breakdown`` with each idle label the benchmark's span, then
    the innermost program span open on the host at the gap's midpoint
    (``t3/t3.forward (all gaps)``); None without launches and spans."""
    labels = gap_labels(run)
    if labels is None:
        return None
    tr = run.trace
    gaps = tr.gaps()

    def label(s, g):
        return f"{tr.span_of(s + g / 2)}/{labels[s]}"

    by_span: Dict[str, float] = {}
    for s, g in gaps:
        by_span[label(s, g)] = by_span.get(label(s, g), 0.0) + g
    idle = [[f"{k} (all gaps)", v] for k, v in sorted(by_span.items(), key=lambda x: -x[1])]
    longest = sorted(gaps, key=lambda x: -x[1])[: max(0, top - len(idle))]
    idle += [[f"{label(s, g)} (one gap at {s:.4f} s)", g] for s, g in longest]
    return {"device_ops": trace.breakdown(tr, top)["device_ops"], "idle_gaps": idle[:top]}
