"""The device trace of one call: torch.profiler's CUDA activity, summarised
in memory from the raw kineto events (the profiler's own event tree for a
call's hundreds of thousands of launches would take minutes of host time),
with no Chrome trace written.

A marker kernel launched on an idle device just before the call ties the
device clock to the host's, so that device time can be labelled by the
benchmark's own host spans around the call.
"""

import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass
class DeviceTrace:
    """Device intervals of one traced call, in seconds from its start."""

    wall_s: float  # host seconds from the marker to the call's end
    kernels: List[Tuple[str, float, float]]  # (name, start, duration), launch order
    copies: List[Tuple[str, float, float]]  # memcpy and memset, same form
    spans: Dict[str, Tuple[float, float]] = field(default_factory=dict)  # host spans, same clock

    def busy_s(self) -> float:
        """Seconds in which some kernel or copy ran: the union of their
        intervals, clipped to the call."""
        iv = sorted((s, s + d) for _, s, d in self.kernels + self.copies)
        busy, end = 0.0, 0.0
        for s, e in iv:
            s, e = max(s, end, 0.0), min(e, self.wall_s)
            if e > s:
                busy += e - s
                end = e
        return busy

    def gaps(self) -> List[Tuple[float, float]]:
        """(start, length) of each idle interval of the call."""
        iv = sorted((s, s + d) for _, s, d in self.kernels + self.copies)
        out, end = [], 0.0
        for s, e in iv:
            if s > end:
                out.append((end, s - end))
            end = max(end, e)
        if self.wall_s > end:
            out.append((end, self.wall_s - end))
        return out

    def span_of(self, t: float) -> str:
        for name, (s, e) in self.spans.items():
            if s <= t < e:
                return name
        return "other"

    def kernels_named(self, fragment: str) -> List[Tuple[str, float, float]]:
        return [k for k in self.kernels if fragment in k[0]]


def traced_call(fn):
    """Run ``fn(mark)`` under the profiler; ``fn`` calls ``mark(name)`` to
    open a host span now, or ``mark(name, at)`` at an earlier
    ``time.perf_counter()`` reading (a span lasts to the next mark or the
    end). Returns (fn's result, DeviceTrace)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    marks = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.cuda._sleep(1000)  # the marker: the first kernel of the window
        result = fn(lambda name, at=None: marks.append(
            (name, (time.perf_counter() if at is None else at) - t0)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            events.append((e.name(), e.start_ns(), e.duration_ns()))
    if not events:
        raise RuntimeError("the profiler recorded no device events")
    events.sort(key=lambda x: x[1])
    origin = events[0][1]  # the marker's start
    kernels, copies = [], []
    for name, start, dur in events[1:]:
        item = (name, (start - origin) / 1e9, dur / 1e9)
        low = name.lower()
        (copies if ("memcpy" in low or "memset" in low) else kernels).append(item)
    spans = {}
    marks.sort(key=lambda m: m[1])
    for i, (name, s) in enumerate(marks):
        e = marks[i + 1][1] if i + 1 < len(marks) else wall
        spans[name] = (s, e)
    return result, DeviceTrace(wall, kernels, copies, spans)


def breakdown(trace: DeviceTrace, top: int = 10):
    """The ``breakdown`` of a result line: the device operations that took
    most time, summed by name, and the idle time by host span (each span's
    summed gaps, then the longest single gaps; a gap belongs to the span
    its midpoint falls in), each at most ``top``."""
    by_name = {}
    for name, _, d in trace.kernels + trace.copies:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda x: -x[1])[:top]
    by_span = {}
    gaps = trace.gaps()
    for s, g in gaps:
        key = trace.span_of(s + g / 2)
        by_span[key] = by_span.get(key, 0.0) + g
    idle = [[f"{k} (all gaps)", v] for k, v in sorted(by_span.items(), key=lambda x: -x[1])]
    longest = sorted(gaps, key=lambda x: -x[1])[: max(0, top - len(idle))]
    idle += [[f"{trace.span_of(s + g / 2)} (one gap at {s:.4f} s)", g] for s, g in longest]
    return {"device_ops": [[n[:120], v] for n, v in ops], "idle_gaps": idle[:top]}
