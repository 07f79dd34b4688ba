"""Tracing and profiling utilities.

Port of ``chatterbox_tpu/runtime/profiling.py``:

- ``StageTimer``: wall time by stage, with the real-time factor in
  ``report(audio_seconds)``;
- ``trace(logdir)``: a ``torch.profiler`` trace of the block, written as a
  Chrome trace file under ``logdir``;
- ``annotate(name)``: the program's span, a named range around a block.

Spans and counters are recorded in memory between ``enable()`` and
``disable()``; ``take()`` hands them over and clears them. Off (the default)
a span costs one check of a module flag. On, each span records its name, its
start and end on ``time.perf_counter_ns()``, its parent and its call (a span
whose name ends in ``.call``, such as ``tts.call``, opens a new call id; the
others inherit their parent's). ``count(name, n)`` adds to the innermost open
span of the calling thread. While recording on a CUDA device, every
synchronising CUDA call (``torch.cuda.set_sync_debug_mode("warn")``) adds 1
to the ``host_syncs`` count of the innermost open span. While a torch
profiler runs (``trace``, or the caller's own), a span is also a
``record_function`` range, so that it shows in the profiler's trace.
"""

import contextlib
import functools
import itertools
import json
import os
import threading
import time
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import torch

HOST_SYNCS = "host_syncs"
# the text c10 gives a synchronising call in the "warn" sync-debug mode
_SYNC_TEXT = "called a synchronizing CUDA operation"


class StageTimer:
    """Accumulates per-stage wall time; ``report(audio_seconds)`` adds RTF."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, block_on=None):
        """Time the block as stage ``name``. ``block_on`` (a tensor or a
        device) makes the clock wait for that device's queued work before it
        stops: the device runs behind the host, so without it a stage times
        only the launches."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                dev = block_on.device if isinstance(block_on, torch.Tensor) else block_on
                if torch.device(dev).type == "cuda":
                    torch.cuda.synchronize(dev)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self, audio_seconds: float = None) -> dict:
        out = {k: round(v, 4) for k, v in self.totals.items()}
        total = sum(self.totals.values())
        out["total"] = round(total, 4)
        if audio_seconds:
            out["audio_seconds"] = round(audio_seconds, 3)
            out["rtf"] = round(total / audio_seconds, 4)
            out["audio_sec_per_s"] = round(audio_seconds / max(total, 1e-9), 3)
        return out

    def __str__(self):
        return json.dumps(self.report())


# ---------------------------------------------------------------------------
# the span and counter recorder
# ---------------------------------------------------------------------------


@dataclass
class Span:
    """One recorded span. Times are ``time.perf_counter_ns()`` readings;
    ``end_ns`` is None while the span is open."""

    name: str
    id: int
    parent: int  # the enclosing span's id; -1 at the top of its thread
    call: int  # the call's id; 0 outside any ``.call`` span
    start_ns: int
    end_ns: Optional[int] = None
    counts: Dict[str, int] = field(default_factory=dict)


class Recording(NamedTuple):
    """What ``take()`` hands over: the spans opened since the last take, in
    opening order, and the counts made while no span was open."""

    spans: List[Span]
    counts: Dict[str, int]


class _Recorder:
    """The spans and counts of the process, each thread with its own stack
    of open spans."""

    def __init__(self):
        self.spans: List[Span] = []
        self.counts: Dict[str, int] = {}
        self.local = threading.local()
        self.ids = itertools.count()
        self.calls = itertools.count(1)
        self.restore = None  # undoes enable()'s sync-debug hook

    def stack(self) -> List[Span]:
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def open(self, name: str) -> Span:
        st = self.stack()
        parent = st[-1] if st else None
        call = next(self.calls) if name.endswith(".call") else (parent.call if parent else 0)
        span = Span(name, next(self.ids), parent.id if parent else -1, call,
                    time.perf_counter_ns())
        self.spans.append(span)
        st.append(span)
        return span

    def close(self, span: Span):
        span.end_ns = time.perf_counter_ns()
        st = self.stack()
        if st and st[-1] is span:
            st.pop()

    def add(self, name: str, n: int):
        st = self.stack()
        counts = st[-1].counts if st else self.counts
        counts[name] = counts.get(name, 0) + n

    def take(self) -> Recording:
        out = Recording(self.spans, self.counts)
        self.spans, self.counts = [], {}
        return out


_REC = _Recorder()
_RECORDING = False
_TRACES = 0  # open ``trace`` blocks
_ON = False  # a span does anything: recording, or inside ``trace``


def _refresh():
    global _ON
    _ON = _RECORDING or _TRACES > 0


class _Span:
    """``annotate``'s context when spans are on."""

    __slots__ = ("name", "span", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rf = None
        if torch.autograd.profiler._is_profiler_enabled:
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.span = _REC.open(self.name) if _RECORDING else None
        return self

    def __exit__(self, *exc):
        if self.span is not None:
            _REC.close(self.span)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """The program's span ``name`` around a ``with`` block (see the module's
    docstring): nothing when spans are off."""
    if not _ON:
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: each call of the function as a span ``name``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _ON:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def count(name: str, n: int = 1):
    """Add ``n`` to counter ``name`` of the innermost open span (of the
    calling thread) while recording."""
    if _RECORDING:
        _REC.add(name, n)


def enable():
    """Start recording spans and counts (a no-op when recording). On a CUDA
    device this puts ``torch.cuda`` in the "warn" sync-debug mode and counts
    each of its warnings, every one, as ``host_syncs``."""
    global _RECORDING
    if _RECORDING:
        return
    if torch.cuda.is_available():
        _REC.restore = _hook_syncs()
    _RECORDING = True
    _refresh()


def disable():
    """Stop recording; what was recorded stays for ``take``. The sync-debug
    mode and the warning filters go back to what they were."""
    global _RECORDING
    if not _RECORDING:
        return
    _RECORDING = False
    _refresh()
    restore, _REC.restore = _REC.restore, None
    if restore is not None:
        restore()


def take() -> Recording:
    """The spans and counts recorded since the last ``take``, which are then
    cleared (a span still open is handed over and closes later)."""
    return _REC.take()


def _hook_syncs():
    """Count every synchronising CUDA call as ``host_syncs``: the "warn"
    sync-debug mode, a filter that shows each of its warnings (Python's
    default shows a site once) and a ``showwarning`` that counts them and
    passes other warnings on. Returns what undoes it."""
    mode = torch.cuda.get_sync_debug_mode()
    saved = warnings.catch_warnings()
    saved.__enter__()
    warnings.filterwarnings("always", message=_SYNC_TEXT, category=UserWarning)
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_TEXT in str(message):
            count(HOST_SYNCS)
        else:
            shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")

    def restore():
        torch.cuda.set_sync_debug_mode(mode)
        saved.__exit__(None, None, None)

    return restore


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the GPU when
    there is one) and write ``logdir/trace_<pid>_<ns>.json``, a Chrome
    trace (chrome://tracing, Perfetto), with the program's spans in it."""
    global _TRACES
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _TRACES += 1
    _refresh()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield
    finally:
        _TRACES -= 1
        _refresh()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
