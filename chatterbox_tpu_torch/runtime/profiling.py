"""Tracing and profiling utilities.

Port of ``chatterbox_tpu/runtime/profiling.py``:

- ``StageTimer``: wall time by stage, with the real-time factor in
  ``report(audio_seconds)``;
- ``trace(logdir)``: a ``torch.profiler`` trace of the block, written as a
  Chrome trace file under ``logdir``;
- ``annotate(name)``: a named range in that trace
  (``torch.profiler.record_function``) and, on a GPU, an NVTX range.
"""

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


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


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` (the CPU, and the GPU when
    there is one) and write ``logdir/trace_<pid>_<ns>.json``, a Chrome
    trace (chrome://tracing, Perfetto)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range around the block, in a ``trace`` and, when CUDA is
    initialised, in an NVTX timeline."""
    nvtx = torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()
