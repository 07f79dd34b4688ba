"""The Pallas probes of ``scripts/`` on the port, one module each:

- ``boundary`` (P1, ``scripts/probe_boundary.py``): T3's decode step split
  into four 30-layer chains, slope-timed eager and as a replayed CUDA graph;
- ``cache_write`` (P2 and P3, ``scripts/probe_cache_write2.py`` and
  ``probe_cache_write3.py``): the variants of the K/V column write, beside
  the port's own per-step append (K2);
- ``int8_cache`` (P4, ``scripts/probe_int8_cache.py``): the int8 fragments;
- ``ops`` (P5, ``scripts/probe_ops.py``): the online-softmax fragments.

Each runs as ``python -m chatterbox_tpu_torch.probes.<name>`` on CUDA
(``--device cpu`` runs the plain versions and measures no time) and prints
one JSON line of results; ``run`` returns the same dict.
"""

import argparse
import json

import torch


def graph_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device milliseconds of one ``fn()``: ``iters`` calls captured in
    one CUDA graph, replayed once to warm and once between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # builds, loads and allocates outside the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn) -> tuple[float, float, float]:
    """Device milliseconds of one ``fn()`` that finds the L2 cold, as
    (median, least, most) over 50 calls. Before each call: a read of 128 MiB
    (2.5x an H100's 50 MB L2), which leaves the L2 holding clean lines of
    another buffer (a write would leave dirty ones, whose write-back the
    timed call would pay for), then a spin of the stream for 2e6 clock
    cycles (about 1 ms), long enough for the host to queue the call, so that
    the card does not wait on the host between the start event and the
    call. CUDA events around the call alone."""
    flush = torch.ones(32 << 20, device="cuda")
    fn()
    times = []
    for _ in range(50):
        flush.sum()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[25], times[0], times[-1]


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def main(run, description: str, extra=None):
    """Command line of a probe module: ``--device`` (default cuda; without
    a card and without ``--device cpu`` it raises) and the options ``extra``
    adds to the parser; prints ``run(device, **options)`` as one JSON line."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda")
    if extra is not None:
        extra(ap)
    args = vars(ap.parse_args())
    device = torch.device(args.pop("device"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu for the plain versions")
    print(json.dumps(run(device, **args)), flush=True)
