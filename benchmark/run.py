"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (weights from the seed, the pipeline, the voice, one warm call at
the cell's shapes) counts as ``setup_s``; the window then runs whole calls
until one ends at or after ``--seconds``. ``--trace 0`` reports the cell's
end-to-end metrics, ``--trace 1`` its per-layer ones, with the first call
of the window under the profiler. After the window the program's state is
freed and the plain reference checks a sample of what the window served;
the compared numbers and their limits are the last lines on standard error
and the last key of the result, the last line on standard output.
``--control 1`` also runs the control (the reference in a precision one
step below the configuration's), judges its readings against the same
limits and prints them and its verdict (the result's ``control`` key); the
benchmark's own runs never do.

Without a CUDA device, or with fewer than the cell asks for, the run exits
with code 3 and prints no result.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "chatterbox_tpu")
CACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".bench_cache")


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _host_lines(torch):
    cpu = platform.processor() or "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            cpu = next((ln.split(":", 1)[1].strip() for ln in f if ln.startswith("model name")),
                       cpu)
    except OSError:
        pass
    print(f"host: {cpu}, {os.cpu_count()} cores; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", file=sys.stderr, flush=True)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,"
                              "power.draw,power.limit,temperature.gpu", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20).stdout.strip()
        print(f"card: {out}", file=sys.stderr, flush=True)
    except (OSError, subprocess.SubprocessError):
        print("card: nvidia-smi not readable", file=sys.stderr, flush=True)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(ctx, driver, seconds: float, trace: bool):
    """Set-up, then the window: returns (the driver's state, Run)."""
    import torch

    from benchmark import harness
    from benchmark import trace as tr

    st, setup_rec = driver.setup(ctx)
    harness.sync(ctx.device)
    on_card = ctx.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    calls, dtrace = [], None
    t_win = time.perf_counter()
    setup_s = t_win - T0
    k = 0
    while True:
        if trace and k == 0:
            rec, dtrace = tr.traced_call(lambda mark: driver.call(st, 0, mark))
            rec.traced = True
        else:
            rec = driver.call(st, k)
        calls.append(rec)
        k += 1
        elapsed = time.perf_counter() - t_win
        if elapsed >= seconds and (not trace or len(calls) > 1):
            break
    window_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run = harness.Run(config=ctx.config, calls=calls, setup=setup_rec, setup_s=setup_s,
                      window_s=elapsed, window_peak_bytes=window_peak,
                      peak_bytes=max(setup_peak, window_peak), trace=dtrace)
    return st, run


def result(ctx, driver, st, run, trace: bool, control: bool):
    """The result object (``checks`` last) and the lines for standard error."""
    import numpy as np
    import torch

    from benchmark import harness
    from benchmark import trace as tr
    from benchmark.reference.precision import tf32

    metrics = {}
    # --trace 0 reports the cell's end-to-end metrics, --trace 1 its
    # per-layer ones; each from its reader, metrics/<name>.py
    for spec in ctx.manifest["per_layer" if trace else "end_to_end"]:
        if ctx.name not in spec.get("workloads", [ctx.name]):
            continue
        value = harness.load_module("metrics", spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    attempted = sum(c.shapes["rows"] for c in run.calls)
    failed = sum(1 for c in run.calls for w in c.outputs["wavs"]
                 if len(w) == 0 or not bool(np.isfinite(w).all()))
    driver.release(st)
    t = time.perf_counter()
    with tf32(False):
        readings = driver.verify(st, run.calls, control)
    print(f"benchmark: window {run.window_s:.3f} s, {len(run.calls)} calls (wall s, audio s: "
          f"{[(round(c.wall_s, 3), round(c.audio_s, 2)) for c in run.calls]}); set-up "
          f"{run.setup_s:.3f} s; the check took {time.perf_counter() - t:.3f} s",
          file=sys.stderr, flush=True)
    limits = ctx.spec["limits"]
    ctl = {k[: -len(".control")]: v for k, v in readings.items() if k.endswith(".control")}
    readings = {k: v for k, v in readings.items() if not k.endswith(".control")}
    checks = harness.judge(readings, limits)
    device = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
              "kind": torch.cuda.get_device_name(0) if ctx.device.type == "cuda" else "cpu",
              "count": ctx.chips, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": harness.within(checks), "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.wall_s
        out["breakdown"] = tr.breakdown(run.trace)
    lines = [f"reading {k}: {v!r} (not compared)" for k, v in sorted(readings.items())
             if k not in checks]
    if control:
        # the control judged as the program is: it has to come out not correct
        cc = harness.judge(ctl, limits)
        lines += [f"control {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in cc.items()]
        lines.append(f"control correct: {harness.within(cc)}")
        out["control"] = {"correct": harness.within(cc), "checks": _finite(cc)}
    lines += [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]
    out["checks"] = _finite(checks)
    return out, lines


def _finite(checks):
    """The checks for JSON: a NaN reading fails its check and is written
    as the string "nan"."""
    return {k: {n: (v if math.isfinite(v) else str(v)) for n, v in c.items()}
            for k, c in checks.items()}


def main(argv=None) -> int:
    args = parse(argv)
    for k in [k for k in os.environ if k.startswith("CHATTERBOX_")]:
        del os.environ[k]  # the configuration states every setting the program reads
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    import torch

    # one process, few threads: the host's dispatch of T3's steps is the
    # pace of the TTS cells, and idle CPU workers only contend with it
    torch.set_num_threads(2)

    from benchmark import harness

    c = harness.cell(args.workload)
    chips = int(c["entry"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    _host_lines(torch)
    ctx = SimpleNamespace(name=args.workload, config=c["config"], spec=c["spec"],
                          traffic=c["spec"]["traffic"], manifest=c["manifest"],
                          seed=args.seed % (1 << 63), device=torch.device("cuda"), chips=chips)
    driver = harness.load_module("drivers", c["spec"]["driver"])
    st, run = measure(ctx, driver, args.seconds, bool(args.trace))
    return finish(ctx, driver, st, run, bool(args.trace), bool(args.control))


def finish(ctx, driver, st, run, trace: bool, control: bool) -> int:
    out, lines = result(ctx, driver, st, run, trace, control)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded {', '.join(bad)}, which nothing the benchmark runs may load",
              file=sys.stderr)
        return 4
    for ln in lines:
        print(ln, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out, default=str), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
