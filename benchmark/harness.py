"""What ties the benchmark's data files together: ``BENCHMARK.json``, the
configuration, cell, driver and metric files found by name, the run record
that the metric readers read, and the judgement of the checks.

Nothing here imports the program; the drivers do.
"""

import dataclasses
import importlib.util
import json
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(name: str, root: Path = ROOT) -> dict:
    """A cell by name: its ``BENCHMARK.json`` entry, its own file
    (``workloads/<name>.json``) and its configuration's file."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in m["configs"] if c["name"] == entry["config"])
    spec = json.loads((root / BENCH_DIR.name / "workloads" / f"{name}.json").read_text())
    config = json.loads((root / conf["file"]).read_text())
    return {"entry": entry, "spec": spec, "config": config, "manifest": m}


def load_module(kind: str, name: str, base: Path = BENCH_DIR):
    """``<kind>/<name>.py`` of the benchmark's folder, imported by path (a
    name may hold dots and dashes). A name ``<base>.<variant>`` without a
    file of its own takes ``<base>.py``: the same quantity in other cells,
    where it moves another end-to-end metric (``mfu.vc`` is ``mfu``)."""
    path = base / kind / f"{name}.py"
    if not path.exists() and "." in name:
        path = base / kind / f"{name.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(cls, values: dict):
    """A (frozen) dataclass from a JSON object: nested dataclass fields from
    nested objects, tuple fields from lists; keys the class lacks are
    ignored, fields the object lacks keep their defaults."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v, t = values[f.name], hints[f.name]
        if dataclasses.is_dataclass(t):
            v = build(t, v)
        elif isinstance(v, list):
            v = _tuples(v)
        kw[f.name] = v
    return cls(**kw)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


@dataclass
class Call:
    """One timed call: host seconds, audio, and what the metric readers and
    the check need of it."""

    k: int
    wall_s: float
    audio_s: float
    seed: int
    stages: Dict[str, float] = field(default_factory=dict)  # t3_s, t3_steps, s3gen_s, vc_s
    shapes: Dict[str, object] = field(default_factory=dict)  # per-row lengths, buckets
    flops: float = 0.0  # the model FLOPs the call's inputs need
    outputs: Optional[dict] = None  # served tokens and waveforms, for the check
    traced: bool = False


@dataclass
class Run:
    """What a run measured, as the metric readers see it."""

    config: dict
    calls: List[Call]
    setup: Dict[str, float]  # set-up's own readings (cond_prepare_s)
    setup_s: float  # process start to the window
    window_s: float  # the window's wall seconds: its whole calls
    window_peak_bytes: int  # the allocator's peak over the window
    peak_bytes: int  # the allocator's peak over set-up and the window
    trace: object = None  # the traced call's DeviceTrace, with --trace 1

    def host_calls(self) -> List[Call]:
        """The window's calls that the profiler did not cover."""
        return [c for c in self.calls if not c.traced]

    def traced_call(self) -> Optional[Call]:
        return next((c for c in self.calls if c.traced), None)


def sync(device):
    """Wait for the device's queued work (a no-op off the card)."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each compared number beside its limit; a number is within it when it
    is at most the limit (NaN never is)."""
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def within(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
