"""A CPU rehearsal of each driver at a tiny configuration: set-up, the
window, the readers, the reference check and the result line, with the
card's look skipped. It checks the plumbing only; no number it reads is a
device number."""

import math

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import run_tiny

torch.set_num_threads(2)
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture(scope="module", params=CELLS)
def tiny(request):
    return request.param, run_tiny(request.param, 2147483659)


def test_result_line_has_the_required_keys(tiny):
    name, (out, lines, run) = tiny
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] == sum(c.shapes["rows"] for c in run.calls) and out["failed"] == 0
    m = harness.manifest()
    want = {e["name"] for e in m["end_to_end"] if name in e.get("workloads", [name])}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"  # never a device number
    spec = harness.cell(name)["spec"]
    assert set(out["checks"]) == set(spec["limits"])
    assert [ln.split(":")[0] for ln in lines[-len(spec["limits"]):]] == \
        [f"check {k}" for k in spec["limits"]]


def test_readings_are_finite_and_the_call_records_full(tiny):
    name, (out, _, run) = tiny
    for c in out["checks"].values():
        assert isinstance(c["value"], float) and math.isfinite(c["value"])
    for c in run.calls:
        assert c.wall_s > 0 and c.audio_s > 0 and c.flops > 0
        assert len(c.outputs["wavs"]) == c.shapes["rows"]
    if "texts" in run.calls[0].outputs:  # T3's tokens, each of a call's rows
        assert all(c.outputs["raw"].shape[0] == c.shapes["rows"] for c in run.calls)


def test_per_layer_readers_on_host_numbers(tiny):
    name, (_, _, run) = tiny
    m = harness.manifest()
    for p in m["per_layer"]:
        if name not in p.get("workloads", [name]):
            continue
        v = harness.load_module("metrics", p["name"]).read(run)
        # the trace readers find nothing on the CPU and report nothing
        if p["source"] == "device_trace" or p["name"].startswith("peak_mem_gib"):
            assert v is None
        else:
            assert v is not None and v > 0, p["name"]
