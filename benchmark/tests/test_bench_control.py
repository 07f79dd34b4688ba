"""The control: the plain reference put in the program's place one
precision step below the configuration's (T3's projections and the flow's
weights fp8, the vocoder's trunk bf16, the conditioning modules in TF32),
judged by ``harness.judge`` and ``harness.within`` against the cell's
limits as the program is, must come out as not correct. On the CPU at a
tiny size (where TF32 does not exist, so the conditionals cannot
separate); on the card at the cell's own size, through ``benchmark.run
--control 1``."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from benchmark.tests.tiny import run_tiny

torch.set_num_threads(2)
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def _readings(lines):
    """{name: value} of the ``reading``, ``control`` and ``check`` lines."""
    out = {}
    for ln in lines:
        kind, _, rest = ln.partition(" ")
        name, _, value = rest.partition(": ")
        if kind in ("reading", "check") or (kind == "control" and name != "correct"):
            out[name if kind != "control" else f"{name}.control"] = float(value.split()[0])
    return out


def _control_correct(readings: dict, limits: dict) -> bool:
    ctl = {k: readings[f"{k}.control"] for k in limits}
    return harness.within(harness.judge(ctl, limits))


@pytest.mark.parametrize("cell", ["tts-b64-t250", "vc-b16-s3to12"])
def test_control_fails_where_the_program_passes_on_the_cpu(cell):
    out, lines, _ = run_tiny(cell, 2147483659, control=True)
    readings = _readings(lines)
    limits = harness.cell(cell)["spec"]["limits"]
    for k in ("wav_spec_err", "wav_band_err"):
        assert readings[f"{k}.control"] > readings[k]
    assert out["correct"] is True
    assert out["control"]["correct"] is False
    assert _control_correct(readings, limits) is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cells_size_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")
    root = str(harness.ROOT)
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", "2147483777", "--seconds", "1", "--trace", "0",
                          "--control", "1"], cwd=root, env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    print("\n".join(out.stderr.splitlines()[-16:]))
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["control"]["correct"] is False
    assert _control_correct(_readings(out.stderr.splitlines()),
                            harness.cell(cell)["spec"]["limits"]) is False
