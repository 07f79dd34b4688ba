"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program either: each checked in a fresh
process, by the whole top-level name of every loaded module. Without a
card the benchmark exits nonzero and prints no result."""

import ast
import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = str(harness.ROOT)
JAX = {"jax", "jaxlib", "flax", "chatterbox_tpu"}


def _loaded_after(code: str):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_drivers_and_readers_load_no_jax():
    m = harness.manifest()
    code = ["import benchmark.run, benchmark.harness as h"]
    for w in m["workloads"]:
        code.append(f"h.load_module('drivers', h.cell({w['name']!r})['spec']['driver'])")
    for p in m["per_layer"]:
        code.append(f"h.load_module('metrics', {p['name']!r})")
    # what the drivers' set-up imports of the program
    code.append("import chatterbox_tpu_torch.pipeline.tts, chatterbox_tpu_torch.pipeline.vc, "
                "chatterbox_tpu_torch.runtime.precision, chatterbox_tpu_torch.weights")
    assert not _loaded_after("\n".join(code)) & JAX


def test_the_reference_loads_neither_jax_nor_the_program():
    mods = [f[:-3] for f in os.listdir(os.path.join(ROOT, "benchmark", "reference"))
            if f.endswith(".py")]
    loaded = _loaded_after("\n".join(f"import benchmark.reference.{m}" for m in mods))
    assert not loaded & (JAX | {"chatterbox_tpu_torch"})


def test_the_reference_sources_import_only_torch_numpy_and_themselves():
    ref = os.path.join(ROOT, "benchmark", "reference")
    for f in os.listdir(ref):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ref, f)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] in {"torch", "numpy", "dataclasses", "contextlib",
                                           "functools", "math", "fractions", "typing", "re",
                                           "logging"}, (f, n)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    env = dict(os.environ, PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          harness.manifest()["workloads"][0]["name"], "--seed", "2147483659",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_run_without_the_program_exits_nonzero(tmp_path):
    """A checkout holding only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          harness.manifest()["workloads"][0]["name"], "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
