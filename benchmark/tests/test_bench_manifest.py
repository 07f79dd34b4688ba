"""BENCHMARK.json and the files it names: its required shape, names and
units, every cell's files, and a cell, configuration and metric added as
new files only."""

import json
import re
import shutil

import pytest

from benchmark import harness

M = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= len(M["paths"]) <= 16 and M["paths"] == ["benchmark"]
    assert len(M["command"]) <= 32 and not any(w.startswith("/") or ".." in w
                                               for w in M["command"])
    assert 1 <= M["run_seconds"] <= 51
    cells = len(M["workloads"])
    # a regression check of 24 cells at this length must fit in 43200 s
    assert (2 + 14 * 24) * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len(json.dumps(M)) < 64 * 1024


def test_entries_have_only_the_required_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for e in M["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for p in M["per_layer"]:
        assert set(p) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert p["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_lines():
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in M[k]]
    assert len(names) == len(set(names))
    for n in names + [w["config"] for w in M["workloads"]] + [w["traffic"] for w in M["workloads"]]:
        assert NAME.match(n), n
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for text in ([w["why"] for w in M["workloads"]] + [c["why"] for c in M["configs"]]
                 + [c["source"] for c in M["configs"]] + [p["layer"] for p in M["per_layer"]]
                 + M["command"]):
        assert LINE.match(text), text
    assert {(w["config"], w["traffic"]) for w in M["workloads"]}.__len__() == len(M["workloads"])


def test_every_end_to_end_metric_has_a_reader():
    for e in M["end_to_end"]:
        assert harness.load_module("metrics", e["name"]).read


def test_setup_and_one_more_end_to_end_metric_in_every_cell():
    for w in M["workloads"]:
        e2e = [e["name"] for e in M["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = [p for p in M["per_layer"] if w["name"] in p.get("workloads", [w["name"]])]
        assert layer


def test_each_per_layer_metric_moves_what_its_cells_report():
    e2e = {e["name"]: e for e in M["end_to_end"]}
    for p in M["per_layer"]:
        moved = e2e[p["moves"]]
        for cell in p.get("workloads", [w["name"] for w in M["workloads"]]):
            assert cell in moved.get("workloads", [cell]), (p["name"], cell)
        assert harness.load_module("metrics", p["name"]).read
        if "roofline" in p["name"] or "mfu" in p["name"]:
            assert p["unit"] == "%"


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files(w):
    c = harness.cell(w["name"])
    spec, config = c["spec"], c["config"]
    assert spec["name"] == w["name"] and spec["config"] == w["config"]
    assert spec["chips"] == w["chips"] and spec["why"] == w["why"]
    assert spec["traffic"]["name"] == w["traffic"]
    assert (harness.BENCH_DIR / "drivers" / f"{spec['driver']}.py").exists()
    assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
    conf = next(x for x in M["configs"] if x["name"] == w["config"])
    assert config["name"] == conf["name"] and config["reduced"] == conf["reduced"] == []


def test_configs_have_files_under_paths_of_their_own():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("benchmark/configs/") and (harness.ROOT / f).exists()
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}


def test_an_added_cell_config_and_metric_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    m = json.loads(json.dumps(M))
    conf = json.loads((harness.ROOT / M["configs"][0]["file"]).read_text())
    conf["name"] = "added-config"
    (root / "benchmark/configs/added-config.json").write_text(json.dumps(conf))
    m["configs"].append({"name": "added-config", "source": "https://example.org/model",
                         "file": "benchmark/configs/added-config.json", "reduced": [],
                         "why": "an added configuration"})
    cell = json.loads((harness.BENCH_DIR / "workloads" / f"{M['workloads'][0]['name']}.json")
                      .read_text())
    cell.update(name="added-cell", config="added-config")
    cell["traffic"]["name"] = "added-mix"
    (root / "benchmark/workloads/added-cell.json").write_text(json.dumps(cell))
    m["workloads"].append({"name": "added-cell", "config": "added-config",
                           "traffic": "added-mix", "chips": 1, "why": "an added cell"})
    (root / "benchmark/metrics/added_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    m["per_layer"].append({"name": "added_metric", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "device",
                           "moves": "audio_s_per_s", "workloads": ["added-cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    c = harness.cell("added-cell", root)
    assert c["config"]["name"] == "added-config" and c["spec"]["traffic"]["name"] == "added-mix"
    assert harness.load_module("metrics", "added_metric", root / "benchmark").read(None) == 42.0
    # a variant of it for other cells needs no file of its own
    assert harness.load_module("metrics", "added_metric.other", root / "benchmark").read(None) \
        == 42.0
    assert harness.load_module("drivers", c["spec"]["driver"], root / "benchmark")
