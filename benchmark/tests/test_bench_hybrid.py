"""The Granite cell (``tts-granite4h-b64-t250``) and its files: the
configuration against the published config's numbers, the cell and its
metrics in ``BENCHMARK.json``, the imports of its driver and reference,
``counts_hybrid`` against hand-counted bytes and operations, the driver's
backbone weights against their rules, a tiny CPU rehearsal of
``tts_hybrid`` through the readers, and a planted fault (a decode step
that leaves the Mamba layers' recurrent state unchanged) that the check
must catch, on the CPU at a tiny size and on the card at the cell's. No
number here is a device number."""

import json
import math
import os
import subprocess
import sys

import pytest
import torch

from benchmark import counts_hybrid as ch
from benchmark import harness

CELL, CONFIG = "tts-granite4h-b64-t250", "chatterbox-tts-granite4h-micro"
NEW_METRICS = ("ssm_update_roofline", "k1a_gqa_roofline", "ssm_update_ms_per_step",
               "ssm_state_gib")
ROOT = str(harness.ROOT)


def test_the_config_holds_the_published_widths_uncut():
    c = harness.cell(CELL)
    cfg, entry = c["config"], next(x for x in c["manifest"]["configs"] if x["name"] == CONFIG)
    assert entry["reduced"] == [] and cfg["reduced"] == []
    assert entry["source"] == cfg["source"].rstrip() and "granite-4.0-h-micro" in entry["source"]
    g = ch.granite(cfg)
    assert (g["hidden_size"], g["num_hidden_layers"], g["intermediate_size"]) == (2048, 40, 8192)
    attn = [i for i, t in enumerate(g["layer_types"]) if t == "attention"]
    assert attn == [5, 15, 25, 35] and ch.n_layers(g, "mamba") == 36
    assert (g["num_attention_heads"], g["num_key_value_heads"]) == (32, 8)
    assert (g["mamba_n_heads"], g["mamba_d_head"], g["mamba_d_state"], g["mamba_d_conv"]) == \
        (64, 64, 128, 4)
    assert (g["attention_multiplier"], g["embedding_multiplier"], g["residual_multiplier"],
            g["logits_scaling"]) == (0.015625, 12, 0.22, 8)
    assert cfg["vocab_size"] == 100352 and cfg["num_local_experts"] == 0
    assert cfg["dtypes"]["t3"] == "bfloat16"


def test_the_cell_and_its_metrics_parse():
    c = harness.cell(CELL)
    m = c["manifest"]
    assert c["entry"]["chips"] == 1 and c["entry"]["config"] == CONFIG
    assert c["spec"]["driver"] == "tts_hybrid"
    assert set(c["spec"]["limits"]) == {"cond_err", "cond_tok_err", "t3_draw_gap",
                                        "wav_spec_err", "wav_band_err"}
    a = harness.cell("tts-b64-t250")["spec"]["traffic"]
    assert c["spec"]["traffic"] == a  # A's traffic: the cells differ in T3's backbone only
    names = {p["name"]: p for p in m["per_layer"]}
    for n in NEW_METRICS:
        assert names[n]["workloads"] == [CELL] and names[n]["moves"] == "audio_s_per_s"
    for n in ("mfu", "t3_ms_per_step", "device_idle_share", "peak_mem_gib",
              "t3_launches_per_step", "s3gen_ms_per_audio_s", "k3_roofline", "cond_prepare_s"):
        assert names[n]["workloads"][-1] == CELL
    assert CELL not in names["k1a_roofline"]["workloads"]
    assert next(e for e in m["end_to_end"] if e["name"] == "audio_s_per_s")["workloads"][-1] == CELL


def _loaded_after(code: str):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"PYTHONPATH": ROOT, "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_driver_and_the_reference_load_no_jax():
    jax = {"jax", "jaxlib", "flax", "chatterbox_tpu"}
    driver = _loaded_after("import benchmark.harness as h\nh.load_module('drivers', 'tts_hybrid')\n"
                           "import chatterbox_tpu_torch.models.t3.granite_hybrid\n" +
                           "".join(f"h.load_module('metrics', {n!r})\n" for n in NEW_METRICS))
    assert not driver & jax
    ref = _loaded_after("import benchmark.reference.granite_hybrid, benchmark.counts_hybrid")
    assert not ref & (jax | {"chatterbox_tpu_torch"})


def test_counts_by_hand_at_small_shapes():
    g = {"hidden_size": 8, "intermediate_size": 16, "num_hidden_layers": 3,
         "layer_types": ("mamba", "attention", "mamba"), "num_attention_heads": 2,
         "num_key_value_heads": 1, "mamba_n_heads": 2, "mamba_d_head": 4, "mamba_d_state": 4,
         "mamba_n_groups": 1, "mamba_d_conv": 4}
    # d_inner 8, conv_dim 16: a row's state 2 * 4 * 4 fp32 read and written (256 B), conv
    # inputs 16 * 3 bf16 read and written (192 B), xBC and dt read (36 B), y written (32 B);
    # the conv weights and bias (16 * 5 fp32) and three head vectors (2 fp32 each)
    n_bytes, flops = ch.ssm_update_launch(3, g)
    assert n_bytes == 3 * (256 + 192 + 36 + 32) + 320 + 24
    assert flops == 3 * (5 * 32 + 9 * 16)
    # K1a, 2 query heads on 1 KV head of 4: rows with prefixes 5 and 7, gap_end 9, write_pos 12
    # -> live 8 + 10; K and V of the KV head (2 * 18 * 4 * 2 B), q and out (2 * 2 rows * 2
    # heads * 8 B), k_new and v_new (2 * 2 * 8 B), row prefixes (8 B)
    n_bytes, flops = ch.k1a_gqa_step([5, 7], 9, 12, 2, 1, 4)
    assert n_bytes == 2 * 18 * 4 * 2 + 2 * 2 * 2 * 8 + 2 * 2 * 8 + 8
    assert flops == 4 * (18 + 2) * 2 * 4
    # one token: Mamba in_proj 8 x (8 + 16 + 2), out_proj 8 x 8, recurrence 2 * 2 * 4 * 4;
    # attention q/k/v/o 8 x (8 + 4 + 4) + 8 x 8; the MLP 3 x 8 x 16 in each of 3 layers
    want = 2 * (2 * 8 * 26 + 2 * 8 * 8 + 4 * 32) + (2 * 8 * 16 + 2 * 8 * 8) + 3 * 2 * 3 * 8 * 16
    assert ch.token_flops(g) == want
    assert len(ch.ssm_update_call_bounds(4, 10, g)) == 9 * 2
    assert len(ch.k1a_gqa_call_bounds([5, 7], 32, 10, g)) == 9


def test_the_published_update_bound():
    """At the cell's 128 CFG rows a launch moves ~537 MB: 0.16 ms at the
    card's 3.35 TB/s, 5.8 ms over the 36 Mamba layers of a step."""
    g = ch.granite(harness.cell(CELL)["config"])
    n_bytes, flops = ch.ssm_update_launch(128, g)
    assert n_bytes == pytest.approx(128 * 2 * 64 * 64 * 128 * 4, rel=0.02)
    assert 36 * ch.bound_s(n_bytes, flops) == pytest.approx(5.8e-3, rel=0.03)


@pytest.fixture(scope="module")
def tiny():
    from benchmark.tests.tiny import run_tiny

    torch.set_num_threads(2)
    return run_tiny(CELL, 2147483659, control=True)


def test_a_tiny_rehearsal_runs_through_the_readers(tiny):
    out, lines, run = tiny
    assert out["correct"] is True and out["device"]["platform"] == "cpu"
    assert set(out["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert "control" in out and all(math.isfinite(float(c["value"]))
                                    for c in out["checks"].values())
    m = harness.manifest()
    for p in m["per_layer"]:
        if CELL not in p.get("workloads", [CELL]):
            continue
        v = harness.load_module("metrics", p["name"]).read(run)
        if p["source"] == "device_trace" or p["name"] == "peak_mem_gib":
            assert v is None, p["name"]  # nothing on the CPU to read
        else:
            assert v is not None and v > 0, p["name"]
    # the counter is the carry's state: 2 Mamba layers of 3 texts' 6 CFG rows off the card
    state = 2 * 6 * (2 * 64 * 128 * 4 + (128 + 256) * 3 * 4)
    assert harness.load_module("metrics", "ssm_state_gib").read(run) * 2 ** 30 == state


def test_the_backbone_weights_follow_the_benchmarks_rules():
    """``granite_weights`` at a small stack: linears N(0, 1 / Cin) layer by
    layer, norm scales around 1, and the Mamba vectors by Mamba-2's
    published initialisation (A in [1, 16], dt in [1e-3, 0.1], D = 1)."""
    from benchmark.drivers import tts_hybrid as th
    from chatterbox_tpu_torch import weights
    from chatterbox_tpu_torch.models.t3 import granite_hybrid as gh
    from chatterbox_tpu_torch.models.t3.t3 import GraniteT3Config

    cfg = gh.GraniteHybridConfig(hidden_size=256, intermediate_size=512, num_hidden_layers=3,
                                 layer_types=("mamba", "attention", "mamba"),
                                 num_attention_heads=4, num_key_value_heads=2, mamba_n_heads=8,
                                 mamba_d_head=32, mamba_d_state=16)
    meta = weights.init_t3(GraniteT3Config(granite=cfg), 0, torch.device("meta"),
                           torch.float32)["granite"]
    w = th.granite_weights(meta, torch.float32, 2147483659, torch.device("cpu"))
    for (path, t), (_, m) in zip(_leaves(w), _leaves(meta)):
        assert t.shape == m.shape and t.device.type == "cpu", path
    up = w["layers"]["gate_up"]["w"]
    assert up.shape == (3, 1024, 256)
    for i in range(3):  # each layer drawn apart, at 1 / sqrt(Cin)
        assert float(up[i].std()) == pytest.approx(256 ** -0.5, rel=0.02)
    assert not torch.equal(up[0], up[1])
    assert float(w["layers"]["down"]["w"].std()) == pytest.approx(512 ** -0.5, rel=0.02)
    scale = w["layers"]["input_ln"]["scale"]
    assert bool((scale > 0).all()) and float(scale.mean()) == pytest.approx(1.0, abs=0.02)
    m = w["mamba"]
    a = torch.exp(m["A_log"])
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert m["A_log"].shape == (2, 8) and bool(((a >= 1) & (a <= 16)).all())
    assert bool(((dt >= 1e-3 * (1 - 1e-5)) & (dt <= 0.1 * (1 + 1e-5))).all())
    assert torch.equal(m["D"], torch.ones(2, 8))
    again = th.granite_weights(meta, torch.float32, 2147483659, torch.device("cpu"))
    assert torch.equal(again["mamba"]["in_proj"]["w"], m["in_proj"]["w"])


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


# the fault: each Mamba layer's decode update runs on a copy of its state,
# so the carry's recurrent state stays as the prefill left it (the conv
# inputs still advance); the copy is one buffer, made at the first (eager)
# step, so that the captured step replays it
STATE_UNCHANGED = """
import torch
from chatterbox_tpu_torch.models.t3 import granite_hybrid as _gh

_update, _spare = _gh.ssm_decode_update, {}


def _frozen(conv_state, ssm_state, layer, *rest):
    buf = _spare.get(ssm_state.shape)
    if buf is None:
        buf = _spare[ssm_state.shape] = torch.empty_like(ssm_state[:1])
    buf.copy_(ssm_state[layer:layer + 1])
    return _update(conv_state[layer:layer + 1], buf, 0, *rest)


_gh.ssm_decode_update = _frozen
"""


def test_tiny_rehearsal_reads_the_state_only_control(tiny):
    """The control run also reads the fp32 reference with only its
    recurrent state in bf16, beside the checks and not compared."""
    out, lines, _ = tiny
    ln = [x for x in lines if x.startswith("reading t3_draw_gap.control_state_bf16:")]
    assert len(ln) == 1 and math.isfinite(float(ln[0].split(": ")[1].split()[0]))
    assert "t3_draw_gap.control_state_bf16" not in out["checks"]


def test_state_unchanged_moves_the_draw_gap(monkeypatch):
    """At the tiny widths, fp32 on both sides, the sound run reads a draw
    gap of exactly 0 and the fault moves it off 0. (Three layers there:
    the embeddings, scaled by 12, carry most of the residual, and the fault
    stays within the cell's limit, which is set for the card; the card test
    below holds the fault to that limit at the cell's size.)"""
    from benchmark.tests.tiny import run_tiny
    from chatterbox_tpu_torch.models.t3 import granite_hybrid as gh

    torch.set_num_threads(2)
    sound = run_tiny(CELL, 2147483659, texts=4, tokens=40)[0]
    assert sound["checks"]["t3_draw_gap"]["value"] == 0.0 and sound["correct"] is True
    # the original is put back after the test; the plant replaces it
    monkeypatch.setattr(gh, "ssm_decode_update", gh.ssm_decode_update)
    exec(STATE_UNCHANGED, {})
    assert gh.ssm_decode_update.__name__ == "_frozen"
    out = run_tiny(CELL, 2147483659, texts=4, tokens=40)[0]
    assert out["checks"]["t3_draw_gap"]["value"] > 0.0


@pytest.mark.cuda
def test_state_unchanged_fails_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the fault runs at the cell's own size")
    code = STATE_UNCHANGED + (
        "import sys\nfrom benchmark import run\n"
        f"sys.exit(run.main(['--workload', {CELL!r}, '--seed', '2147483781', '--seconds', '1',"
        " '--trace', '0']))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    print("\n".join(out.stderr.splitlines()[-8:]))
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["checks"]["t3_draw_gap"]["value"] > result["checks"]["t3_draw_gap"]["limit"]
    assert result["correct"] is False
