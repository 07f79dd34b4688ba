"""A tiny configuration of each cell for the CPU: the cell's own files with
every width cut, fp32 throughout, few texts and tokens, and a run driven
through ``benchmark.run``'s own set-up, window, readers and check with the
card's look skipped."""

import copy
import json
from types import SimpleNamespace

import torch

from benchmark import harness

TINY = {
    "t3": {"llama": {"hidden_size": 64, "intermediate_size": 128, "num_hidden_layers": 2,
                     "num_attention_heads": 2, "num_key_value_heads": 2, "head_dim": 32}},
    "s3gen": {"flow": {"input_size": 128,
                       "encoder": {"input_size": 128, "output_size": 128, "attention_heads": 4,
                                   "linear_units": 256, "num_blocks": 2, "num_up_blocks": 1},
                       "estimator": {"channels": 64, "n_blocks": 1, "num_mid_blocks": 2,
                                     "num_heads": 4}},
              "hift": {"base_channels": 32, "f0_cond_channels": 32},
              "campplus": {"growth_rate": 8, "bn_size": 2, "init_channels": 32, "m_channels": 8,
                           "block_layers": [1, 1, 1]},
              "tokenizer": {"n_state": 64, "n_head": 4, "n_layer": 2}},
    "voice_encoder": {"hidden_size": 32, "num_layers": 2},
}


def _merge(base, over):
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def tiny_cell(name: str, texts: int = 3, tokens: int = 12, sources=(0.6, 1.2),
              check_rows: int = None):
    """The cell's files, cut to a CPU's size (the cell's own sample of
    checked requests unless ``check_rows`` is given)."""
    c = harness.cell(name)
    config = _merge(copy.deepcopy(c["config"]), {k: v for k, v in TINY.items() if k in c["config"]})
    config["dtypes"] = {k: "float32" for k in config["dtypes"]}
    spec = copy.deepcopy(c["spec"])
    t = spec["traffic"]
    t["voice_seconds"] = 2.0
    if "texts_per_call" in t:
        t.update(texts_per_call=texts, max_new_tokens=tokens)
    else:
        t["source_seconds"] = list(sources)
    if check_rows is not None:
        spec["check_rows"] = check_rows
    return c, config, spec


def context(name: str, seed: int, **kw):
    c, config, spec = tiny_cell(name, **kw)
    return SimpleNamespace(name=name, config=config, spec=spec, traffic=spec["traffic"],
                           manifest=c["manifest"], seed=seed, device=torch.device("cpu"),
                           chips=1)


def dumps(obj) -> str:
    return json.dumps(obj, default=str)


def run_tiny(name: str, seed: int, control: bool = False, **kw):
    """One run of a tiny cell on the CPU through the benchmark's own set-up,
    window (two calls), readers, reference check and result line.
    Returns (result, stderr lines, Run)."""
    from benchmark import run as br

    ctx = context(name, seed, **kw)
    driver = harness.load_module("drivers", ctx.spec["driver"])
    st, r = br.measure(ctx, driver, 0.0, False)
    if len(r.calls) < 2:  # a second call, so that the check samples across calls
        r.calls.append(driver.call(st, 1))
    out, lines = br.result(ctx, driver, st, r, False, control)
    return out, lines, r
