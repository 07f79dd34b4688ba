"""tts_hybrid: ``tts_batch``'s calls (one client's back-to-back
``ChatterboxTTS.generate_batch``, a batch of texts in one voice) with T3 on
the Granite 4.0-H backbone (``GraniteT3Config``).

The configuration's top-level keys are the published ``config.json``'s;
the backbone's widths come from them (``counts_hybrid.granite``). Off the
card, where the benchmark runs only as the tests' CPU rehearsal
(``run.py`` exits without a card), the backbone takes ``CPU_WIDTHS`` in
their place, as the other parts take the rehearsal's tiny widths.

Set-up builds the weights from the seed, every part by the benchmark's own
rules and none by the program's initialisation: the backbone layer by layer
(``granite_weights``: ``synth.make_weights`` on each layer's leaves, the
Mamba vectors ``A_log``, ``dt_bias`` and ``D`` by Mamba-2's published
initialisation), every other part as ``tts_batch`` makes it. The program's
``init_t3`` runs only on the meta device, for the leaves' names and shapes.
The pipeline, the voice's conditionals (``cond_prepare_s``), the runtime
layout and the warm call are ``tts_batch``'s. The traced call (and every
call off the card) records the program's spans and counters
(``runtime/profiling``), which ``ssm_state_gib`` reads.

The check is ``tts_batch``'s readings (``cond_err``, ``cond_tok_err``,
``t3_draw_gap``, ``wav_spec_err``, ``wav_band_err``), with T3's logits from
the plain reference ``reference/granite_hybrid.py``; the control rounds
the backbone's weights to fp8 (served bf16) and holds its recurrent state
in bf16, one step below the configuration's fp32. Beside it, a reading that
is not compared (``t3_draw_gap.control_state_bf16``): the fp32 reference
with only its recurrent state held in bf16.
"""

import dataclasses
import math
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, counts, counts_hybrid, harness, program, synth
from benchmark.drivers import tts_batch as tb
from benchmark.reference import pipeline as rp
from benchmark.reference import t3 as rt3
from benchmark.reference.granite_hybrid import GraniteConfig
from benchmark.reference.granite_hybrid import T3Config as RefT3Config
from benchmark.reference.granite_hybrid import cond_prefix, t3_step_logits
from benchmark.reference.layers import cast_tree
from benchmark.reference.precision import lowered
from benchmark.traffic import Traffic

# the backbone off the card: every kind of layer, the published head sizes
CPU_WIDTHS = {"hidden_size": 128, "intermediate_size": 192, "num_hidden_layers": 3,
              "layer_types": ("mamba", "attention", "mamba"), "num_attention_heads": 2,
              "num_key_value_heads": 1, "mamba_n_heads": 2, "mamba_chunk_size": 16}


def backbone(ctx) -> dict:
    """The backbone's widths: the configuration's, or ``CPU_WIDTHS`` over
    them off the card."""
    g = counts_hybrid.granite(ctx.config)
    if ctx.device.type != "cuda":
        g.update(CPU_WIDTHS)
    return g


def t3_config(ctx):
    from chatterbox_tpu_torch.models.t3.t3 import GraniteT3Config

    return harness.build(GraniteT3Config, {**ctx.config["t3"], "granite": backbone(ctx)})


def _layer(tree, i):
    """Layer ``i`` of a tree of stacked meta leaves."""
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _depth(tree) -> int:
    """The number of layers in a stack: any leaf's leading dimension."""
    return _depth(next(iter(tree.values()))) if isinstance(tree, dict) else tree.shape[0]


def _put(dst, src, i):
    if isinstance(dst, dict):
        for k in dst:
            _put(dst[k], src[k], i)
    else:
        dst[i] = src


def _empty(tree, dtype, device):
    if isinstance(tree, dict):
        return {k: _empty(v, dtype, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=dtype, device=device)


def granite_weights(meta: dict, dtype, seed: int, device) -> dict:
    """The backbone's tree (the program's layouts, from ``meta``) made from
    ``seed`` on ``device``: each layer of each stack (``layers``, ``mamba``,
    ``attention``) drawn by ``synth.make_weights`` on its own leaves, so a
    linear (Cout, Cin) is N(0, 1 / Cin), on a seed of its own, and written
    into its stack, so that no more than one layer is drawn at a time; then
    the Mamba layers' vectors by Mamba-2's published initialisation
    (``mamba_ssm``'s ``Mamba2``): ``A_log = log(U(1, 16))``, ``dt_bias`` the
    inverse softplus of ``dt = exp(U(log 1e-3, log 0.1))`` (at least 1e-4)
    and ``D = 1``, one head each."""
    out, k = {}, 0
    for kind in ("layers", "mamba", "attention"):
        stack = meta[kind]
        out[kind] = _empty(stack, dtype, device)
        n = _depth(stack)
        for i in range(n):
            k += 1
            one = synth.make_weights({kind: _layer(stack, i)}, {kind: dtype},
                                     (seed + k) % (1 << 63), device)[kind]
            _put(out[kind], one, i)
            del one
    out["final_ln"] = synth.make_weights({"final_ln": meta["final_ln"]}, {"final_ln": dtype},
                                         seed, device)["final_ln"]
    m = out["mamba"]
    shape = tuple(m["A_log"].shape)  # (Mamba layers, heads)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    a = 1.0 + 15.0 * torch.rand(shape, generator=gen, device=device)
    dt = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3))
                   * torch.rand(shape, generator=gen, device=device)).clamp(min=1e-4)
    m["A_log"] = torch.log(a).to(dtype)
    m["dt_bias"] = (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    m["D"] = torch.ones(shape, dtype=dtype, device=device)
    return out


def make_weights(ctx, t3c) -> dict:
    """Every part the configuration's ``dtypes`` names, from the seed: the
    backbone by ``granite_weights``, the rest of T3 and the other parts by
    ``synth`` as ``tts_batch`` makes them."""
    from chatterbox_tpu_torch import weights as pw

    dts = {k: program.DTYPES[v] for k, v in ctx.config["dtypes"].items()}
    rest = {k: v for k, v in ctx.config.items() if k != "t3"}
    w = program.make_weights({**rest, "dtypes": {k: v for k, v in ctx.config["dtypes"].items()
                                                 if k != "t3"}}, ctx.seed, ctx.device)
    meta = pw.init_t3(t3c, 0, torch.device("meta"), dts["t3"])
    t3_rest = {k: v for k, v in meta.items() if k != "granite"}
    w["t3"] = synth.make_weights({"t3": t3_rest}, {"t3": dts["t3"]}, ctx.seed, ctx.device)["t3"]
    w["t3"]["granite"] = granite_weights(meta["granite"], dts["t3"], ctx.seed, ctx.device)
    return w


def setup(ctx):
    from chatterbox_tpu_torch.pipeline import tts as ptts
    from chatterbox_tpu_torch.runtime.precision import apply_tts_precision

    t3c = t3_config(ctx)
    cf = program.configs({k: ctx.config[k] for k in ("s3gen", "voice_encoder")})
    w = make_weights(ctx, t3c)
    # the speech head's rows past the speech tokens are zero, as in tts_batch
    w["t3"]["speech_head"]["w"][t3c.stop_speech_token - 1:] = 0
    tts = ptts.ChatterboxTTS(w["t3"], {k: w[k] for k in tb.S3GEN_PARTS}, ctx.device, t3_cfg=t3c,
                             s3gen_cfg=cf["s3gen"], ve_params=w["voice_encoder"],
                             ve_cfg=cf["voice_encoder"])
    traffic = Traffic(ctx.traffic, ctx.seed)
    voice = traffic.voice()
    harness.sync(ctx.device)
    t = time.perf_counter()
    conds = tts.prepare_conditionals(voice, exaggeration=ctx.traffic["exaggeration"])
    harness.sync(ctx.device)
    cond_s = time.perf_counter() - t
    apply_tts_precision(tts, dtype=program.DTYPES[ctx.config["dtypes"]["t3"]])
    raw = {}
    t3_generate = ptts.t3_generate

    def hooked(*a, **kw):
        res = t3_generate(*a, **kw)
        raw["last"] = res
        return res

    ptts.t3_generate = hooked
    st = SimpleNamespace(ctx=ctx, tts=tts, weights=w, voice=voice, conds=conds, traffic=traffic,
                         raw=raw, t3c=t3c, restore=lambda: setattr(ptts, "t3_generate", t3_generate))
    call(st, -1)
    harness.sync(ctx.device)
    return st, {"cond_prepare_s": cond_s}


def call(st, k: int, mark=None) -> harness.Call:
    from chatterbox_tpu_torch.runtime import profiling

    p = st.ctx.traffic
    if mark:
        mark("pack")
    inp = st.traffic.call(k)
    record = k >= 0 and (mark is not None or st.ctx.device.type != "cuda")
    if record:
        profiling.take()
        profiling.enable()
    t0 = time.perf_counter()
    if mark:
        mark("t3")
    try:
        wavs = st.tts.generate_batch(
            inp["texts"], seed=inp["seed"], max_new_tokens=p["max_new_tokens"],
            temperature=p["temperature"], cfg_weight=p["cfg_weight"], min_p=p["min_p"],
            top_p=p["top_p"], repetition_penalty=p["repetition_penalty"],
            exaggeration=p["exaggeration"])
    finally:
        if record:
            profiling.disable()
    wall = time.perf_counter() - t0
    lt = dict(st.tts.last_timings)
    if mark:
        mark("s3gen+readback", at=t0 + lt["t3_s"])
    res = st.raw.pop("last")
    clean = st.tts.last_speech_tokens
    text_lens = [len(rt3.text_ids(t, st.t3c)) for t in inp["texts"]]
    n_tok = [len(r) for r in clean]
    prompt = int(st.conds.gen.prompt_token_len.reshape(-1)[0])
    cfg = st.ctx.config
    flops = (counts_hybrid.t3_flops(text_lens, [int(x) for x in res.lengths.cpu()],
                                    backbone(st.ctx), cfg["t3"]["speech_tokens_dict_size"])
             + sum(counts.flow_flops(prompt, n, cfg["s3gen"]["flow"])
                   + counts.hift_flops(2 * n, cfg["s3gen"]["hift"]) for n in n_tok))
    outputs = {"texts": inp["texts"], "clean": clean, "wavs": wavs,
               "raw": res.tokens.cpu().numpy(), "raw_lens": res.lengths.cpu().numpy()}
    rec = harness.Call(
        k=k, wall_s=wall, audio_s=sum(len(x) for x in wavs) / rp.S3GEN_SR,
        seed=inp["seed"],
        stages={"t3_s": lt["t3_s"], "t3_steps": lt["t3_steps"], "s3gen_s": lt["s3gen_s"]},
        shapes={"text_lens": text_lens, "text_bucket": tb._bucket(max(text_lens)),
                "n_tokens": n_tok, "token_bucket": lt["token_bucket"],
                "kv_int8": lt["kv_cache"] == "int8", "prompt_tokens": prompt,
                "rows": len(wavs)},
        flops=flops, outputs=outputs)
    if record:
        rec.spans = profiling.take()
    return rec


release = tb.release


def _reference_t3(weights_t3, control: bool):
    """T3's tree as the reference takes it: fp32; the control's backbone
    weights rounded to fp8 and every leaf served in bf16."""
    if control:
        return lowered(weights_t3, "fp8", scope="granite")
    return cast_tree(weights_t3, torch.float32)


def _ref_t3_config(st):
    g = backbone(st.ctx)
    fields = {f.name for f in dataclasses.fields(GraniteConfig)}
    return harness.build(RefT3Config, {**st.ctx.config["t3"],
                                       "granite": {k: g[k] for k in fields}})


def _t3_logits(st, t3_tree, conds, text, tokens, state_dtype=None):
    t3c = _ref_t3_config(st)
    p = st.ctx.traffic
    dev = st.ctx.device
    emo = torch.full((1,), p["exaggeration"], device=dev)
    cond = cond_prefix(t3_tree, t3c, conds["speaker_emb"], conds["t3_prompt_tokens"], emo)
    ids = torch.tensor(rt3.text_ids(text, t3c), device=dev)
    tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    lg = t3_step_logits(t3_tree, t3c, cond, ids, tok, p["cfg_weight"], state_dtype=state_dtype)
    return rt3.repetition_penalized(lg, tok, t3c.start_speech_token, p["repetition_penalty"])


@torch.inference_mode()
def verify(st, calls, control: bool = False):
    """``tts_batch.verify``'s readings with T3's logits from the Granite
    reference; with ``control`` the control's beside them (``.control``)."""
    spec = st.ctx.spec
    others = tb.S3GEN_PARTS + ("voice_encoder",)
    ref = check.reference_trees(st.weights, others)
    ref["t3"] = _reference_t3(st.weights["t3"], False)
    rc = tb._reference_conds(st, ref, False)
    got = {"speaker_emb": st.conds.t3.speaker_emb, "t3_prompt_tokens": st.conds.t3.prompt_tokens,
           **st.conds.gen._asdict()}
    out = check.conditional_readings(got, rc)
    ctl = {}
    if control:
        lows = check.reference_trees(st.weights, others, True, tb.CONTROL_FORMATS)
        lows["t3"] = _reference_t3(st.weights["t3"], True)
        cc = tb._reference_conds(st, lows, True)
        ctl = check.conditional_readings(cc, rc)
    n_check = spec["check_rows"]
    p = st.ctx.traffic
    chain = (p["temperature"], p["min_p"], p["top_p"])
    pool = [(c, r) for c in calls for r in range(c.shapes["rows"])]
    draws, gaps, ctl_gaps, state_gaps = {}, [], [], []
    for c, r in check.sample_rows(st.ctx.seed, 0, pool, n_check,
                                  lambda cr: cr[0].outputs["raw_lens"][cr[1]]):
        n = min(int(c.outputs["raw_lens"][r]) + 1, c.outputs["raw"].shape[1])
        tokens = c.outputs["raw"][r, :n]
        text = c.outputs["texts"][r]
        if c.k not in draws:
            draws[c.k] = rp.t3_draws(c.seed, c.shapes["rows"], c.outputs["raw"].shape[1],
                                     st.ctx.device)
        u = draws[c.k][:n, r]
        want = rt3.sampling_distribution(_t3_logits(st, ref["t3"], rc, text, tokens), *chain)
        served = torch.from_numpy(tokens.astype(np.int64)).to(want.device)
        gaps.append(rt3.draw_distance(want, served, u))
        if control:
            low = rt3.sampling_distribution(
                _t3_logits(st, lows["t3"], cc, text, tokens, torch.bfloat16), *chain)
            ctl_gaps.append(rt3.draw_distance(want, rt3.inverse_cdf(low, u), u))
            low = rt3.sampling_distribution(
                _t3_logits(st, ref["t3"], rc, text, tokens, torch.bfloat16), *chain)
            state_gaps.append(rt3.draw_distance(want, rt3.inverse_cdf(low, u), u))
    out["t3_draw_gap"] = float(torch.cat(gaps).mean())
    out["t3_draw_gap.request"] = max(float(d.mean()) for d in gaps)
    out["t3_draw_gap.step"] = max(float(d.max()) for d in gaps)
    if control:
        ctl["t3_draw_gap"] = float(torch.cat(ctl_gaps).mean())
        out["t3_draw_gap.control_state_bf16"] = float(torch.cat(state_gaps).mean())
    reqs = [(c, r) for c in calls for r in range(c.shapes["rows"])
            if len(c.outputs["clean"][r]) > 1]
    for c, r in check.sample_rows(st.ctx.seed, 1, reqs, n_check,
                                  lambda cr: len(cr[0].outputs["clean"][cr[1]])):
        tokens = c.outputs["clean"][r]
        want = tb._synth(st, ref, rc, c, r, tokens)
        served = torch.from_numpy(c.outputs["wavs"][r]).to(want.device)
        check.merge_max(out, check.wav_readings(served, want))
        if control:
            low_wav = tb._synth(st, lows, cc, c, r, tokens, hift_dtype=torch.bfloat16)
            check.merge_max(ctl, check.wav_readings(low_wav, want))
    out.update({f"{k}.control": v for k, v in ctl.items()})
    return out
