"""tts_batch: one client's back-to-back ``ChatterboxTTS.generate_batch``
calls, each a batch of texts in one voice.

Set-up builds the pipeline on the benchmark's weights, prepares the voice's
conditionals (timed: ``cond_prepare_s``), puts T3 in its runtime layout
(``apply_tts_precision``: fused q/k/v, bf16) and makes one warm call at the
cell's shapes. The check compares, after the window, the conditionals, T3's
sampled tokens (each against the reference's distribution at the step's
draw, made again from the call's seed) and the waveforms of a sample of
requests with the plain reference.
"""

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, counts, harness, program
from benchmark.reference import pipeline as rp
from benchmark.reference import t3 as rt3
from benchmark.traffic import Traffic

S3GEN_PARTS = ("flow", "hift", "campplus", "tokenizer")
# the control's precisions: one step below each part's (T3's projections
# and the flow's weights fp8 below bf16; the conditioning modules TF32 below
# fp32 with TF32 off; the vocoder's trunk in bf16, its phase-sensitive
# stages fp32, as the program's own CHATTERBOX_HIFT_BF16 path)
CONTROL_FORMATS = {"t3": "fp8", "flow": "fp8", "hift": "fp32", "campplus": "fp32",
                   "tokenizer": "fp32", "voice_encoder": "fp32"}


def setup(ctx):
    from chatterbox_tpu_torch.pipeline import tts as ptts
    from chatterbox_tpu_torch.runtime.precision import apply_tts_precision

    cf = program.configs(ctx.config)
    t3c, s3c, vec = cf["t3"], cf["s3gen"], cf["voice_encoder"]
    w = program.make_weights(ctx.config, ctx.seed, ctx.device)
    # the speech head's rows past the speech tokens (the start and stop
    # tokens and the unused ids, which the pipeline drops before S3Gen) are
    # zero, as a trained head seldom picks them: every request then runs to
    # its budget, and every call of every seed carries the same audio
    w["t3"]["speech_head"]["w"][t3c.stop_speech_token - 1:] = 0
    tts = ptts.ChatterboxTTS(w["t3"], {k: w[k] for k in S3GEN_PARTS}, ctx.device, t3_cfg=t3c,
                             s3gen_cfg=s3c, ve_params=w["voice_encoder"], ve_cfg=vec)
    traffic = Traffic(ctx.traffic, ctx.seed)
    voice = traffic.voice()
    harness.sync(ctx.device)
    t = time.perf_counter()
    conds = tts.prepare_conditionals(voice, exaggeration=ctx.traffic["exaggeration"])
    harness.sync(ctx.device)
    cond_s = time.perf_counter() - t
    apply_tts_precision(tts, dtype=program.DTYPES[ctx.config["dtypes"]["t3"]])
    # T3's raw tokens (with the ids above the speech vocabulary that the
    # pipeline drops before S3Gen), kept for the check: the hook holds the
    # returned tensors and adds no device work
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
    p = st.ctx.traffic
    if mark:
        mark("pack")
    inp = st.traffic.call(k)
    t0 = time.perf_counter()
    if mark:
        mark("t3")
    wavs = st.tts.generate_batch(
        inp["texts"], seed=inp["seed"], max_new_tokens=p["max_new_tokens"],
        temperature=p["temperature"], cfg_weight=p["cfg_weight"], min_p=p["min_p"],
        top_p=p["top_p"], repetition_penalty=p["repetition_penalty"],
        exaggeration=p["exaggeration"])
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
    flops = (counts.t3_flops(text_lens, [int(x) for x in res.lengths.cpu()],
                             cfg["t3"]["llama"], cfg["t3"]["speech_tokens_dict_size"])
             + sum(counts.flow_flops(prompt, n, cfg["s3gen"]["flow"])
                   + counts.hift_flops(2 * n, cfg["s3gen"]["hift"]) for n in n_tok))
    outputs = {"texts": inp["texts"], "clean": clean, "wavs": wavs,
               "raw": res.tokens.cpu().numpy(), "raw_lens": res.lengths.cpu().numpy()}
    return harness.Call(
        k=k, wall_s=wall, audio_s=sum(len(x) for x in wavs) / rp.S3GEN_SR,
        seed=inp["seed"],
        stages={"t3_s": lt["t3_s"], "t3_steps": lt["t3_steps"], "s3gen_s": lt["s3gen_s"]},
        shapes={"text_lens": text_lens, "text_bucket": _bucket(max(text_lens)),
                "n_tokens": n_tok, "token_bucket": lt["token_bucket"],
                "kv_int8": lt["kv_cache"] == "int8", "prompt_tokens": prompt,
                "rows": len(wavs)},
        flops=flops, outputs=outputs)


def _bucket(n: int) -> int:
    return next((b for b in (32, 64, 128, 256, 512) if n <= b), 512)


def release(st):
    """Free the program's state on the device before the reference runs."""
    st.restore()
    st.tts = None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference_conds(st, trees, control: bool):
    cfg = st.ctx.config
    _, s3c, vec = _reference_configs(cfg)
    s3 = {k: trees[k] for k in S3GEN_PARTS}
    with check.tf32(control):
        return rp.tts_conditionals(s3, trees["voice_encoder"], s3c, vec, st.voice,
                                   cfg["t3"]["speech_cond_prompt_len"], st.ctx.device)


def _reference_configs(cfg):
    return (harness.build(rt3.T3Config, cfg["t3"]), harness.build(rp.S3GenConfig, cfg["s3gen"]),
            harness.build(rp.VoiceEncoderConfig, cfg["voice_encoder"]))


def _t3_logits(st, trees, conds, text, tokens):
    t3c, _, _ = _reference_configs(st.ctx.config)
    p = st.ctx.traffic
    dev = st.ctx.device
    emo = torch.full((1,), p["exaggeration"], device=dev)
    cond = rt3.cond_prefix(trees["t3"], t3c, conds["speaker_emb"], conds["t3_prompt_tokens"], emo)
    ids = torch.tensor(rt3.text_ids(text, t3c), device=dev)
    tok = torch.from_numpy(tokens.astype(np.int64)).to(dev)
    lg = rt3.t3_step_logits(trees["t3"], t3c, cond, ids, tok, p["cfg_weight"])
    return rt3.repetition_penalized(lg, tok, t3c.start_speech_token, p["repetition_penalty"])


def _synth(st, trees, conds, c, row, tokens, hift_dtype=None):
    _, s3c, _ = _reference_configs(st.ctx.config)
    dev = st.ctx.device
    h = s3c.hift.nb_harmonics + 1
    samples = 2 * c.shapes["token_bucket"] * rp.MEL_TO_WAV
    phase, add = rp.hift_draws(c.seed, c.shapes["rows"], h, samples, dev)
    ref = {k: conds[k] for k in ("prompt_token", "prompt_token_len", "prompt_feat", "embedding")}
    tok = torch.from_numpy(np.asarray(tokens, np.int64)).to(dev)
    return rp.synthesize({k: trees[k] for k in S3GEN_PARTS}, s3c, tok, ref, rp.cfm_noise(dev),
                         phase[row], add[row], hift_dtype=hift_dtype, padded_len=samples)


@torch.inference_mode()
def verify(st, calls, control: bool = False):
    """The readings of the check, and with ``control`` the control's beside
    them (each name suffixed ``.control``)."""
    spec = st.ctx.spec
    parts = ("t3",) + S3GEN_PARTS + ("voice_encoder",)
    ref = check.reference_trees(st.weights, parts)
    rc = _reference_conds(st, ref, False)
    got = {"speaker_emb": st.conds.t3.speaker_emb, "t3_prompt_tokens": st.conds.t3.prompt_tokens,
           **st.conds.gen._asdict()}
    out = check.conditional_readings(got, rc)
    ctl = {}
    if control:
        lows = check.reference_trees(st.weights, parts, True, CONTROL_FORMATS)
        cc = _reference_conds(st, lows, True)
        ctl = check.conditional_readings(cc, rc)
    n_check = spec["check_rows"]
    # T3: each sampled request's tokens up to and with EOS, against the
    # reference's distribution at each step and the step's draw; a step
    # reads how far its draw falls outside the served token's interval (0
    # where the reference draws that token too), and the check the mean
    # over every checked step (the widest request and step are read too)
    p = st.ctx.traffic
    chain = (p["temperature"], p["min_p"], p["top_p"])
    pool = [(c, r) for c in calls for r in range(c.shapes["rows"])]
    draws, gaps, ctl_gaps = {}, [], []
    for c, r in check.sample_rows(st.ctx.seed, 0, pool, n_check,
                                  lambda cr: cr[0].outputs["raw_lens"][cr[1]]):
        n = min(int(c.outputs["raw_lens"][r]) + 1, c.outputs["raw"].shape[1])
        tokens = c.outputs["raw"][r, :n]
        text = c.outputs["texts"][r]
        if c.k not in draws:
            draws[c.k] = rp.t3_draws(c.seed, c.shapes["rows"], c.outputs["raw"].shape[1],
                                     st.ctx.device)
        u = draws[c.k][:n, r]
        want = rt3.sampling_distribution(_t3_logits(st, ref, rc, text, tokens), *chain)
        served = torch.from_numpy(tokens.astype(np.int64)).to(want.device)
        gaps.append(rt3.draw_distance(want, served, u))
        if control:
            low = rt3.sampling_distribution(_t3_logits(st, lows, cc, text, tokens), *chain)
            ctl_gaps.append(rt3.draw_distance(want, rt3.inverse_cdf(low, u), u))
    out["t3_draw_gap"] = float(torch.cat(gaps).mean())
    out["t3_draw_gap.request"] = max(float(d.mean()) for d in gaps)
    out["t3_draw_gap.step"] = max(float(d.max()) for d in gaps)
    if control:
        ctl["t3_draw_gap"] = float(torch.cat(ctl_gaps).mean())
    # S3Gen: any finished request, from its served tokens
    reqs = [(c, r) for c in calls for r in range(c.shapes["rows"]) if len(c.outputs["clean"][r]) > 1]
    for c, r in check.sample_rows(st.ctx.seed, 1, reqs, n_check,
                                  lambda cr: len(cr[0].outputs["clean"][cr[1]])):
        tokens = c.outputs["clean"][r]
        want = _synth(st, ref, rc, c, r, tokens)
        served = torch.from_numpy(c.outputs["wavs"][r]).to(want.device)
        check.merge_max(out, check.wav_readings(served, want))
        if control:
            low_wav = _synth(st, lows, cc, c, r, tokens, hift_dtype=torch.bfloat16)
            check.merge_max(ctl, check.wav_readings(low_wav, want))
    out.update({f"{k}.control": v for k, v in ctl.items()})
    return out
