"""vc_batch: one client's back-to-back ``ChatterboxVC.generate_batch``
calls, each a batch of sources converted into one target voice.

Set-up builds the pipeline on the benchmark's weights (the flow bf16; the
S3 tokenizer, CAMPPlus and HiFT fp32), sets the target voice (timed:
``cond_prepare_s``) and makes one warm call at the cell's shapes. The check
compares the target's conditionals and the waveforms of a sample of
sources, tokenized, resynthesized and watermarked by the plain reference
in a row padded as the call padded it; the same source at its own length
is read beside, not compared.
"""

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from benchmark import check, counts, harness, program
from benchmark.reference import pipeline as rp
from benchmark.traffic import Traffic

S3GEN_PARTS = ("flow", "hift", "campplus", "tokenizer")
# the control's precisions: the flow's weights fp8 below bf16; the
# tokenizer and CAMPPlus TF32 below fp32 with TF32 off; the vocoder's trunk
# bf16, its phase-sensitive stages fp32 (the program's CHATTERBOX_HIFT_BF16)
CONTROL_FORMATS = {"flow": "fp8", "hift": "fp32", "campplus": "fp32", "tokenizer": "fp32"}
TOKEN_BUCKETS = (64, 125, 250, 500, 750, 1000)


def setup(ctx):
    from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC

    s3c = program.configs(ctx.config)["s3gen"]
    w = program.make_weights(ctx.config, ctx.seed, ctx.device)
    vc = ChatterboxVC({k: w[k] for k in S3GEN_PARTS}, ctx.device, s3c)
    traffic = Traffic(ctx.traffic, ctx.seed)
    voice = traffic.voice()
    harness.sync(ctx.device)
    t = time.perf_counter()
    vc.set_target_voice(voice)
    harness.sync(ctx.device)
    cond_s = time.perf_counter() - t
    st = SimpleNamespace(ctx=ctx, vc=vc, weights=w, voice=voice, traffic=traffic,
                         ref=vc.ref_dict)
    call(st, -1)
    harness.sync(ctx.device)
    return st, {"cond_prepare_s": cond_s}


def _tokens(n_samples: int) -> int:
    return int(np.ceil(n_samples / 16000 * 25))


def call(st, k: int, mark=None) -> harness.Call:
    if mark:
        mark("pack")
    inp = st.traffic.call(k)
    t0 = time.perf_counter()
    if mark:
        mark("vc")
    wavs = st.vc.generate_batch(inp["sources"], seed=inp["seed"])
    wall = time.perf_counter() - t0
    cfg = st.ctx.config["s3gen"]
    n_tok = [min(_tokens(len(s)), TOKEN_BUCKETS[-1]) for s in inp["sources"]]
    prompt = int(st.ref.prompt_token_len.reshape(-1)[0])
    flops = sum(counts.s3tok_flops(4 * n, cfg["tokenizer"]) + counts.flow_flops(prompt, n, cfg["flow"])
                + counts.hift_flops(2 * n, cfg["hift"]) for n in n_tok)
    return harness.Call(
        k=k, wall_s=wall, audio_s=sum(len(x) for x in wavs) / rp.S3GEN_SR, seed=inp["seed"],
        stages={"vc_s": st.vc.last_timings["vc_s"]},
        shapes={"n_tokens": n_tok, "token_bucket": st.vc.last_timings["token_bucket"],
                "prompt_tokens": prompt, "rows": len(wavs)},
        flops=flops, outputs={"sources": inp["sources"], "wavs": wavs})


def release(st):
    """Free the program's state on the device before the reference runs."""
    st.vc = None
    gc.collect()
    if st.ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def _synth(st, trees, ref, c, row, control: bool, padded: bool = True):
    """One source as the call served it, tokenized in a row of the call's
    token bucket and watermarked over the call's length; or with ``padded``
    false at its own length, as if it had been sent alone in a bucket of
    its own size."""
    s3c = harness.build(rp.S3GenConfig, st.ctx.config["s3gen"])
    dev = st.ctx.device
    s3 = {k: trees[k] for k in S3GEN_PARTS}
    src = c.outputs["sources"][row]
    bucket = c.shapes["token_bucket"] if padded else c.shapes["n_tokens"][row]
    with check.tf32(control):
        tokens = rp.vc_tokens(s3, s3c, src, bucket, dev)
    samples = 2 * c.shapes["token_bucket"] * rp.MEL_TO_WAV
    phase, add = rp.hift_draws(c.seed, c.shapes["rows"], s3c.hift.nb_harmonics + 1, samples, dev)
    return rp.synthesize(s3, s3c, tokens, ref, rp.cfm_noise(dev), phase[row], add[row],
                         hift_dtype=torch.bfloat16 if control else None,
                         padded_len=samples if padded else 0)


@torch.inference_mode()
def verify(st, calls, control: bool = False):
    """The readings of the check, and with ``control`` the control's beside
    them (each name suffixed ``.control``)."""
    s3c = harness.build(rp.S3GenConfig, st.ctx.config["s3gen"])
    ref = check.reference_trees(st.weights, S3GEN_PARTS)
    with check.tf32(False):
        rc = rp.vc_target({k: ref[k] for k in S3GEN_PARTS}, s3c, st.voice, st.ctx.device)
    out = check.conditional_readings(st.ref._asdict(), rc)
    ctl = {}
    if control:
        low = check.reference_trees(st.weights, S3GEN_PARTS, True, CONTROL_FORMATS)
        with check.tf32(True):
            cc = rp.vc_target({k: low[k] for k in S3GEN_PARTS}, s3c, st.voice, st.ctx.device)
        ctl = check.conditional_readings(cc, rc)
    reqs = [(c, r) for c in calls for r in range(c.shapes["rows"])]
    unpadded = {}
    for c, r in check.sample_rows(st.ctx.seed, 1, reqs, st.ctx.spec["check_rows"],
                                  lambda cr: len(cr[0].outputs["sources"][cr[1]])):
        want = _synth(st, ref, rc, c, r, False)
        served = torch.from_numpy(c.outputs["wavs"][r]).to(want.device)
        check.merge_max(out, check.wav_readings(served, want))
        # not compared: the same source unpadded, as if sent alone
        alone = _synth(st, ref, rc, c, r, False, padded=False)
        check.merge_max(unpadded, {"wav_spec_err.unpadded": rp.spectral_error(served, alone)})
        if control:
            check.merge_max(ctl, check.wav_readings(_synth(st, low, cc, c, r, True), want))
    out.update(unpadded)
    out.update({f"{k}.control": v for k, v in ctl.items()})
    return out
