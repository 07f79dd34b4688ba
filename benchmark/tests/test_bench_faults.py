"""The check catches a broken program: each fault a cell can have, planted
in the program underneath a tiny CPU run (the card's look skipped), turns a
compared number past its limit and ``correct`` false, where the same run
without the fault keeps that number within it.

The faults: a decode step that leaves its KV cache unchanged; half of a
call's answers replaced by the other half's; a token altered where T3
produces it; an answer (the waveform) altered where it is produced; the watermark left
out; a flow whose Euler steps leave their state unchanged. The cells run on one card,
so no exchange between cards can be left out.
"""

import pytest
import torch

from benchmark.tests.tiny import run_tiny

torch.set_num_threads(2)
SEED = 2147483659


def _kv_unchanged(mp):
    from chatterbox_tpu_torch.models.t3 import llama

    mp.setattr(llama, "kv_cache_write", lambda cache, new_kv, write_pos: None)


def _half_the_answers(mp, cls):
    orig = cls.collect

    def collect(handle):
        wavs = orig(handle)
        half = len(wavs) // 2
        return wavs[:half] + [wavs[i % half] for i in range(len(wavs) - half)] if half else wavs

    mp.setattr(cls, "collect", staticmethod(collect))


def _token_altered(mp):
    from chatterbox_tpu_torch.models.t3 import t3

    orig = t3.sample_from_logits

    def sample(lg, u):
        # the drawn token moved half the vocabulary on, every step
        return (orig(lg, u) + lg.shape[-1] // 2) % lg.shape[-1]

    mp.setattr(t3, "sample_from_logits", sample)


def _answer_altered(mp, module):
    orig = module.synthesize

    def synthesize(*a, **kw):
        wav, lens = orig(*a, **kw)
        return (wav.float() * 0.5).to(wav.dtype), lens

    mp.setattr(module, "synthesize", synthesize)


def _watermark_left_out(mp):
    from chatterbox_tpu_torch.models import watermark

    mp.setattr(watermark.SpreadSpectrumWatermarker, "apply", lambda self, wav, pattern=None:
               wav.float())


def _flow_state_unchanged(mp):
    from chatterbox_tpu_torch.models.s3gen import flow

    mp.setattr(flow, "solve_euler", lambda p, cfg, z, mu, spks, cond, mask=None: z)


def _tts_faults():
    from chatterbox_tpu_torch.pipeline import tts

    return {
        "kv_cache_unchanged": (_kv_unchanged, "t3_draw_gap"),
        "half_the_answers": (lambda mp: _half_the_answers(mp, tts.ChatterboxTTS),
                             "wav_spec_err"),
        "token_altered": (_token_altered, "t3_draw_gap"),
        "answer_altered": (lambda mp: _answer_altered(mp, tts), "wav_spec_err"),
        "watermark_left_out": (_watermark_left_out, "wav_band_err"),
    }


def _vc_faults():
    from chatterbox_tpu_torch.pipeline import vc

    return {
        "half_the_answers": (lambda mp: _half_the_answers(mp, vc.ChatterboxVC),
                             "wav_spec_err"),
        "answer_altered": (lambda mp: _answer_altered(mp, vc), "wav_spec_err"),
        "flow_state_unchanged": (_flow_state_unchanged, "wav_spec_err"),
        "watermark_left_out": (_watermark_left_out, "wav_band_err"),
    }


FAULTS = [("tts-b64-t250", f) for f in ("kv_cache_unchanged", "half_the_answers",
                                         "token_altered", "answer_altered",
                                         "watermark_left_out")]
FAULTS += [("tts-b32-t500-int8", f) for f in ("kv_cache_unchanged", "token_altered")]
FAULTS += [("vc-b16-s3to12", f) for f in ("half_the_answers", "answer_altered",
                                          "flow_state_unchanged", "watermark_left_out")]
# the int8 cell at its own 500 tokens, so that the int8 KV cache runs; the
# bf16 cell at 40, enough steps for a stale cache to move the tiny T3's draws
SIZES = {"tts-b32-t500-int8": dict(texts=2, tokens=500),
         "tts-b64-t250": dict(texts=4, tokens=40)}
SOUND = {}


def _run(cell):
    # the cell's own sample of checked requests (every request of the tiny run)
    return run_tiny(cell, SEED,
                    **SIZES.get(cell, dict(texts=4, sources=(1.2, 0.6, 1.0, 0.8))))[0]


def _sound(cell):
    if cell not in SOUND:
        SOUND[cell] = _run(cell)
    return SOUND[cell]


@pytest.mark.parametrize("cell,fault", FAULTS, ids=[f"{c}-{f}" for c, f in FAULTS])
def test_fault_turns_the_check_false(cell, fault, monkeypatch):
    faults = _vc_faults() if cell.startswith("vc") else _tts_faults()
    plant, number = faults[fault]
    sound = _sound(cell)["checks"][number]
    assert sound["value"] <= sound["limit"]
    plant(monkeypatch)
    out = _run(cell)
    assert out["checks"][number]["value"] > out["checks"][number]["limit"]
    assert out["correct"] is False
