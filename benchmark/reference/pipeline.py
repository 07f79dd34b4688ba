"""The plain pipelines around the reference modules: a voice's conditionals
from its wav, one text's or one source's waveform from its speech tokens,
the spread-spectrum watermark, and the readings the benchmark compares.

Everything here runs on one row at its own length, in the parameters'
dtype (fp32 unless a control lowers it), on whatever device the tensors
are on. The CFM noise, T3's and the vocoder's draws are made here by the
rules the pipeline states for them (``cfm_noise``, ``t3_draws``,
``hift_draws``), from the same seeds the benchmark hands the program.
"""

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from . import dsp
from .flow import FlowConfig, flow_inference
from .hifigan import HiFTConfig, hift_generate
from .resample import resample
from .s3tokenizer import S3TokenizerConfig, pad_to_token_multiple, s3_tokenize
from .voice_encoder import VoiceEncoderConfig, frame_step, num_wins, ve_embed_from_mels
from .xvector import CAMPPlusConfig, campplus_embed_wav

S3_SR, S3GEN_SR = 16000, 24000
SPEECH_VOCAB_SIZE = 6561
MEL_TO_WAV = 480  # samples of 24 kHz audio a mel frame
TRIM_N = S3GEN_SR // 50  # the 20 ms fade


@dataclass(frozen=True)
class S3GenConfig:
    flow: FlowConfig = field(default_factory=FlowConfig)
    hift: HiFTConfig = field(default_factory=HiFTConfig)
    campplus: CAMPPlusConfig = field(default_factory=CAMPPlusConfig)
    tokenizer: S3TokenizerConfig = field(default_factory=S3TokenizerConfig)


def cfm_noise(device) -> torch.Tensor:
    """The flow's fixed noise buffer (1, 15000, 80): standard normals from
    numpy's default generator seeded 0 (reference flow_matching.py:191)."""
    return torch.from_numpy(
        np.random.default_rng(0).standard_normal((1, 15000, 80)).astype(np.float32)).to(device)


def hift_draws(seed: int, rows: int, harmonics: int, samples: int, device):
    """The vocoder's draws of one call seeded ``seed``: on a generator of
    ``device`` seeded ``seed + 1``, uniforms (rows, harmonics) mapped to
    initial phases in [-pi, pi), then standard normals (rows, harmonics,
    samples), in that order."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    u = torch.rand((rows, harmonics), generator=gen, device=device)
    add = torch.randn((rows, harmonics, samples), generator=gen, device=device)
    return u * (2.0 * np.pi) - np.pi, add


def t3_draws(seed: int, rows: int, steps: int, device):
    """T3's draws of one call seeded ``seed``: on a generator of ``device``
    seeded ``seed``, one uniform a row at each decode step, each step its
    own draw of (rows,), in step order -> (steps, rows)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.stack([torch.rand((rows,), generator=gen, device=device) for _ in range(steps)])


def trim_silence(wav: np.ndarray, top_db: float = 20.0, frame_length: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """librosa.effects.trim: drop the leading and trailing frames more than
    ``top_db`` below the loudest frame's RMS."""
    if len(wav) < frame_length:
        return wav
    pad = frame_length // 2
    xp = np.pad(wav, (pad, pad), mode="constant")
    n_frames = 1 + (len(xp) - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(xp[idx] ** 2, axis=1) + 1e-12)
    db = 20.0 * np.log10(rms / (rms.max() + 1e-12) + 1e-12)
    keep = np.nonzero(db > -top_db)[0]
    if len(keep) == 0:
        return wav
    start = max(0, keep[0] * hop - pad)
    end = min(len(wav), keep[-1] * hop + frame_length - pad)
    return wav[start:end]


def embed_ref(p, cfg: S3GenConfig, wav24):
    """A (1, T) 24 kHz reference -> (prompt tokens (1, P), their count (1,),
    prompt mels (1, 2P, 80), x-vector (1, 192)): 24 kHz mels, and the
    x-vector and S3 tokens of the 16 kHz resample, the tokens cut to half
    the mel frames and the mels to twice the tokens."""
    wav16 = resample(wav24, S3GEN_SR, S3_SR)
    mels = dsp.s3gen_mel_spectrogram(wav24).transpose(1, 2)
    xvec = campplus_embed_wav(p["campplus"], cfg.campplus, wav16)
    tokens, token_lens = s3_tokenize(p["tokenizer"], cfg.tokenizer, wav16)
    n_tok = min(mels.shape[1] // 2, tokens.shape[1])
    return {"prompt_token": tokens[:, :n_tok], "prompt_token_len": torch.clamp(token_lens, max=n_tok),
            "prompt_feat": mels[:, : 2 * n_tok], "embedding": xvec}


def tts_conditionals(s3gen, ve, cfg: S3GenConfig, ve_cfg: VoiceEncoderConfig, ref24: np.ndarray,
                     prompt_len: int, device):
    """A TTS voice from its 24 kHz wav (reference tts.py prepare_conditionals):
    S3Gen's reference from the first 10 s, T3's prompt tokens from the
    first 6 s at 16 kHz (at most ``prompt_len``), and the voice-encoder
    embedding of the silence-trimmed 16 kHz wav, zero-padded to a 0.5 s
    bucket and averaged over the windows of its unpadded length."""
    ref16 = resample(torch.from_numpy(ref24).to(device), S3GEN_SR, S3_SR).cpu().numpy()
    dec_ref = pad_to_token_multiple(ref24[: 10 * S3GEN_SR], S3GEN_SR)
    enc_ref = pad_to_token_multiple(ref16[: 6 * S3_SR])
    ve_wav = trim_silence(ref16, top_db=20)
    bucket = S3_SR // 2
    ve_padded = np.zeros(max(-(-len(ve_wav) // bucket) * bucket, bucket), np.float32)
    ve_padded[: len(ve_wav)] = ve_wav
    n_valid = num_wins(max(1 + len(ve_wav) // 160, 1), frame_step(ve_cfg, ve_cfg.default_rate),
                       ve_cfg)
    out = embed_ref(s3gen, cfg, torch.from_numpy(dec_ref).to(device)[None])
    out["t3_prompt_tokens"], _ = s3_tokenize(s3gen["tokenizer"], cfg.tokenizer,
                                             torch.from_numpy(enc_ref).to(device)[None],
                                             max_len=prompt_len)
    mels = dsp.ve_mel_spectrogram(torch.from_numpy(ve_padded).to(device)[None]).transpose(1, 2)
    out["speaker_emb"] = ve_embed_from_mels(ve, ve_cfg, mels, torch.tensor([n_valid], device=device))
    return out


def vc_target(s3gen, cfg: S3GenConfig, ref24: np.ndarray, device):
    """A VC target voice from its 24 kHz wav: ``embed_ref`` of its first
    10 s, padded to whole 40 ms tokens."""
    ref = pad_to_token_multiple(ref24[: 10 * S3GEN_SR], S3GEN_SR)
    return embed_ref(s3gen, cfg, torch.from_numpy(ref).to(device)[None])


def vc_tokens(s3gen, cfg: S3GenConfig, source16: np.ndarray, bucket_tokens: int, device):
    """One 16 kHz source -> its S3 tokens (T,) int32, as the VC pipeline
    takes its sources: cut to 1000 tokens, padded to whole tokens, sent as
    int16 PCM in a row zero-padded to the call's token bucket, and
    tokenized with the pad masked (the mel frames at the source's end see
    the padding's zeros, not a reflection of the source)."""
    wav = pad_to_token_multiple(source16[: 1000 * 640])
    pcm = np.zeros(bucket_tokens * 640, np.int16)
    pcm[: len(wav)] = np.clip(np.round(wav * 32768.0), -32768, 32767).astype(np.int16)
    x = torch.from_numpy(pcm.astype(np.float32) / 32768.0).to(device)[None]
    lens = torch.tensor([len(wav)], device=device)
    tokens, n = s3_tokenize(s3gen["tokenizer"], cfg.tokenizer, x, wav_lens=lens)
    return tokens[0, : int(n[0])]


def watermark(wav, n_fft=512, hop=128, strength=0.075, band=(40, 200), bits=16, seed=0x5EED):
    """The spread-spectrum watermark of a (1, T) wav: the STFT magnitudes of
    bins [band) scaled by 1 + strength * pattern, the pattern the sum of
    ``bits`` unit-RMS pseudo-noise rows (the all-ones payload), orthonormal
    and orthogonal to the all-ones vector, drawn from numpy's generator
    seeded ``seed``."""
    n_band = band[1] - band[0]
    pattern = torch.from_numpy((np.ones(bits, np.float32) @ _pn_rows(seed, bits, n_band))
                               / np.sqrt(bits)).to(wav.device)
    t_len = wav.shape[-1]
    x = F.pad(wav.float(), (0, (-t_len) % hop))
    win = dsp.hann_window(n_fft)
    re, im = dsp.stft(x, n_fft, hop, win)
    scale = torch.ones(re.shape[-1], device=wav.device)
    scale[band[0]:band[1]] = 1.0 + strength * pattern
    y = dsp.istft(re * scale, im * scale, n_fft, hop, win)
    return F.pad(y, (0, max(0, t_len - y.shape[-1])))[:, :t_len]


def _pn_rows(seed: int, bits: int, n_band: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    g = np.concatenate([np.ones((1, n_band)), rng.standard_normal((bits, n_band))])
    q, _ = np.linalg.qr(g.T)
    return (q[:, 1: bits + 1].T * np.sqrt(n_band)).astype(np.float32)


def synthesize(s3gen, cfg: S3GenConfig, tokens, ref, noise, phase, additive,
               hift_dtype=None, padded_len: int = 0):
    """One row's speech tokens (T,) -> its (T * 960,) waveform: the flow on
    [prompt; tokens] with the voice's reference, HiFT on the generated
    mels with this row's vocoder draws (``phase`` (H,), ``additive`` (H,
    >= T * 960)), the 20 ms trim-fade, then the watermark, on the waveform
    zero-padded to ``padded_len`` samples (its batch's length: the STFT
    frames at the row's end see the padding, as in the pipeline's batch).
    ``hift_dtype`` runs the vocoder's conv trunk in that dtype (None: the
    parameters')."""
    t = tokens.shape[0]
    dev = tokens.device
    mel, _ = flow_inference(s3gen["flow"], cfg.flow, tokens[None].to(torch.int32),
                            torch.tensor([t], device=dev), ref["prompt_token"],
                            ref["prompt_token_len"], ref["prompt_feat"], ref["embedding"], noise)
    gen_mel = mel[:, ref["prompt_feat"].shape[1]:]
    n = gen_mel.shape[1] * MEL_TO_WAV
    wav, _ = hift_generate(s3gen["hift"], cfg.hift, gen_mel, phase_noise=phase[None],
                           additive_noise=additive[None, :, :n], compute_dtype=hift_dtype)
    ramp = (torch.cos(torch.linspace(np.pi, 0.0, TRIM_N, device=dev)) + 1.0) / 2.0
    fade = torch.cat([torch.zeros((TRIM_N,), device=dev), ramp])
    wav = torch.cat([wav[:, : 2 * TRIM_N] * fade[None], wav[:, 2 * TRIM_N:]], dim=1)
    return watermark(F.pad(wav, (0, max(0, padded_len - n))))[0, :n]


def spectral_error(served, ref, n_fft=1024, hop=256, band=None) -> float:
    """||S(served) - S(ref)|| / ||S(ref)|| over STFT magnitudes (Frobenius),
    over the bins [band) when given: a waveform distance that does not see
    the sines' phase, which the f0 integral carries across the whole row.
    A length that differs counts as error."""
    n = max(served.shape[-1], ref.shape[-1])
    served, ref = (F.pad(x.float(), (0, n - x.shape[-1])) for x in (served, ref))
    win = dsp.hann_window(n_fft)
    mags = []
    for x in (served, ref):
        re, im = dsp.stft(x[None], n_fft, hop, win)
        m = torch.sqrt(re ** 2 + im ** 2)
        mags.append(m if band is None else m[..., band[0]:band[1]])
    return float(torch.linalg.norm(mags[0] - mags[1]) / torch.linalg.norm(mags[1]).clamp_min(1e-12))


def relative_error(got, want) -> float:
    """||got - want|| / ||want||, fp64."""
    got, want = got.double(), want.double().to(got.device)
    return float(torch.linalg.norm(got - want) / torch.linalg.norm(want).clamp_min(1e-30))
