"""Token -> mel flow, plain: the conformer encoder and conditional flow
matching with a fixed Euler solver (reference s3gen/flow.py
CausalMaskedDiffWithXvec and flow_matching.py CausalConditionalCFM: cosine
t-schedule, 10 Euler steps, CFG rate 0.7), at the rows' own length (no
padding to a multiple of 128). The CFG pair [cond; uncond] rides a doubled
batch through one UNet call per step; t and dt stay fp32.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from .layers import embedding, linear
from .conformer import ConformerConfig, upsample_conformer_encoder
from .unet import UNetConfig, unet_forward


@dataclass(frozen=True)
class FlowConfig:
    vocab_size: int = 6561
    input_size: int = 512
    output_size: int = 80
    spk_embed_dim: int = 192
    token_mel_ratio: int = 2
    pre_lookahead_len: int = 3
    n_timesteps: int = 10
    inference_cfg_rate: float = 0.7
    sigma_min: float = 1e-6
    training_cfg_rate: float = 0.2
    encoder: ConformerConfig = field(default_factory=ConformerConfig)
    estimator: UNetConfig = field(default_factory=UNetConfig)


def cosine_t_span(n_timesteps: int) -> np.ndarray:
    """flow_matching.py:215-217."""
    t = np.linspace(0.0, 1.0, n_timesteps + 1)
    return (1.0 - np.cos(t * 0.5 * np.pi)).astype(np.float32)


def solve_euler(p, cfg: FlowConfig, z, mu, spks, cond, mask=None):
    """Fixed-step Euler ODE solve with batch-2 CFG. z, mu, cond (B, T, 80);
    spks (B, 80). Returns (B, T, 80)."""
    t_span = cosine_t_span(cfg.n_timesteps)
    dts = np.diff(t_span)
    b = z.shape[0]
    r = cfg.inference_cfg_rate
    mask2 = None if mask is None else torch.cat([mask, mask], dim=0)
    mu_in = torch.cat([mu, torch.zeros_like(mu)], dim=0)
    spks_in = torch.cat([spks, torch.zeros_like(spks)], dim=0)
    cond_in = torch.cat([cond, torch.zeros_like(cond)], dim=0)
    x = z
    for t_cur, dt in zip(t_span[:-1], dts):
        t_in = torch.full((2 * b,), float(t_cur), dtype=torch.float32, device=z.device)
        v = unet_forward(p["estimator"], cfg.estimator, torch.cat([x, x], dim=0), mu_in,
                         spks_in, cond_in, t_in, mask2)
        dphi = (1.0 + r) * v[:b] - r * v[b:]
        x = x + (float(dt) * dphi.float()).to(x.dtype)
    return x


def flow_inference(p, cfg: FlowConfig, token, token_len, prompt_token, prompt_token_len,
                   prompt_feat, embedding_vec, noise):
    """Tokens -> (mel (B, T_mel, 80) fp32, valid mask (B, T_mel)).

    token (B, T) right-padded, token_len (B,); prompt_token (B, P);
    prompt_feat (B, 2P, 80); embedding_vec (B, 192) x-vector; noise
    (B, >= T_mel, 80) CFM noise. Rows are valid up to 2*(P + token_len)."""
    b = token.shape[0]
    pdt = p["input_embedding"]["w"].dtype
    prompt_feat = prompt_feat.to(pdt)
    noise = noise.to(pdt)
    emb = embedding_vec / torch.linalg.norm(embedding_vec, dim=-1, keepdim=True)
    spks = linear(p["spk_embed_affine"], emb.to(pdt))

    full_token = torch.cat([prompt_token, token], dim=1).long()
    total_len = (prompt_token_len + token_len).to(token.device)
    tmask = torch.arange(full_token.shape[1], device=token.device)[None] < total_len[:, None]
    tok_emb = embedding(p["input_embedding"], full_token.clamp(min=0))
    tok_emb = tok_emb * tmask[..., None].to(tok_emb.dtype)

    h = upsample_conformer_encoder(p["encoder"], tok_emb, cfg.encoder, key_mask=tmask)
    h = linear(p["encoder_proj"], h)  # (B, 2(P+T), 80)

    mel_len1 = prompt_feat.shape[1]
    t_mel = h.shape[1]
    conds = torch.cat(
        [prompt_feat, torch.zeros((b, t_mel - mel_len1, cfg.output_size), dtype=h.dtype,
                                  device=h.device)],
        dim=1,
    )
    mel_mask = torch.arange(t_mel, device=h.device)[None] < (cfg.token_mel_ratio * total_len)[:, None]
    mel = solve_euler(p, cfg, noise[:, :t_mel], h, spks, conds, mask=mel_mask)
    return mel.float(), mel_mask
