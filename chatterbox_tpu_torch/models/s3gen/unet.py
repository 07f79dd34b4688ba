"""Causal 1-D UNet: the CFM velocity estimator of S3Gen.

Port of ``chatterbox_tpu/models/s3gen/unet.py`` (reference
s3gen/decoder.py ConditionalDecoder with in 320, out 80, channels 256, 4
transformer blocks per stage x (1 down + 12 mid + 1 up), 8 heads of 64).
Self-attention pads T to a multiple of 128 with pad keys biased at -1e10,
then reads the packed to_qkv output through kernel K3 when the weights are
fused and the inner width is a multiple of 128, and takes split q, k, v
through kernel K5 otherwise: for unfused to_q/to_k/to_v weights (the
reference checkpoint's layout) and for other widths
(``ops/flash_attention.py``). ``use_flash=False`` (or the module switch
``FLASH_ATTENTION``, as in the JAX package) takes the dense attention of
``core/layers.sdpa`` instead: the path a gradient goes through, since the
kernels have no backward and refuse autograd.
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ...checkpoint import torch_convert as tc
from ...core.layers import (causal_conv1d, conv1d, layer_norm, linear, merge_heads, mish, sdpa,
                            split_heads)
from ...ops.flash_attention import flash_self_attention, flash_self_attention_packed


@dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 320  # packed [x; mu; spks; cond] = 4 * 80
    out_channels: int = 80
    channels: int = 256
    n_blocks: int = 4
    num_mid_blocks: int = 12
    num_heads: int = 8
    attention_head_dim: int = 64

    @property
    def time_embed_dim(self) -> int:
        return self.channels * 4


def sinusoidal_pos_emb(t, dim: int, scale: float = 1000.0):
    """matcha/decoder.py:14-29; t (B,) fp32 -> (B, dim) fp32."""
    half = dim // 2
    emb = np.log(10000.0) / (half - 1)
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device) * -emb)
    ang = scale * t[:, None] * freqs[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _causal_block(p, x, mask):
    """Causal conv k3 -> LayerNorm -> Mish."""
    y = causal_conv1d(p["conv"], x * mask)
    return mish(layer_norm(p["ln"], y, 1e-5)) * mask


def _causal_resnet(p, x, mask, t_emb):
    h = _causal_block(p["block1"], x, mask)
    h = h + linear(p["mlp"], mish(t_emb))[:, None]
    h = _causal_block(p["block2"], h, mask)
    return h + conv1d(p["res_conv"], x * mask)


FLASH_ATTENTION = True  # module switch, as the JAX package's (unet.py:61)


def _attn(p, x, n_heads, key_bias=None, use_flash=None):
    """diffusers Attention: q/k/v projections without bias, scale
    1/sqrt(head_dim), out bias. With ``use_flash`` (default: the module's
    ``FLASH_ATTENTION``): K3 on the packed qkv when ``to_qkv`` is fused and
    its inner width a multiple of 128; otherwise K5 on (B, H, T, D) q, k, v
    split from ``to_qkv`` or projected by ``to_q``/``to_k``/``to_v``.
    Without: the dense ``sdpa`` on the unpadded q, k, v (unet.py:64-134)."""
    if use_flash is None:
        use_flash = FLASH_ATTENTION
    if "to_qkv" in p:
        if use_flash and (p["to_qkv"]["w"].shape[0] // 3) % 128 == 0:
            return linear(p["to_out"], _packed(linear(p["to_qkv"], x), key_bias, n_heads))
        qkv = linear(p["to_qkv"], x).chunk(3, dim=-1)
    else:
        qkv = [linear(p[name], x) for name in ("to_q", "to_k", "to_v")]
    q, k, v = (split_heads(y, n_heads) for y in qkv)
    if use_flash:
        out = _heads(q, k, v, key_bias)
    else:
        out = sdpa(q, k, v, mask=None if key_bias is None else key_bias.float()[:, None, None, :])
    return linear(p["to_out"], merge_heads(out))


def _padded_bias(key_bias, b, t, tp, device):
    """The (B, tp) f32 key bias of the kernels: pad keys at -1e10."""
    bias = key_bias.float() if key_bias is not None else torch.zeros(
        (b, t), dtype=torch.float32, device=device)
    return F.pad(bias, (0, tp - t), value=-1.0e10).contiguous()


def _packed(qkv, key_bias, n_heads):
    """K3 on the packed (B, T, 3*H*D) qkv, T padded to a multiple of 128."""
    b, t, _ = qkv.shape
    tp = -(-t // 128) * 128
    qkv = F.pad(qkv, (0, 0, 0, tp - t)).contiguous()
    return flash_self_attention_packed(qkv, _padded_bias(key_bias, b, t, tp, qkv.device),
                                       n_heads)[:, :t]


def _heads(q, k, v, key_bias):
    """K5 on (B, H, T, D) q, k, v, T padded to a multiple of 128."""
    b, _, t, _ = q.shape
    tp = -(-t // 128) * 128
    q, k, v = (F.pad(y, (0, 0, 0, tp - t)).contiguous() for y in (q, k, v))
    return flash_self_attention(q, k, v, _padded_bias(key_bias, b, t, tp, q.device))[:, :, :t]


def _transformer_block(p, x, cfg: UNetConfig, key_bias=None, use_flash=None):
    """BasicTransformerBlock, plain-LayerNorm path with an exact-GELU FFN."""
    x = x + _attn(p["attn"], layer_norm(p["norm1"], x, 1e-5), cfg.num_heads, key_bias,
                  use_flash)
    y = layer_norm(p["norm3"], x, 1e-5)
    return x + linear(p["ff_out"], F.gelu(linear(p["ff_in"], y)))


def unet_forward(p, cfg: UNetConfig, x, mu, spks, cond, t, mask=None, *, use_flash=None):
    """Velocity estimate. x, mu, cond (B, T, 80); spks (B, 80); t (B,) in
    [0, 1]; mask (B, T) bool or None. Returns (B, T, 80). ``use_flash``
    picks every block's attention (see ``_attn``)."""
    b, tt, _ = x.shape
    if mask is None:
        mask_c = torch.ones((b, tt, 1), dtype=x.dtype, device=x.device)
        key_bias = None
    else:
        mask_c = mask[..., None].to(x.dtype)
        key_bias = (1.0 - mask.float()) * -1.0e10
    # an fp32 t: bf16 would quantize the scale-1000 sinusoid's phase
    t_emb = sinusoidal_pos_emb(t.float(), cfg.in_channels).to(x.dtype)
    t_emb = linear(p["time_mlp2"], F.silu(linear(p["time_mlp1"], t_emb)))

    h = torch.cat([x, mu, spks[:, None].expand(b, tt, spks.shape[-1]), cond], dim=-1)
    h = _causal_resnet(p["down_resnet"], h, mask_c, t_emb)
    for bp in p["down_tf"]:
        h = _transformer_block(bp, h, cfg, key_bias, use_flash)
    skip = h
    h = causal_conv1d(p["down_conv"], h * mask_c)
    for mp in p["mid"]:
        h = _causal_resnet(mp["resnet"], h, mask_c, t_emb)
        for bp in mp["tf"]:
            h = _transformer_block(bp, h, cfg, key_bias, use_flash)
    h = torch.cat([h, skip], dim=-1)
    h = _causal_resnet(p["up_resnet"], h, mask_c, t_emb)
    for bp in p["up_tf"]:
        h = _transformer_block(bp, h, cfg, key_bias, use_flash)
    h = causal_conv1d(p["up_conv"], h * mask_c)
    h = _causal_block(p["final_block"], h, mask_c)
    return conv1d(p["final_proj"], h * mask_c) * mask_c


def convert_unet(sd, cfg: UNetConfig = UNetConfig(), prefix=""):
    """Reference ``ConditionalDecoder`` state dict -> the JAX package's tree
    (numpy), as ``chatterbox_tpu/models/s3gen/unet.py::convert_unet``: each
    attention's ``to_q``/``to_k``/``to_v`` fused into one ``to_qkv``, so
    ``_attn`` takes K3 wherever its width is a multiple of 128."""
    def resnet(rp):
        return {
            "block1": {"conv": tc.conv1d(sd, f"{rp}.block1.block.0"),
                       "ln": tc.layer_norm(sd, f"{rp}.block1.block.2")},
            "block2": {"conv": tc.conv1d(sd, f"{rp}.block2.block.0"),
                       "ln": tc.layer_norm(sd, f"{rp}.block2.block.2")},
            "mlp": tc.linear(sd, f"{rp}.mlp.1"),
            "res_conv": tc.conv1d(sd, f"{rp}.res_conv"),
        }

    def tf(bp):
        qkv = [tc.linear(sd, f"{bp}.attn1.to_{n}")["w"] for n in "qkv"]
        return {
            "norm1": tc.layer_norm(sd, f"{bp}.norm1"),
            "norm3": tc.layer_norm(sd, f"{bp}.norm3"),
            "attn": {"to_qkv": {"w": np.concatenate(qkv, axis=1)},
                     "to_out": tc.linear(sd, f"{bp}.attn1.to_out.0")},
            "ff_in": tc.linear(sd, f"{bp}.ff.net.0.proj"),
            "ff_out": tc.linear(sd, f"{bp}.ff.net.2"),
        }

    return {
        "time_mlp1": tc.linear(sd, prefix + "time_mlp.linear_1"),
        "time_mlp2": tc.linear(sd, prefix + "time_mlp.linear_2"),
        "down_resnet": resnet(prefix + "down_blocks.0.0"),
        "down_tf": [tf(f"{prefix}down_blocks.0.1.{i}") for i in range(cfg.n_blocks)],
        "down_conv": tc.conv1d(sd, prefix + "down_blocks.0.2"),
        "mid": [
            {"resnet": resnet(f"{prefix}mid_blocks.{m}.0"),
             "tf": [tf(f"{prefix}mid_blocks.{m}.1.{i}") for i in range(cfg.n_blocks)]}
            for m in range(cfg.num_mid_blocks)
        ],
        "up_resnet": resnet(prefix + "up_blocks.0.0"),
        "up_tf": [tf(f"{prefix}up_blocks.0.1.{i}") for i in range(cfg.n_blocks)],
        "up_conv": tc.conv1d(sd, prefix + "up_blocks.0.2"),
        "final_block": {"conv": tc.conv1d(sd, prefix + "final_block.block.0"),
                        "ln": tc.layer_norm(sd, prefix + "final_block.block.2")},
        "final_proj": tc.conv1d(sd, prefix + "final_proj"),
    }
