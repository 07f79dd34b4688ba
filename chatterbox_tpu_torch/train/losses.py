"""Training losses.

Port of ``chatterbox_tpu/train/losses.py``: the conditional flow-matching
loss with training-time CFG dropout (reference flow_matching.py:146-185).
T3's masked cross entropy is ``models/t3/t3.t3_loss``.
"""

import math
from typing import NamedTuple, Optional

import torch

from ..models.s3gen.flow import FlowConfig
from ..models.s3gen.unet import unet_forward


class CFMDraws(NamedTuple):
    """The random draws of one ``cfm_loss`` call, before any transform."""

    t: torch.Tensor  # (B,) uniform in [0, 1): the time, before the cosine schedule
    z: torch.Tensor  # (B, T, 80) standard normal: the noise
    keep: torch.Tensor  # (B,) uniform in [0, 1): a row keeps its conditioning above the rate


def cfm_draws(x1, generator: Optional[torch.Generator] = None) -> CFMDraws:
    """The draws of ``cfm_loss`` from ``generator``, in the order t, z, keep
    (the JAX package splits its key three ways for them)."""
    b, dev = x1.shape[0], x1.device
    return CFMDraws(torch.rand((b,), generator=generator, device=dev),
                    torch.randn(x1.shape, generator=generator, device=dev).to(x1.dtype),
                    torch.rand((b,), generator=generator, device=dev))


def cfm_loss(p, cfg: FlowConfig, x1, mask, mu, spks, cond, *,
             generator: Optional[torch.Generator] = None, draws: Optional[CFMDraws] = None,
             use_flash: Optional[bool] = None):
    """Conditional flow-matching loss (flow_matching.py:146-185).

    x1, mu, cond (B, T, 80); mask (B, T) bool; spks (B, 80). t follows the
    cosine schedule ``1 - cos(t pi / 2)``; y = (1 - (1 - sigma_min) t) z +
    t x1 is the point on the path and u = x1 - (1 - sigma_min) z its
    velocity. CFG dropout: a row whose ``keep`` draw is at or under
    ``training_cfg_rate`` has mu, spks and cond zeroed. Returns the masked
    MSE of the UNet's velocity, over sum(mask) * 80 values, in fp32.

    The draws come from ``generator`` unless ``draws`` gives them (parity
    with the JAX package holds for the same draws only). ``use_flash``
    picks the UNet's attention (``unet._attn``): the kernels have no
    backward, so a gradient needs ``use_flash=False`` (or the module switch
    ``unet.FLASH_ATTENTION`` off), as in the JAX package."""
    if draws is None:
        draws = cfm_draws(x1, generator)
    t = 1.0 - torch.cos(draws.t.float() * 0.5 * math.pi)
    z = draws.z.to(x1.dtype)
    sig = cfg.sigma_min
    tb = t[:, None, None].to(x1.dtype)
    y = (1.0 - (1.0 - sig) * tb) * z + tb * x1
    u = x1 - (1.0 - sig) * z
    if cfg.training_cfg_rate > 0:
        keep = (draws.keep > cfg.training_cfg_rate).to(x1.dtype)
        mu = mu * keep[:, None, None]
        spks = spks * keep[:, None]
        cond = cond * keep[:, None, None]
    pred = unet_forward(p["estimator"], cfg.estimator, y, mu, spks, cond, t, mask,
                        use_flash=use_flash)
    # the error and its mean in fp32, as the JAX package's fp32 t promotes them
    m = mask[..., None].float()
    num = torch.sum(((pred.float() - u.float()) * m) ** 2)
    den = torch.clamp_min(torch.sum(m) * x1.shape[-1], 1.0)
    return num / den
