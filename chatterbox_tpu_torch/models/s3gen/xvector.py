"""CAMPPlus x-vector speaker encoder: S3Gen's speaker embedding.

Port of ``chatterbox_tpu/models/s3gen/xvector.py`` (reference
s3gen/xvector.py: the FCM 2-D conv front, CAM dense-TDNN blocks of 12/24/16
layers, stats pooling, a 192-d embedding) on the Kaldi fbank of
``core/fbank.py``. BatchNorm uses its running stats (inference only). The
public layouts are the JAX package's: sequences (B, T, C), the FCM's images
(B, F, T, C). fp32.
"""

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ...checkpoint import torch_convert as tc
from ...core.fbank import kaldi_fbank
from ...core.layers import batch_norm, conv1d, conv2d


@dataclass(frozen=True)
class CAMPPlusConfig:
    feat_dim: int = 80
    embedding_size: int = 192
    growth_rate: int = 32
    bn_size: int = 4
    init_channels: int = 128
    m_channels: int = 32
    block_layers: tuple = (12, 24, 16)
    block_dilations: tuple = (1, 2, 2)
    seg_len: int = 100


def _bn_relu(p, x):
    return torch.relu(batch_norm(p, x))


def _basic_res_block(p, x, stride):
    """BasicResBlock on (B, H, W, C), striding H (xvector.py:61-91)."""
    y = _bn_relu(p["bn1"], conv2d(p["conv1"], x, stride=(stride, 1), padding=1))
    y = batch_norm(p["bn2"], conv2d(p["conv2"], y, padding=1))
    sc = x
    if "shortcut_conv" in p:
        sc = batch_norm(p["shortcut_bn"], conv2d(p["shortcut_conv"], x, stride=(stride, 1)))
    return torch.relu(y + sc)


def _fcm(p, x):
    """FCM front (xvector.py:94-127): (B, T, F) -> (B, T, C * F/8)."""
    h = _bn_relu(p["bn1"], conv2d(p["conv1"], x.transpose(1, 2)[..., None], padding=1))
    for blk, stride in zip(p["layer1"], (2, 1)):
        h = _basic_res_block(blk, h, stride)
    for blk, stride in zip(p["layer2"], (2, 1)):
        h = _basic_res_block(blk, h, stride)
    h = _bn_relu(p["bn2"], conv2d(p["conv2"], h, stride=(2, 1), padding=1))
    b, f, t, c = h.shape
    # the reference's (B, C, F', T) -> (B, C*F', T): channel-major features
    return h.permute(0, 2, 3, 1).reshape(b, t, c * f)


def _seg_pooling(x, seg_len):
    """avg_pool1d(kernel=stride=seg_len, ceil_mode) repeated back over time
    (xvector.py:221-231); x (B, T, C)."""
    b, t, c = x.shape
    n_seg = -(-t // seg_len)
    seg_sum = F.pad(x, (0, 0, 0, n_seg * seg_len - t)).reshape(b, n_seg, seg_len, c).sum(dim=2)
    counts = torch.clamp(t - torch.arange(n_seg, device=x.device) * seg_len, max=seg_len)
    seg = seg_sum / counts[None, :, None].to(x.dtype)
    return torch.repeat_interleave(seg, seg_len, dim=1)[:, :t]


def _cam_layer(p, x, dilation, seg_len):
    """Context-aware masked conv (xvector.py:195-231); x (B, T, C)."""
    k = p["local"]["w"].shape[-1]
    y = conv1d(p["local"], x, padding=(k - 1) // 2 * dilation, dilation=dilation)
    context = x.mean(dim=1, keepdim=True) + _seg_pooling(x, seg_len)
    m = torch.sigmoid(conv1d(p["lin2"], torch.relu(conv1d(p["lin1"], context))))
    return y * m


def _dense_tdnn_block(p, x, dilation, seg_len):
    """CAMDenseTDNNBlock: each layer's output concatenated onto its input."""
    for lp in p["layers"]:
        y = conv1d(lp["lin1"], _bn_relu(lp["nl1"], x))
        y = _cam_layer(lp["cam"], _bn_relu(lp["nl2"], y), dilation, seg_len)
        x = torch.cat([x, y], dim=-1)
    return x


def campplus_forward(p, cfg: CAMPPlusConfig, feats):
    """(B, T, 80) mean-normed fbank -> (B, 192) x-vector."""
    h = _fcm(p["head"], feats)
    h = _bn_relu(p["tdnn"]["nl"], conv1d(p["tdnn"]["conv"], h, stride=2, padding=2))
    for bp, dil in zip(p["blocks"], cfg.block_dilations):
        h = _dense_tdnn_block(bp, h, dil, cfg.seg_len)
        h = conv1d(bp["transit"], _bn_relu(bp["transit_nl"], h))
    h = _bn_relu(p["out_nl"], h)
    # stats pooling over time with the unbiased std (xvector.py:146-152)
    mean = h.mean(dim=1)
    var = ((h - mean[:, None]) ** 2).sum(dim=1) / max(h.shape[1] - 1, 1)
    stats = torch.cat([mean, torch.sqrt(var)], dim=-1)
    emb = conv1d(p["dense"]["conv"], stats[:, None])[:, 0]
    return batch_norm(p["dense"]["bn"], emb)


def campplus_embed_wav(p, cfg: CAMPPlusConfig, wav16):
    """(B, T) 16 kHz wav -> (B, 192): fbank, per-utterance mean-norm over
    time, forward (xvector.py:45-58, 425-428)."""
    feats = kaldi_fbank(wav16, num_mel_bins=cfg.feat_dim)
    return campplus_forward(p, cfg, feats - feats.mean(dim=1, keepdim=True))


def convert_campplus(sd, cfg: CAMPPlusConfig = CAMPPlusConfig(), prefix="speaker_encoder."):
    """Reference ``CAMPPlus`` state dict -> the JAX package's tree (numpy), as
    ``chatterbox_tpu/models/s3gen/xvector.py::convert_campplus``: the FCM
    head's conv2d (KH, KW, Cin, Cout), the batch norms' statistics."""
    def res_block(rp, stride):
        p = {"conv1": tc.conv2d(sd, f"{rp}.conv1"), "bn1": tc.batch_norm(sd, f"{rp}.bn1"),
             "conv2": tc.conv2d(sd, f"{rp}.conv2"), "bn2": tc.batch_norm(sd, f"{rp}.bn2")}
        if stride != 1:  # the head's channels stay m_channels: only the stride asks
            p["shortcut_conv"] = tc.conv2d(sd, f"{rp}.shortcut.0")
            p["shortcut_bn"] = tc.batch_norm(sd, f"{rp}.shortcut.1")
        return p

    head, x = prefix + "head.", prefix + "xvector."
    p = {
        "head": {
            "conv1": tc.conv2d(sd, head + "conv1"),
            "bn1": tc.batch_norm(sd, head + "bn1"),
            "layer1": [res_block(head + "layer1.0", 2), res_block(head + "layer1.1", 1)],
            "layer2": [res_block(head + "layer2.0", 2), res_block(head + "layer2.1", 1)],
            "conv2": tc.conv2d(sd, head + "conv2"),
            "bn2": tc.batch_norm(sd, head + "bn2"),
        },
        "tdnn": {"conv": tc.conv1d(sd, x + "tdnn.linear"),
                 "nl": tc.batch_norm(sd, x + "tdnn.nonlinear.batchnorm")},
        "blocks": [],
    }
    for bi, n_layers in enumerate(cfg.block_layers, start=1):
        layers = []
        for i in range(n_layers):
            lp = f"{x}block{bi}.tdnnd{i + 1}."
            layers.append({
                "nl1": tc.batch_norm(sd, lp + "nonlinear1.batchnorm"),
                "lin1": tc.conv1d(sd, lp + "linear1"),
                "nl2": tc.batch_norm(sd, lp + "nonlinear2.batchnorm"),
                "cam": {"local": tc.conv1d(sd, lp + "cam_layer.linear_local"),
                        "lin1": tc.conv1d(sd, lp + "cam_layer.linear1"),
                        "lin2": tc.conv1d(sd, lp + "cam_layer.linear2")},
            })
        p["blocks"].append({"layers": layers,
                            "transit_nl": tc.batch_norm(sd, f"{x}transit{bi}.nonlinear.batchnorm"),
                            "transit": tc.conv1d(sd, f"{x}transit{bi}.linear")})
    p["out_nl"] = tc.batch_norm(sd, x + "out_nonlinear.batchnorm")
    p["dense"] = {"conv": tc.conv1d(sd, x + "dense.linear"),
                  "bn": tc.batch_norm(sd, x + "dense.nonlinear.batchnorm")}
    return p
