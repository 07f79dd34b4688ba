"""Typed configs of native checkpoints: the ``config.json`` that
``save_native`` (either package's) writes next to the params, and reads.
Keys a port config does not have are ignored."""

import dataclasses
import json


def config_from_dict(cls, data):
    """Build dataclass ``cls`` from a plain dict, recursing into nested
    dataclass fields and turning lists back into tuples where the field's
    default is a tuple."""
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        default = (
            f.default_factory() if f.default_factory is not dataclasses.MISSING
            else f.default
        )
        if dataclasses.is_dataclass(default):
            v = config_from_dict(type(default), v)
        elif isinstance(default, tuple) and isinstance(v, list):
            v = _tuplify(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def _to_dict(cfg):
    if dataclasses.is_dataclass(cfg):
        return {f.name: _to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return list(cfg)
    return cfg


def _tuplify(v):
    return tuple(_tuplify(x) if isinstance(x, list) else x for x in v)


def save_configs(path, t3_cfg, s3gen_cfg, ve_cfg):
    """Write the three configs as the JAX package's ``save_configs`` does
    (checkpoint/config_io.py:45-53), so its ``load_configs`` reads them."""
    payload = {"t3": _to_dict(t3_cfg), "s3gen": _to_dict(s3gen_cfg), "ve": _to_dict(ve_cfg)}
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)


def load_configs(path):
    """config.json -> (T3Config, S3GenConfig, VoiceEncoderConfig) of the
    port."""
    from ..models.s3gen.s3gen import S3GenConfig
    from ..models.t3.t3 import T3Config
    from ..models.voice_encoder import VoiceEncoderConfig

    with open(path) as f:
        payload = json.load(f)
    return (
        config_from_dict(T3Config, payload["t3"]),
        config_from_dict(S3GenConfig, payload["s3gen"]),
        config_from_dict(VoiceEncoderConfig, payload.get("ve", {})),
    )
