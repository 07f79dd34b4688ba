"""Typed-config reading for native checkpoints (the ``config.json`` that the
JAX package's ``save_native`` writes next to the params). Keys a port config
does not have (the voice encoder, CAMPPlus, the S3 tokenizer) are ignored."""

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


def _tuplify(v):
    return tuple(_tuplify(x) if isinstance(x, list) else x for x in v)


def load_configs(path):
    """config.json -> (T3Config, S3GenConfig) of the port."""
    from ..models.s3gen.s3gen import S3GenConfig
    from ..models.t3.t3 import T3Config

    with open(path) as f:
        payload = json.load(f)
    return (
        config_from_dict(T3Config, payload["t3"]),
        config_from_dict(S3GenConfig, payload["s3gen"]),
    )
