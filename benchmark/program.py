"""What the benchmark takes from the program besides the calls it times:
the configurations built from a configuration file, and the shapes of the
program's parameter trees (its own ``init_*`` run on the meta device), which
``synth.make_weights`` fills from the seed."""

import torch

from . import harness, synth

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def configs(config: dict) -> dict:
    """{"t3", "s3gen", "voice_encoder"}: the program's config dataclasses
    for the sections the configuration file has."""
    from chatterbox_tpu_torch.models.s3gen.s3gen import S3GenConfig
    from chatterbox_tpu_torch.models.t3.t3 import T3Config
    from chatterbox_tpu_torch.models.voice_encoder import VoiceEncoderConfig

    classes = {"t3": T3Config, "s3gen": S3GenConfig, "voice_encoder": VoiceEncoderConfig}
    return {k: harness.build(cls, config[k]) for k, cls in classes.items() if k in config}


def make_weights(config: dict, seed: int, device) -> dict:
    """The weights of every part the configuration's ``dtypes`` names, in
    that dtype, from the seed."""
    from chatterbox_tpu_torch import weights as pw

    cf = configs(config)
    meta = torch.device("meta")
    dts = {k: DTYPES[v] for k, v in config["dtypes"].items()}
    s3c = cf["s3gen"]
    inits = {
        "t3": lambda: pw.init_t3(cf["t3"], 0, meta, dts["t3"]),
        "flow": lambda: pw.init_flow(s3c.flow, 0, meta, dts["flow"]),
        "hift": lambda: pw.init_hift(s3c.hift, 0, meta),
        "campplus": lambda: pw.init_campplus(s3c.campplus, 0, meta),
        "tokenizer": lambda: pw.init_s3tokenizer(s3c.tokenizer, 0, meta),
        "voice_encoder": lambda: pw.init_voice_encoder(cf["voice_encoder"], 0, meta),
    }
    return synth.make_weights({k: inits[k]() for k in dts}, dts, seed, device)
