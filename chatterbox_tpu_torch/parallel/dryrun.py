"""A multi-rank dry run: one sharded T3 train step, then sharded generation,
at tiny shapes on a real mesh.

Port of ``__graft_entry__.dryrun_multichip`` (``__graft_entry__.py:44-140``).
Every rank of an initialized process group of ``n_devices`` calls it (for
one rank with no group, it starts a world of one on a free local port):

    torchrun --nproc_per_node=2 -m chatterbox_tpu_torch.parallel.dryrun
"""

import socket
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def dryrun_multichip(n_devices: int, *, device=None) -> str:
    """A (n/2, 2) ("data", "model") mesh where n is even, else (n, 1); one
    sharded T3 train step (dp x tp) on a tiny T3, then the pipeline's
    sharded ``generate_batch(..., device_chain=True)`` with T3 model-sharded,
    on the card unless ``device`` names the CPU. Prints and returns the
    ``dryrun_multichip OK: ...`` line."""
    from ..models.s3gen.conformer import ConformerConfig
    from ..models.s3gen.flow import FlowConfig
    from ..models.s3gen.s3gen import RefDict, S3GenConfig
    from ..models.s3gen.unet import UNetConfig
    from ..models.t3.llama import LlamaConfig
    from ..models.t3.t3 import T3Config
    from ..pipeline.conditionals import Conditionals, T3CondData
    from ..pipeline.tts import ChatterboxTTS
    from ..train.train_step import make_t3_train_step
    from ..weights import init_t3
    from .multihost import init_multihost
    from .sharding import make_mesh, shard_params, t3_param_specs

    dev = resolve_device(device)
    if not dist.is_initialized():
        if n_devices != 1:
            raise ValueError(f"{n_devices} ranks need an initialized process group")
        init_multihost(f"127.0.0.1:{_free_port()}", 1, 0, device=dev)
    if dist.get_world_size() != n_devices:
        raise ValueError(f"the process group has {dist.get_world_size()} ranks, not {n_devices}")
    model_axis = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    mesh = make_mesh((n_devices // model_axis, model_axis), device=dev)

    # tiny shapes, real sharding: the dims divide the model axis. The JAX
    # dry run's widths, but every attention head of 64 channels, the one
    # head width the kernels take (K1, K3, K4)
    cfg = T3Config(llama=LlamaConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                                     num_attention_heads=4, num_key_value_heads=4, head_dim=64))
    params = init_t3(cfg, 0, dev)
    params = shard_params(params, mesh, t3_param_specs(params))
    init_state, train_step = make_t3_train_step(cfg, mesh=mesh, model_sharded=True)
    opt_state = init_state(params)
    b = mesh.size(0) * 2
    batch = {
        "speaker_emb": torch.zeros((b, 256), device=dev),
        "prompt_tokens": torch.zeros((b, 150), dtype=torch.int32, device=dev),
        "emotion_adv": torch.full((b,), 0.5, device=dev),
        "text_tokens": torch.zeros((b, 16), dtype=torch.int32, device=dev),
        "text_lens": torch.full((b,), 16, dtype=torch.int32, device=dev),
        "speech_tokens": torch.zeros((b, 24), dtype=torch.int32, device=dev),
        "speech_lens": torch.full((b,), 24, dtype=torch.int32, device=dev),
    }
    params, opt_state, metrics = train_step(params, opt_state, batch)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise RuntimeError(f"sharded train step: loss {loss}")

    s3_cfg = S3GenConfig(flow=FlowConfig(
        input_size=64,
        encoder=ConformerConfig(input_size=64, output_size=64, attention_heads=1,
                                linear_units=128, num_blocks=1, num_up_blocks=1),
        estimator=UNetConfig(channels=32, n_blocks=1, num_mid_blocks=1, num_heads=4)))
    tts = ChatterboxTTS.from_random(seed=0, t3_cfg=cfg, s3gen_cfg=s3_cfg, device=dev)
    tts.with_mesh(mesh, model_sharded=True)
    rng = np.random.default_rng(0)
    p_len = 8

    def t(a):
        return torch.from_numpy(np.asarray(a)).to(dev)

    tts.conds = Conditionals(
        T3CondData(t(rng.standard_normal((1, 256)).astype(np.float32)),
                   t(rng.integers(0, 6561, (1, 150)).astype(np.int32)),
                   torch.full((1,), 0.5, device=dev)),
        RefDict(t(rng.integers(0, 6561, (1, p_len)).astype(np.int32)),
                torch.full((1,), p_len, dtype=torch.int32, device=dev),
                t(rng.standard_normal((1, 2 * p_len, 80)).astype(np.float32)),
                t(rng.standard_normal((1, 192)).astype(np.float32))))
    texts = ["Sharded generation dry run."] * b
    wavs = tts.generate_batch(texts, max_new_tokens=8, seed=3, device_chain=True)
    if not all(np.isfinite(w).all() and len(w) > 0 for w in wavs):
        raise RuntimeError("sharded generation: a wav is empty or not finite")
    checksum = int(sum(int(np.abs(w * 32767).astype(np.int64).sum()) for w in wavs))
    line = (f"dryrun_multichip OK: mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
            f"loss={loss:.4f} gen_wavs={len(wavs)} gen_checksum={checksum}")
    print(line, flush=True)
    return line


if __name__ == "__main__":
    from .multihost import init_multihost

    dev = sys.argv[1] if len(sys.argv) > 1 else None
    init_multihost(device=dev)
    dryrun_multichip(dist.get_world_size() if dist.is_initialized() else 1, device=dev)
