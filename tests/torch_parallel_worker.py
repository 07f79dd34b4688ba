"""One rank of ``test_torch_parallel.py``'s 4-process ``gloo`` run.

    python tests/torch_parallel_worker.py RANK WORLD PORT DIR

Reads ``DIR/inputs.pt`` (written by the test, which computes every
reference in its own process), runs each case on the ranks' meshes and
writes ``DIR/out_RANK.pt``. Imports torch and the port only: no JAX.
"""

import datetime
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from chatterbox_tpu_torch.checkpoint.pytree_io import flatten, unflatten  # noqa: E402
from chatterbox_tpu_torch.core.sampling import SamplingConfig  # noqa: E402
from chatterbox_tpu_torch.models.s3gen.s3gen import RefDict  # noqa: E402
from chatterbox_tpu_torch.models.t3.t3 import t3_generate  # noqa: E402
from chatterbox_tpu_torch.parallel import sharding  # noqa: E402
from chatterbox_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from chatterbox_tpu_torch.parallel.tensor_parallel import model_parallel  # noqa: E402
from chatterbox_tpu_torch.pipeline.conditionals import Conditionals, T3CondData  # noqa: E402
from chatterbox_tpu_torch.pipeline.tts import ChatterboxTTS  # noqa: E402
from chatterbox_tpu_torch.pipeline.vc import ChatterboxVC  # noqa: E402
from chatterbox_tpu_torch.train.trainer import T3Trainer  # noqa: E402
from chatterbox_tpu_torch.train.train_step import make_t3_train_step  # noqa: E402


def conditionals(c):
    t = [torch.from_numpy(np.asarray(x)) for x in c]
    return Conditionals(T3CondData(*t[:3]), RefDict(*t[3:]))


def tp_generate(inp, mesh, alignment):
    """T3 with its heads split over "model" and the rows over "data"; the
    tokens gathered over "data"."""
    params = sharding.shard_params(inp["t3_params"], mesh,
                                   sharding.t3_param_specs(inp["t3_params"]))
    cfg = sharding.local_t3_config(inp["t3_cfg"], mesh.size(1))
    text, lens, spk, prompt, emo = (torch.from_numpy(x) for x in inp["gen"])
    b = text.shape[0]
    lo, hi = sharding.data_rows(mesh, b)
    with model_parallel(mesh.get_group("model")):
        res = t3_generate(params, cfg, text[lo:hi], lens[lo:hi], spk[lo:hi], prompt[lo:hi],
                          emo[lo:hi], SamplingConfig(), inp["max_new"],
                          uniforms=torch.from_numpy(inp["uniforms"]), alignment=alignment,
                          draw_rows=(lo, hi, b))
    return sharding.gather_rows(res.tokens, mesh, lo, b)


def train(inp, mesh, out_dir):
    """One sharded step (dp x tp) on the whole batch, the params gathered
    back; then a T3Trainer over the mesh, saved for a one-device load."""
    cfg, full = inp["t3_cfg"], inp["t3_params"]
    specs = sharding.t3_param_specs(full)
    # the step updates its params in place: replicated leaves are not copies
    params = sharding.shard_params(unflatten({k: v.clone() for k, v in flatten(full).items()}),
                                   mesh, specs)
    init_state, step = make_t3_train_step(cfg, mesh=mesh, model_sharded=True)
    state = init_state(params)
    params, state, metrics = step(params, state, inp["batch"])
    whole = sharding.unshard_params(params, mesh, specs, full)
    trainer = T3Trainer(cfg, full, donate=False, device="cpu", mesh=mesh, model_sharded=True)
    trainer.step(inp["batch"])
    trainer.save(out_dir / "mesh_trainer.safetensors")
    return whole, {k: float(v) for k, v in metrics.items()}


def main(rank, world, port, out_dir):
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    inp = torch.load(out_dir / "inputs.pt", weights_only=False)
    out = {}
    tp = sharding.make_mesh((2, 2), device="cpu")
    out["shards"] = sharding.shard_params(inp["t3_params"], tp,
                                          sharding.t3_param_specs(inp["t3_params"]))
    out["coords"] = (tp.get_local_rank("data"), tp.get_local_rank("model"))
    out["tp_tokens"] = tp_generate(inp, tp, False)
    out["tp_tokens_align"] = tp_generate(inp, tp, True)
    out["train_params"], out["train_metrics"] = train(inp, tp, out_dir)

    dp = sharding.make_mesh((4, 1), device="cpu")
    tts = ChatterboxTTS.from_random(seed=0, t3_cfg=inp["t3_cfg"], s3gen_cfg=inp["s3gen_cfg"],
                                    device="cpu").with_mesh(dp)
    out["tts_wavs"] = tts.generate_batch(inp["texts"], conditionals(inp["conds"]),
                                         **inp["tts_kw"])
    out["tts_tokens"] = tts.last_speech_tokens
    vc = ChatterboxVC.from_random(seed=0, s3gen_cfg=inp["s3gen_cfg"], device="cpu").with_mesh(dp)
    vc.set_target_voice(inp["target"])
    out["vc_wavs"] = vc.generate_batch(inp["sources"], seed=4)

    out["dryrun"] = dryrun_multichip(world, device="cpu")
    torch.save(out, out_dir / f"out_{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
