"""The ("data", "model") device mesh and T3's tensor-parallel shards.

Port of ``chatterbox_tpu/parallel/sharding.py``. Batches split over "data";
T3's attention heads, FFN and vocabulary heads optionally split over
"model". The JAX package annotates shardings and lets GSPMD place the
collectives; here every rank holds its local shard as a plain tensor (the
kernels and ``_wmat`` take plain tensors) and the model runs its
collectives itself (``parallel/tensor_parallel.py``): one all-reduce after
``o`` and one after ``down``, the vocabulary shards of each head gathered.

A spec is ``None`` (replicated) or a ``Shard(axis, dim, blocks)``: the
tensor splits along ``dim`` over the mesh axis ``axis``, each of its
``blocks`` equal blocks split on its own and the local pieces concatenated
(``gate_up`` is ``[gate | up]`` on one axis: a contiguous split would give
one rank all of ``gate``). A dim that does not divide splits as the JAX
package's uneven shards do: ``ceil(n / size)`` a rank, the last rank the
rest.
"""

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..device import resolve_device

AXES = ("data", "model")


class Shard(NamedTuple):
    axis: str  # the mesh axis the dim splits over
    dim: int
    blocks: int = 1


def make_mesh(shape: Optional[Tuple[int, int]] = None, devices=None, *,
              device=None) -> DeviceMesh:
    """A ("data", "model") mesh over the initialized process group's ranks
    (``devices``: the global ranks to use, all by default), ``(n, 1)`` unless
    ``shape`` says otherwise. ``device``: the mesh's device type, the card
    unless the caller names the CPU."""
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    shape = tuple(shape) if shape is not None else (len(ranks), 1)
    if shape[0] * shape[1] != len(ranks):
        raise ValueError(f"mesh {shape} != {len(ranks)} ranks")
    mesh = torch.tensor(ranks, dtype=torch.int).reshape(shape)
    return DeviceMesh(resolve_device(device).type, mesh, mesh_dim_names=AXES)


def t3_param_specs(params) -> dict:
    """A spec for each T3 leaf, in the port's layouts: the stacked layers are
    (L, Cout, Cin), so q/k/v and gate_up (two blocks) split their output
    (dim 1), o and down their input (dim 2); text_head and speech_head
    (V, C) split the vocabulary (dim 0); everything else is replicated."""
    def spec(path):
        name = path[-2] if len(path) >= 2 else ""
        if "layers" in path and path[-1] == "w":
            if name in ("q", "k", "v"):
                return Shard("model", 1)
            if name == "gate_up":
                return Shard("model", 1, 2)
            if name in ("o", "down"):
                return Shard("model", 2)
        if name in ("text_head", "speech_head") and path[-1] == "w":
            return Shard("model", 0)
        return None

    def walk(tree, path=()):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [walk(v, path + (i,)) for i, v in enumerate(tree)]
        return spec(path)

    return walk(params)


def local_t3_config(cfg, model_size: int):
    """T3's config as one rank of ``model_size`` sees its shards: the local
    query and KV heads and FFN width (each must divide); the vocabularies
    stay whole, as the gathered logits are."""
    from dataclasses import replace

    lc = cfg.llama
    for name in ("num_attention_heads", "num_key_value_heads", "intermediate_size"):
        if getattr(lc, name) % model_size:
            raise ValueError(f"{name} {getattr(lc, name)} does not split over {model_size} ranks")
    return replace(cfg, llama=replace(
        lc, num_attention_heads=lc.num_attention_heads // model_size,
        num_key_value_heads=lc.num_key_value_heads // model_size,
        intermediate_size=lc.intermediate_size // model_size))


def shard_bounds(n: int, size: int, rank: int) -> Tuple[int, int]:
    """[lo, hi) of rank's piece of n elements split over size ranks."""
    per = -(-n // size)
    return min(rank * per, n), min((rank + 1) * per, n)


def axis_rank(mesh: DeviceMesh, axis: str) -> Tuple[int, int]:
    """(this rank's coordinate, the axis size) on a mesh axis."""
    return mesh.get_local_rank(axis), mesh.size(AXES.index(axis))


def shard_tensor(x: torch.Tensor, mesh: DeviceMesh, spec: Optional[Shard]) -> torch.Tensor:
    """This rank's local piece of ``x`` (a contiguous copy) under ``spec``."""
    if spec is None:
        return x
    rank, size = axis_rank(mesh, spec.axis)
    blocks = x.chunk(spec.blocks, dim=spec.dim)
    pieces = [b.narrow(spec.dim, lo, hi - lo)
              for b in blocks for lo, hi in [shard_bounds(b.shape[spec.dim], size, rank)]]
    return torch.cat(pieces, dim=spec.dim).contiguous()


def unshard_tensor(local: torch.Tensor, mesh: DeviceMesh, spec: Optional[Shard],
                   full_shape) -> torch.Tensor:
    """Inverse of ``shard_tensor``: the whole tensor on every rank of the
    axis, by an all-reduce of a zero-filled buffer that each rank writes its
    piece into (uneven pieces need no padding)."""
    if spec is None:
        return local
    rank, size = axis_rank(mesh, spec.axis)
    full = torch.zeros(full_shape, dtype=local.dtype, device=local.device)
    per_block = full_shape[spec.dim] // spec.blocks
    off = 0
    for blk in range(spec.blocks):
        lo, hi = shard_bounds(per_block, size, rank)
        full.narrow(spec.dim, blk * per_block + lo, hi - lo).copy_(
            local.narrow(spec.dim, off, hi - lo))
        off += hi - lo
    dist.all_reduce(full, group=mesh.get_group(spec.axis))
    return full


def _map(tree, specs, fn):
    if isinstance(tree, dict):
        return {k: _map(v, specs[k], fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, s, fn) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def shard_params(params, mesh: DeviceMesh, specs=None):
    """Each leaf's local shard on this rank (``specs`` None: all replicated)."""
    if specs is None:
        return params
    return _map(params, specs, lambda x, s: shard_tensor(x, mesh, s))


def unshard_params(local, mesh: DeviceMesh, specs, full_shapes):
    """The whole parameter tree from every rank's shards (a collective: every
    rank of the mesh calls it); ``full_shapes`` a tree like the params
    holding each leaf's whole shape (tensors or meta tensors will do)."""
    def fn(x, pair):
        spec, shape = pair
        return unshard_tensor(x, mesh, spec, tuple(shape.shape))
    return _map(local, _zip(specs, full_shapes), fn)


def _zip(specs, shapes):
    if isinstance(shapes, dict):
        return {k: _zip(specs[k], v) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_zip(s, v) for s, v in zip(specs, shapes)]
    return specs, shapes


def data_sharding(mesh: DeviceMesh) -> Shard:
    """The spec of batch-leading tensors: rows split over "data"."""
    return Shard("data", 0)


def replicated(mesh: DeviceMesh):
    """The spec of a replicated tensor."""
    return None


def data_rows(mesh: DeviceMesh, total: int) -> Tuple[int, int]:
    """[lo, hi) of this rank's rows of a batch of ``total`` split over
    "data"; the batch must be a multiple of the data axis's size."""
    rank, size = axis_rank(mesh, "data")
    if total % size:
        raise ValueError(f"a batch of {total} does not split over {size} data ranks")
    per = total // size
    return rank * per, (rank + 1) * per


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, lo: int, total: int) -> torch.Tensor:
    """Every data rank's rows -> the whole batch (``total`` rows) on every
    rank: an all-reduce of a zero-filled buffer over "data" that each rank
    writes rows [lo, lo + len(x)) into (int16 wavs summed in int32)."""
    if mesh.size(AXES.index("data")) == 1:
        return x
    wide = torch.int32 if x.dtype == torch.int16 else x.dtype
    full = torch.zeros((total,) + tuple(x.shape[1:]), dtype=wide, device=x.device)
    full[lo:lo + x.shape[0]] = x.to(wide)
    dist.all_reduce(full, group=mesh.get_group("data"))
    return full.to(x.dtype)
