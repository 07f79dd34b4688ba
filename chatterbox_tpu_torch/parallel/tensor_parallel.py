"""The collectives of T3's tensor parallelism (Megatron's f and g).

Inside ``model_parallel(group)`` the Llama and the heads of T3 run on this
rank's shards (``parallel/sharding.t3_param_specs``) and call:

- ``copy_to_model`` where a replicated activation enters the sharded
  q/k/v, gate_up or a head: identity forward, all-reduce of the gradient
  backward (f);
- ``reduce_from_model`` after ``o`` and ``down``: all-reduce of the partial
  products forward, identity backward (g);
- ``gather_vocab`` after a vocabulary-sharded head: the whole logits on
  every rank, by an all-reduce of a zero-filled buffer that each rank
  writes its slice into (uneven slices need no padding; ``gloo`` runs it on
  CUDA tensors, where its ``all_gather`` is NCCL-only); backward, each rank
  takes its slice of the (replicated) gradient.

So logits, CFG, sampling and every decision of the decode loop are the same
on every rank of the group. Outside the context (no group) all three are
the identity. The group is a context variable, so a thread or a call that
did not enter the context sees none.
"""

import contextlib
import contextvars

import torch
import torch.distributed as dist

from .sharding import shard_bounds

_GROUP = contextvars.ContextVar("model_parallel_group", default=None)


@contextlib.contextmanager
def model_parallel(group):
    """T3's collectives run over ``group`` inside the block (None: none)."""
    token = _GROUP.set(group)
    try:
        yield
    finally:
        _GROUP.reset(token)


def model_group():
    """The group of the enclosing ``model_parallel`` block, or None."""
    return _GROUP.get()


def model_size() -> int:
    g = _GROUP.get()
    return 1 if g is None else dist.get_world_size(g)


def _all_reduce(x, group):
    x = x.contiguous()
    dist.all_reduce(x, group=group)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherVocab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vocab, group):
        lo, hi = shard_bounds(vocab, dist.get_world_size(group), dist.get_rank(group))
        ctx.lo, ctx.hi = lo, hi
        full = x.new_zeros(x.shape[:-1] + (vocab,))
        full[..., lo:hi] = x
        return _all_reduce(full, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.lo:ctx.hi].contiguous(), None, None


def copy_to_model(x):
    g = _GROUP.get()
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x):
    g = _GROUP.get()
    return x if g is None else _ReduceFromModel.apply(x, g)


def gather_vocab(x, vocab: int):
    """Logits over this rank's vocabulary slice (..., V_local) -> (..., vocab)."""
    g = _GROUP.get()
    return x if g is None else _GatherVocab.apply(x, vocab, g)
