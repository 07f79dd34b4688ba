"""T3 training step: the masked-CE loss, its gradient by autograd, and AdamW
with ``optax.adamw``'s arithmetic.

Port of ``chatterbox_tpu/train/train_step.py``, on one device or over a
("data", "model") mesh, as the JAX package's step is also the sharded step
of its multi-chip dry run: with ``mesh`` each rank takes its rows of the
batch, the losses are the whole batch's (``masked_ce``'s all-reduced
divisor) and the gradients are summed over "data"; with ``model_sharded``
the params are this rank's T3 shards (``parallel/sharding``) and T3 runs
its tensor-parallel collectives in the forward and backward. AdamW runs
unchanged on the local tensors. The optimizer is written out in plain torch ops as ``optax.adamw(learning_rate)``
computes it, with optax 0.2.6's defaults (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, weight decay 1e-4, no mask), a chain of:

1. ``scale_by_adam``: the int32 ``count`` is incremented first (saturating);
   mu = (1 - b1) g + b1 mu and nu = (1 - b2) g^2 + b2 nu;
   u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + eps_root) + eps);
2. ``add_decayed_weights``: u += weight_decay * p;
3. ``scale_by_learning_rate``: u *= -learning_rate;
4. ``apply_updates``: p += u.

``torch.optim.AdamW`` computes another function: its weight decay defaults
to 0.01, it decays p before the step, and it bias-corrects sqrt(nu) with
eps placed after that correction.

The state is ``AdamState(count, mu, nu)``: count a 0-d int32 tensor, mu and
nu trees like the params in their dtype, as optax holds them. A step
updates the params and the state in place (the JAX trainer donates both to
its jitted step) and returns them.
"""

import contextlib
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..checkpoint.pytree_io import flatten, unflatten
from ..models.t3.t3 import T3Config, t3_loss
from ..parallel.sharding import data_rows, local_t3_config
from ..parallel.tensor_parallel import model_parallel

B1, B2, EPS, EPS_ROOT, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.0, 1e-4
_INT32_MAX = 2 ** 31 - 1


class AdamState(NamedTuple):
    count: torch.Tensor  # () int32: steps taken
    mu: dict  # the first moment, a tree like the params
    nu: dict  # the second moment


def tree_leaves(tree):
    """The leaves of a parameter tree in the JAX package's order (dict keys
    sorted, lists in order)."""
    return list(flatten(tree).values())


def _like(tree, leaves):
    """A tree of ``tree``'s structure holding ``leaves`` in leaf order."""
    return unflatten(dict(zip(flatten(tree).keys(), leaves)))


def adamw_init(params) -> AdamState:
    leaves = tree_leaves(params)
    zeros = [torch.zeros_like(p) for p in leaves]
    return AdamState(torch.zeros((), dtype=torch.int32, device=leaves[0].device),
                     _like(params, zeros), _like(params, [torch.zeros_like(p) for p in leaves]))


@torch.no_grad()
def adamw_update(params, state: AdamState, grads, learning_rate: float) -> AdamState:
    """One ``optax.adamw`` step (see the module docstring), applied to
    ``params``, ``state.mu`` and ``state.nu`` in place; returns the state
    with the new count."""
    c = state.count
    count = torch.where(c < _INT32_MAX, c + 1, c)
    # 1 - b^count in fp32, as optax computes it from its int32 count
    bc1 = 1.0 - torch.pow(torch.tensor(B1, dtype=torch.float32, device=c.device), count.float())
    bc2 = 1.0 - torch.pow(torch.tensor(B2, dtype=torch.float32, device=c.device), count.float())
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        m.mul_(B1).add_(g * (1 - B1))
        v.mul_(B2).add_((g * g) * (1 - B2))
        u = (m / bc1.to(m.dtype)) / (torch.sqrt(v / bc2.to(v.dtype) + EPS_ROOT) + EPS)
        u = u + WEIGHT_DECAY * p
        p.add_(-learning_rate * u)
    return AdamState(count, state.mu, state.nu)


def t3_loss_and_grads(params, cfg: T3Config, batch, data_group=None):
    """(loss, loss_text, loss_speech, grads) of ``t3_loss`` at ``params``;
    grads is a tree like the params (zeros for a leaf the loss does not
    reach). The params' own tensors are not marked for autograd: the graph
    runs on detached aliases of them. With ``data_group`` the batch is this
    rank's rows, and the losses and gradients are the whole batch's, summed
    over the group."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    with torch.enable_grad():
        lt, ls = t3_loss(_like(params, live), cfg, batch, data_group=data_group)
        loss = lt + ls
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    out = [loss.detach(), lt.detach(), ls.detach()]
    if data_group is not None:
        for t in out + grads:
            dist.all_reduce(t, group=data_group)
    return (*out, _like(params, grads))


def make_t3_train_step(cfg: T3Config, learning_rate: float = 1e-4, *, mesh=None,
                       model_sharded: bool = False):
    """(init_state, train_step), as the JAX package's. ``train_step(params,
    state, batch, timer=None)`` returns (params, state, {"loss",
    "loss_text", "loss_speech"}) with loss = loss_text + loss_speech, the
    metrics 0-d tensors on the params' device; params and state are updated
    in place. A ``runtime.profiling.StageTimer`` given as ``timer`` times
    the stages "loss_and_grads" and "update", each waiting for the device.

    With ``mesh`` every rank calls ``train_step`` with the whole batch and
    runs its rows of it (a multiple of the data axis's size); with
    ``model_sharded`` ``params`` are this rank's shards
    (``parallel.sharding.shard_params`` with ``t3_param_specs``)."""
    run_cfg, data_group, tp_group = cfg, None, None
    if mesh is not None:
        data_group = mesh.get_group("data") if mesh.size(0) > 1 else None
        if model_sharded:
            run_cfg = local_t3_config(cfg, mesh.size(1))
            tp_group = mesh.get_group("model") if mesh.size(1) > 1 else None

    def init_state(params):
        return adamw_init(params)

    def train_step(params, state: AdamState, batch, timer=None):
        def stage(name):
            if timer is None:
                return contextlib.nullcontext()
            return timer.stage(name, block_on=state.count)

        if mesh is not None:
            lo, hi = data_rows(mesh, batch["text_tokens"].shape[0])
            batch = {k: v[lo:hi] for k, v in batch.items()}
        with stage("loss_and_grads"), model_parallel(tp_group):
            loss, lt, ls, grads = t3_loss_and_grads(params, run_cfg, batch, data_group)
        with stage("update"):
            state = adamw_update(params, state, grads, learning_rate)
        return params, state, {"loss": loss, "loss_text": lt, "loss_speech": ls}

    return init_state, train_step
