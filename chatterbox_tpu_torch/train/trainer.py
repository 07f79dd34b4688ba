"""The training loop and resumable checkpoints that both packages read.

Port of ``chatterbox_tpu/train/trainer.py``. ``T3Trainer`` drives
``train_step.make_t3_train_step`` on one device; ``save`` writes params,
optimizer state and step counter to one safetensors file, so that a killed
run restarts bit-identically.

The file is the JAX trainer's, in both directions: metadata ``{"kind":
"t3_train_state"}``, ``__step__`` int64, and ``leaf_%05d`` in the order of
``jax.tree_util.tree_leaves((params, opt_state))`` for ``optax.adamw``'s
state: the params' leaves (dict keys sorted), then ``count`` (0-d int32,
written as shape (1,)), then every ``mu`` leaf and every ``nu`` leaf in the
params' order (the chain's two ``EmptyState``s hold no leaf). Every leaf is
in the JAX package's layout: ``weights.to_jax_tree``/``from_jax_tree`` map
mu and nu as they map the params, each layout change being a permutation.
"""

import numpy as np
import torch

from ..checkpoint.pytree_io import flatten, unflatten
from ..checkpoint.safetensors_io import load_safetensors, save_safetensors
from ..device import resolve_device
from ..models.t3.t3 import T3Config
from ..weights import from_jax_tree, jax_layout_meta, to_jax_tree
from .train_step import AdamState, make_t3_train_step, tree_leaves


def _batch_to(batch, device):
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


class T3Trainer:
    """Stateful wrapper over the train step on one device.

    ``device=None`` is the card (``device.resolve_device``: it raises with
    no GPU, and nothing falls back to the CPU). Params and batches are moved
    to the device. With ``donate`` the given tensors, when already on the
    device in their dtype, are the ones the steps update in place; without
    it the trainer works on copies and the caller's tensors stay as they
    were."""

    def __init__(self, cfg: T3Config, params, learning_rate: float = 1e-4, donate: bool = True,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        init_state, self._step = make_t3_train_step(cfg, learning_rate)
        self.params = unflatten({k: v.to(self.device, copy=not donate)
                                 for k, v in flatten(params).items()})
        self.opt_state = init_state(self.params)
        self.step_num = 0

    def step(self, batch, timer=None):
        """One train step on ``batch`` (the JAX batch dict; tensors or numpy
        arrays); returns the metrics as host floats."""
        self.params, self.opt_state, metrics = self._step(
            self.params, self.opt_state, _batch_to(batch, self.device), timer)
        self.step_num += 1
        return {k: float(v) for k, v in metrics.items()}

    # -- checkpoint / resume ------------------------------------------------

    def _leaves(self):
        """The state's leaves in the JAX trainer's order, as numpy arrays in
        the JAX package's layouts."""
        s = self.opt_state
        return [*tree_leaves(to_jax_tree(self.params)), s.count.cpu().numpy(),
                *tree_leaves(to_jax_tree(s.mu)), *tree_leaves(to_jax_tree(s.nu))]

    def save(self, path):
        tensors = {f"leaf_{i:05d}": x for i, x in enumerate(self._leaves())}
        tensors["__step__"] = np.asarray(self.step_num, np.int64)
        save_safetensors(tensors, path, metadata={"kind": "t3_train_state"})

    def load(self, path):
        """Restore params, optimizer state and step saved by either
        package's ``T3Trainer.save`` into this trainer, which must have the
        same config and optimizer: leaves are matched by order and cast to
        the template leaf's dtype on this trainer's device. Raises
        ValueError, as the JAX ``load`` does, when the file's leaf count or
        any leaf's shape (in the JAX layout) differs from the template's;
        a 0-d leaf may come back as shape (1,)."""
        tensors, bf16 = load_safetensors(path)
        step_num = int(np.asarray(tensors.pop("__step__")).reshape(-1)[0])
        shapes = [tuple(m.shape) for m in tree_leaves(jax_layout_meta(self.params))]
        n = len(shapes)
        want = [*shapes, (), *shapes, *shapes]
        if len(tensors) != len(want):
            raise ValueError(f"checkpoint has {len(tensors)} leaves, state needs {len(want)} "
                             "(config/optimizer mismatch?)")
        arrays = []
        for i, shape in enumerate(want):
            name = f"leaf_{i:05d}"
            arr = tensors[name]
            if not (arr.shape == shape or (shape == () and arr.shape == (1,))):
                raise ValueError(f"checkpoint leaf {i} has shape {arr.shape}, state needs {shape}")
            arr = arr.reshape(shape)
            if name in bf16:  # bfloat16 bits: restored as their values
                bits = torch.from_numpy(arr.view(np.int16).copy())
                arr = bits.view(torch.bfloat16).float().numpy()
            arrays.append(arr)

        def tree(template, part):
            back = from_jax_tree(unflatten(dict(zip(flatten(template).keys(), part))))
            return unflatten({k: v.to(self.device, tmpl.dtype) for (k, v), tmpl in zip(
                flatten(back).items(), tree_leaves(template))})

        s = self.opt_state
        self.params = tree(self.params, arrays[:n])
        self.opt_state = AdamState(torch.from_numpy(np.array(arrays[n])).to(self.device, torch.int32),
                                   tree(s.mu, arrays[n + 1:2 * n + 1]),
                                   tree(s.nu, arrays[2 * n + 1:]))
        self.step_num = step_num

    @classmethod
    def resume(cls, path, cfg: T3Config, params_template, learning_rate: float = 1e-4,
               device=None):
        t = cls(cfg, params_template, learning_rate, device=device)
        t.load(path)
        return t
