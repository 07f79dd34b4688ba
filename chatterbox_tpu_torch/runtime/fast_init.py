"""Cheap synthetic parameters for benchmarks: every leaf filled from an
index-based pseudo-noise, with no random generator.

Port of ``chatterbox_tpu/runtime/fast_init.py``. A leaf of n elements is
``frac(sin(i * 12.9898 + salt * 78.233) * 43758.5453) * 2 - 1`` for i < n,
scaled by ``1.7 / sqrt(fan_in)`` (2-D and up) or ``1.7 * 0.02`` (1-D), with
``fan_in = prod(shape[:-1])`` and ``salt = index % 97``, both taken as the
JAX package takes them: over its leaf order (dict keys sorted, lists in
order, None leaves skipped) and its layouts ((Cin, Cout) linears, (W, Cin,
Cout) convs). So ``synthetic_init`` shapes the port's init on the meta
device, fills the JAX-layout shapes and maps the leaves into the port's
layouts (``weights.from_jax_layout``). Non-float leaves are zeros.

The pieces are evaluated as XLA's CPU code evaluates them, so that on the
CPU the two packages' leaves agree element for element almost everywhere:
XLA folds a leaf of at most 64 elements at compile time (a product and a
sum, then the correctly rounded sine, evaluated in float64 here), and
computes a larger one with the argument as one fused multiply-add and the
sine as libm's ``sinf`` (called through the native library). A one-ulp
difference in the sine moves an element anywhere in [-1, 1] (the
``* 43758.5453``); without the library, and on the card, the sine of a
large leaf is the correctly rounded one too, which meets libm's on ~99% of
elements. The values are benchmark weights, never a model's.
"""

import math

import torch

from .. import weights
from ..native import sinf


_FOLDED_UPTO = 64  # elements of the largest leaf XLA evaluates at compile time
_F32_STRIDE = float(torch.tensor(12.9898).float())


def _synth_leaf(shape, dtype, salt: float, std: float, device) -> torch.Tensor:
    n = math.prod(shape)
    # integer iota converted to fp32, as XLA's iota rounds past 2^24
    i = torch.arange(max(n, 1), dtype=torch.int32, device=device).to(torch.float32)
    s = None
    if n <= _FOLDED_UPTO:
        a = i * 12.9898 + salt * 78.233
    else:  # one rounding of i * c + salt * c', as a fused multiply-add
        a = (i.double() * _F32_STRIDE + float(torch.tensor(salt * 78.233).float())).float()
        s = sinf(a.numpy()) if a.device.type == "cpu" else None
    s = torch.sin(a.double()).float() if s is None else torch.from_numpy(s)
    x = s * 43758.5453
    x = (x - torch.floor(x)) * 2.0 - 1.0
    return (x[:n].reshape(shape) * (std * 1.7)).to(dtype)


def _leaves(tree, path=()):
    """(path, leaf) in the JAX package's pytree order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _copy_structure(tree):
    if isinstance(tree, dict):
        return {k: _copy_structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy_structure(v) for v in tree]
    return tree


def _fill(idx: int, leaf, dtype, device) -> torch.Tensor:
    shape = tuple(leaf.shape)
    if not leaf.dtype.is_floating_point:
        return torch.zeros(shape, dtype=leaf.dtype, device=device)
    std = 1.0 / math.sqrt(max(math.prod(shape[:-1]), 1)) if len(shape) >= 2 else 0.02
    return _synth_leaf(shape, dtype or leaf.dtype, float(idx % 97), std, device)


def synthetic_like(tree, dtype=None, *, device="cpu"):
    """A tree of tensors (meta tensors will do) in the JAX package's layouts
    -> the same structure filled synthetically on ``device``, each float
    leaf in ``dtype`` (None: its own), computed in fp32."""
    out = _copy_structure(tree)
    for idx, (path, leaf) in enumerate(_leaves(tree)):
        _set(out, path, _fill(idx, leaf, dtype, device))
    return out


def synthetic_leaf(tree, path, dtype=None, *, device="cpu") -> torch.Tensor:
    """The one leaf at ``path`` (a tuple of keys and indices) of
    ``synthetic_like(tree, dtype, device=device)``, without the others."""
    for idx, (p, leaf) in enumerate(_leaves(tree)):
        if p == tuple(path):
            return _fill(idx, leaf, dtype, device)
    raise KeyError(path)


def synthetic_init(init_fn, dtype=None, *, device="cpu"):
    """``init_fn(device)`` builds a parameter tree in the port's layouts;
    it runs on the meta device for the shapes, and the tree comes back
    filled by ``synthetic_like`` on ``device``, in the port's layouts."""
    shapes = weights.jax_layout_meta(init_fn(torch.device("meta")))
    return weights.from_jax_layout(synthetic_like(shapes, dtype, device=device))
