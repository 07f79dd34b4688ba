"""Benchmark weights made from the seed on the device, in a few large draws.

The leaves of the trees (their names and shapes are the program's layouts,
from its own ``init_*`` run on the meta device) are grouped by the dtype
they are served in; each group is one ``torch.randn`` on a generator of the
device seeded with the run's seed, carved into the leaves in sorted-path
order, and each leaf gets the affine map of its role:

- a linear, conv or embedding weight: N(0, 1 / fan_in);
- a norm scale, a snake alpha, a batch-norm variance: positive around 1;
- a bias, a batch-norm mean, a positional bias: small around 0.

The values are benchmark weights, not a model's: they give every layer
the magnitudes a trained net would roughly have, so that no stage blows up
or vanishes, and so that the reference and the program see the same
numbers.
"""

import math

import torch


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_copy(v) for v in tree]
    return tree


def _set(tree, path, value):
    for p in path[:-1]:
        tree = tree[p]
    tree[path[-1]] = value


def _fan_in(path, shape) -> int:
    """Inputs a weight's output sums over, in the program's layouts:
    (Cout, Cin[, ...]) linears and convs, (L, Cout, Cin) stacked Llama
    layers, (Cin, Cout, W) transposed convs and (Cin, 4H) LSTM matrices."""
    n = math.prod(shape)
    if "layers" in path and "llama" in path:
        return shape[-1]
    if path[-1] in ("w_ih", "w_hh") or "ups" in path:
        return n // shape[1]
    return n // shape[0]


def _role(path, shape):
    """(kind, std) of a leaf: kind "positive" is exp(std * n), else the
    leaf is std * n."""
    name = path[-1]
    if name in ("scale", "alpha", "var"):
        return "positive", 0.1
    if name in ("b", "bias", "mean") or len(shape) < 2:
        return "normal", 0.02
    if name == "query":
        return "normal", 0.3
    return "normal", 1.0 / math.sqrt(max(_fan_in(path, shape), 1))


def make_weights(meta_trees: dict, dtypes: dict, seed: int, device) -> dict:
    """``meta_trees`` {name: tree of meta tensors}, ``dtypes`` {name: the
    dtype that tree is served in} -> {name: tree of tensors on ``device``}.
    One draw a dtype, on ``torch.Generator(device).manual_seed(seed)``."""
    out = {name: _copy(t) for name, t in meta_trees.items()}
    groups = {}
    for name in sorted(meta_trees):
        for path, leaf in _leaves(meta_trees[name]):
            dt = dtypes[name] if leaf.dtype.is_floating_point else leaf.dtype
            groups.setdefault(dt, []).append((name, path, tuple(leaf.shape)))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    for dt in sorted(groups, key=str):
        items = groups[dt]
        if not dt.is_floating_point:
            for name, path, shape in items:
                _set(out[name], path, torch.zeros(shape, dtype=dt, device=device))
            continue
        total = sum(math.prod(s) for _, _, s in items)
        flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
        off = 0
        for name, path, shape in items:
            n = math.prod(shape)
            x = flat[off:off + n].view(shape)
            off += n
            kind, std = _role((name,) + path, shape)
            x = torch.exp(x * std) if kind == "positive" else x * std
            _set(out[name], path, x.to(dt))
        del flat
    return out
