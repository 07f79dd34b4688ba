"""Native checkpoints: parameter trees as safetensors whose keys are the
slash-joined tree paths, ``#i`` a list index and ``@none`` a None leaf.

The port's own copy of the rules of ``chatterbox_tpu/checkpoint/
pytree_io.py`` (``_flatten``/``_unflatten``), so that the files the port
writes are the JAX package's native format and ``weights.load_native``
reads either package's. Leaves are numpy arrays or torch tensors in the
JAX package's layouts; bfloat16 tensors are written as their 16-bit
patterns tagged BF16, which the JAX package's reader reads to the same
values.
"""

import numpy as np
import torch

from .safetensors_io import save_safetensors


def flatten(tree, prefix=""):
    """A tree of dicts, lists and leaves -> {slash-joined path: leaf}, dict
    keys in sorted order (the order JAX pytrees hold them in, so a tree of
    either package writes the JAX package's file); a None leaf becomes
    ``<path>/@none`` with an empty float32 array."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(flatten(v, f"{prefix}#{i}/"))
    elif tree is None:
        out[prefix.rstrip("/") + "/@none"] = np.zeros((0,), np.float32)
    else:
        out[prefix.rstrip("/")] = tree
    return out


def unflatten(flat):
    """Inverse of ``flatten``."""
    root = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def convert(node):
        if not isinstance(node, dict):
            return node
        if "@none" in node:
            return None
        keys = list(node.keys())
        if keys and all(k.startswith("#") for k in keys):
            return [convert(node[k]) for k in sorted(keys, key=lambda k: int(k[1:]))]
        return {k: convert(v) for k, v in node.items()}

    return convert(root)


def save_params(tree, path, metadata=None):
    """Write a parameter tree (JAX-package layouts) as a native safetensors
    file; torch tensors are read back to the host, bf16 ones bit for bit."""
    arrays, bf16 = {}, set()
    for name, leaf in flatten(tree).items():
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                bf16.add(name)
                leaf = leaf.contiguous().view(torch.int16).numpy().view(np.uint16)
            else:
                leaf = leaf.numpy()
        arrays[name] = np.asarray(leaf)
    save_safetensors(arrays, path, metadata=metadata, bf16=bf16)
