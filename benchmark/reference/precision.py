"""The controls' lower precisions: a weight tree rounded to int8 or fp8
(e4m3) with one symmetric scale per output channel and served in bf16, or
cast to bf16 outright, and TF32 switched on or off around a block."""

import contextlib

import torch


def _fake_quant(w, fmt: str, stacked: bool):
    x = w.float()
    dims = (-1,) if stacked else tuple(range(1, x.ndim))
    amax = x.abs().amax(dim=dims, keepdim=True).clamp_min(1e-12)
    if fmt == "int8":
        scale = amax / 127.0
        return torch.round(x / scale).clamp(-127, 127) * scale
    scale = amax / 448.0  # the largest e4m3 value
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def lowered(tree, fmt: str, dtype=torch.bfloat16, scope=None, path=()):
    """A copy of ``tree`` with each weight (a ``w`` of two or more axes,
    under a key ``scope`` when given) rounded to ``fmt`` ("int8", "fp8" or
    None for none) per output channel and every floating leaf cast to
    ``dtype``. Stacked Llama layers (L, Cout, Cin) take a scale per (layer,
    output channel)."""
    if isinstance(tree, dict):
        return {k: lowered(v, fmt, dtype, scope, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [lowered(v, fmt, dtype, scope, path + (i,)) for i, v in enumerate(tree)]
    if not (isinstance(tree, torch.Tensor) and tree.is_floating_point()):
        return tree
    if (fmt is not None and path and path[-1] == "w" and tree.ndim >= 2
            and (scope is None or scope in path)):
        stacked = "llama" in path and "layers" in path
        return _fake_quant(tree, fmt, stacked).to(dtype)
    return tree.to(dtype)


@contextlib.contextmanager
def tf32(on: bool):
    """TF32 for fp32 matrix products and convolutions inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
