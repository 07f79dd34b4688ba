"""Device selection for the port's entry points, and full-fp32 arithmetic."""

import contextlib

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another. Raises when no device was named and no GPU is present -- the
    port never drops to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the port "
            "on the CPU explicitly"
        )
    return torch.device("cuda")


@contextlib.contextmanager
def full_fp32():
    """fp32 matmuls and convolutions in full fp32 inside the block: PyTorch
    runs cuDNN's fp32 convolutions in TF32 by default (~10 mantissa bits),
    which would move the conditioning frontends' mels and the S3 tokenizer's
    FSQ roundings. The settings in force before the block come back after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
