"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles on its own, with ``nvcc`` for ``sm_90a``, into a shared
library with a plain C interface under ``chatterbox_tpu_torch/build/``; the
library is loaded with ``ctypes``. A library is rebuilt when its source or a
shared header is newer. A failed build raises: there is no fallback.
Nothing here runs at import time.
"""

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("flash_decode", "flash_attention_sm90", "probes", "ssm_decode", "decode_glue")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

_lock = threading.Lock()
_libs = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(p.stat().st_mtime for p in deps) > lib.stat().st_mtime


def build(names=SOURCES, force: bool = False) -> float:
    """Compile the named sources in parallel (one nvcc each, all started
    together). Returns the wall seconds spent; raises on any failure.
    The compiler's output (with -Xptxas -v register/smem counts) is kept
    in build/<name>.log."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.time()
    procs = {}
    for n in todo:
        tmp = BUILD / f"lib{n}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        (BUILD / f"{n}.log").write_text(out)
        if proc.returncode != 0:
            failed.append(f"--- {n} (exit {proc.returncode}) ---\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(n))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return time.time() - t0


def load(name: str, signatures) -> ctypes.CDLL:
    """The loaded library for source ``name``, built first if needed, with
    ``signatures`` ({function: argtypes}; every function returns an int
    CUDA status) set once."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]


def require(cond, msg: str):
    """Raise ValueError(msg) unless ``cond``: a wrapper's check of what its
    kernel takes."""
    if not cond:
        raise ValueError(msg)


def refuse_autograd(what: str, *tensors):
    """Raise RuntimeError when grad mode is on and an operand requires grad.
    A kernel writes its output through raw pointers, so autograd would get
    a tensor with no ``grad_fn`` and the gradient would stop there without
    a word; the JAX package's Pallas calls refuse ``jax.grad`` the same way.
    No kernel has a backward: differentiate the plain path (the UNet's
    ``use_flash=False``) instead. Under ``inference_mode`` or ``no_grad``
    this is one flag read."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: the kernel has no backward, and an operand requires grad; "
                           "call it under torch.no_grad() or take the plain path")


def check(status: int, what: str):
    """Raise if a launch returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")


def stream_ptr(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
