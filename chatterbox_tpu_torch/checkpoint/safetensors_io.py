"""Self-contained safetensors reader/writer (numpy only, no Rust package).

The port's own copy of the JAX package's reader: an 8-byte LE header length,
a JSON header mapping names to {dtype, shape, data_offsets}, then raw
little-endian tensor bytes, memory-mapped when read. BF16 payloads are
returned as uint16 arrays flagged in the second return value, and written
from uint16 arrays named in ``bf16``; ``weights.py`` views them as
``torch.bfloat16`` without a float round trip.
"""

import json
import os
import struct

import numpy as np

_DTYPES = {
    "F64": np.float64,
    "F32": np.float32,
    "F16": np.float16,
    "BF16": np.uint16,  # raw bits; the caller views them as bfloat16
    "I64": np.int64,
    "I32": np.int32,
    "I16": np.int16,
    "I8": np.int8,
    "U8": np.uint8,
    "BOOL": np.bool_,
}

_TO_ST_DTYPE = {
    np.dtype(np.float64): "F64",
    np.dtype(np.float32): "F32",
    np.dtype(np.float16): "F16",
    np.dtype(np.int64): "I64",
    np.dtype(np.int32): "I32",
    np.dtype(np.int16): "I16",
    np.dtype(np.int8): "I8",
    np.dtype(np.uint8): "U8",
    np.dtype(np.bool_): "BOOL",
}


def load_safetensors(path):
    """Read a .safetensors file -> (dict[name, np.ndarray], set of BF16 names).

    The arrays are read-only views of the memory-mapped file (a checkpoint
    of gigabytes is paged in as its tensors are read). BF16 tensors come
    back as their uint16 bit patterns."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len).decode("utf-8"))
    start = 8 + header_len
    # np.memmap cannot map an empty region (a file of empty tensors only)
    data = (np.memmap(path, dtype=np.uint8, mode="r", offset=start)
            if os.path.getsize(path) > start else b"")
    out, bf16 = {}, set()
    for name, meta in header.items():
        if name == "__metadata__":
            continue
        lo, hi = meta["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=_DTYPES[meta["dtype"]])
        out[name] = arr.reshape(meta["shape"])
        if meta["dtype"] == "BF16":
            bf16.add(name)
    return out, bf16


def save_safetensors(tensors, path, metadata=None, *, bf16=()):
    """Write dict[name, np.ndarray] to a .safetensors file; the uint16
    arrays named in ``bf16`` are bfloat16 bit patterns, tagged BF16. Each
    tensor is written from its own buffer, not gathered into one."""
    header = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    arrays = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr)
        if name in bf16:
            if arr.dtype != np.uint16:
                raise ValueError(f"{name}: a BF16 tensor is written from its uint16 bits, "
                                 f"not {arr.dtype}")
            dtype = "BF16"
        else:
            if arr.dtype not in _TO_ST_DTYPE:
                arr = arr.astype(np.float32)
            dtype = _TO_ST_DTYPE[arr.dtype]
        header[name] = {"dtype": dtype, "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        arrays.append(arr)
    hjson = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hjson)))
        f.write(hjson)
        for arr in arrays:
            f.write(arr.data)
